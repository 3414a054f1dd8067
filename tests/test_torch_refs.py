"""The port's scalar oracles and its NumPy suffix array against the JAX
package.

* ``ops.extend_ref.extend_ref`` against ``tpubwa.ops.extend_ref`` (and the
  plain batched ``_extend_core``, lane by lane);
* ``ops.fm_ref.collect_smems`` against ``tpubwa.ops.fm_ref`` (and the
  batched collector ``collect_smems_chain``, read by read);
* ``index.sais.suffix_array(use_native=False)`` (NumPy prefix doubling)
  against the native SA-IS and against the JAX package's doubling;
* no fallback: with the compiler made to fail, ``use_native`` None or
  True, ``FMIndex.build`` and ``Aligner.chain_batch`` raise.
"""
import numpy as np
import pytest
import torch

from tpubwa_torch.config import MemOptions
from tpubwa_torch.index.fmindex import FMIndex
from tpubwa_torch.io.fasta import Contig

torch.set_num_threads(1)

OPT = MemOptions()


def _jobs(seed, J=40, Q=36, T=60):
    """Extension jobs with real alignments (mutated target prefixes, some
    with indels or a noisy tail), N codes, empty sides and every band."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(J):
        t = rng.integers(0, 4, T).astype(np.uint8)
        q = t[:Q].copy()
        q[rng.random(Q) < rng.choice([0.02, 0.1, 0.4])] += 1
        q %= 4
        if j % 4 == 1:
            p = int(rng.integers(2, Q - 4))
            q = np.concatenate([q[:p], q[p + 3:], q[:3]])
        if j % 5 == 2:
            q[Q // 2:] = rng.integers(0, 4, Q - Q // 2)
        q[rng.random(Q) < 0.03] = 4
        t[rng.random(T) < 0.03] = 4
        out.append((q[:int(rng.integers(0, Q + 1))],
                    t[:int(rng.integers(0, T + 1))],
                    int(rng.choice([1, 4, 10, 100])),
                    int(rng.integers(1, 60)), int(rng.choice([0, 5, 100]))))
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_extend_ref_matches_jax_and_plain_core(seed):
    from tpubwa.ops.extend_ref import extend_ref as jax_ref
    from tpubwa_torch.ops.extend import _extend_core
    from tpubwa_torch.ops.extend_ref import ExtendResult, extend_ref

    mat = OPT.score_matrix()
    kw = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
              e_ins=OPT.e_ins)
    jobs = _jobs(seed)
    got = [extend_ref(q, t, mat, w=w, end_bonus=OPT.pen_clip5, zdrop=z,
                      h0=h0, **kw) for q, t, w, h0, z in jobs]
    want = [jax_ref(q, t, mat, w=w, end_bonus=OPT.pen_clip5, zdrop=z,
                    h0=h0, **kw) for q, t, w, h0, z in jobs]
    assert [tuple(vars(r).values()) for r in got] == \
        [tuple(vars(r).values()) for r in want]
    assert all(isinstance(r, ExtendResult) for r in got)
    # the plain batched core on the same jobs, one zdrop a call
    for z in (0, 5, 100):
        sel = [i for i, jb in enumerate(jobs) if jb[4] == z]
        Q, T = 36, 60
        q = np.full((len(sel), Q), 4, np.int32)
        t = np.full((len(sel), T), 4, np.int32)
        for r, i in enumerate(sel):
            q[r, :len(jobs[i][0])] = jobs[i][0]
            t[r, :len(jobs[i][1])] = jobs[i][1]

        def col(f):
            return torch.tensor([f(jobs[i]) for i in sel], dtype=torch.int32)

        res = _extend_core(torch.as_tensor(q), col(lambda j: len(j[0])),
                           torch.as_tensor(t), col(lambda j: len(j[1])),
                           mat, col(lambda j: j[2]), col(lambda j: j[3]),
                           col(lambda j: OPT.pen_clip5), zdrop=z,
                           mat_max=OPT.a, **kw)
        batched = torch.stack(list(res)).T.tolist()
        for r, i in enumerate(sel):
            if len(jobs[i][0]) and len(jobs[i][1]):   # both sides real
                assert batched[r] == list(vars(got[i]).values()), i


def _reads(idx_codes, n, seed):
    from tpubwa_torch.utils.dna import encode
    from tpubwa_torch.utils.sim import simulate_reads

    reads = simulate_reads(idx_codes, [Contig("c1", idx_codes.size, 0)], n,
                           length=100, err=0.02, seed=seed)
    q = np.full((n, 112), 4, np.int32)
    lens = np.zeros(n, np.int32)
    for i, (_, seq, _) in enumerate(reads):
        c = encode(seq)
        q[i, :len(c)] = c
        lens[i] = len(c)
    q[3, 40:43] = 4          # N runs in a read
    return q, lens


def test_collect_smems_matches_jax_and_chain_collector():
    from tpubwa.index.fmindex import FMIndex as JaxIndex
    from tpubwa.io.fasta import Contig as JaxContig
    from tpubwa.ops import fm_ref as jax_fm_ref
    from tpubwa_torch.ops import fm_ref
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.ops.smem_chain import collect_smems_chain
    from tpubwa_torch.utils.gensim import repeat_genome

    codes = repeat_genome(np.random.default_rng(8), 30_000)
    idx = FMIndex.build([Contig("c1", codes.size, 0)], codes)
    jidx = JaxIndex.build([JaxContig("c1", codes.size, 0)], codes)
    q, lens = _reads(codes, 24, seed=4)
    sm = collect_smems_chain(DeviceIndex.from_host(idx, "cpu"),
                             torch.as_tensor(q), torch.as_tensor(lens))
    n_mems = 0
    for b in range(len(q)):
        got = [(m.k, m.l, m.s, m.start, m.end)
               for m in fm_ref.collect_smems(idx, q[b], int(lens[b]))]
        want = [(m.k, m.l, m.s, m.start, m.end)
                for m in jax_fm_ref.collect_smems(jidx, q[b], int(lens[b]))]
        assert got == want, b
        nb = int(sm.n[b])
        chain = list(zip(*(f[b, :nb].tolist() for f in sm[:5])))
        assert chain == got, b
        n_mems += len(got)
    assert n_mems > 3 * len(q)


@pytest.mark.parametrize("kind", ["random", "repeat", "runs"])
def test_suffix_array_doubling_matches_native_and_jax(kind):
    from tpubwa.index.sais import _suffix_array_doubling as jax_doubling
    from tpubwa_torch.index.sais import suffix_array
    from tpubwa_torch.utils.gensim import repeat_genome

    rng = np.random.default_rng(3)
    codes = {"random": lambda: rng.integers(0, 4, 20_000),
             "repeat": lambda: repeat_genome(rng, 20_000),
             "runs": lambda: np.repeat(rng.integers(0, 4, 400),
                                       rng.integers(1, 60, 400))}[kind]()
    codes = codes.astype(np.uint8)
    got = suffix_array(codes, use_native=False)
    assert got.dtype == np.int64 and got[0] == codes.size
    np.testing.assert_array_equal(got, suffix_array(codes))
    np.testing.assert_array_equal(got, suffix_array(codes, use_native=True))
    np.testing.assert_array_equal(got, jax_doubling(codes))


def test_index_built_by_doubling_equals_native():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 8000).astype(np.uint8)
    contigs = [Contig("c1", 8000, 0)]
    a = FMIndex.build(contigs, codes, use_native=False)
    b = FMIndex.build(contigs, codes)
    for f in ("cp", "sa_ls", "sa_ms", "L2", "pac_words"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.primary == b.primary


@pytest.fixture
def broken_compiler(monkeypatch, tmp_path):
    """The native library unbuilt and its compiler missing."""
    from tpubwa_torch.native import build

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "GXX", str(tmp_path / "no-such-g++"))


@pytest.mark.parametrize("use_native", [None, True])
def test_native_build_failure_raises(broken_compiler, use_native):
    """No fallback to the NumPy construction: the suffix array and the
    index build raise where the native library cannot be built."""
    from tpubwa_torch.index.sais import suffix_array

    codes = np.random.default_rng(0).integers(0, 4, 500).astype(np.uint8)
    with pytest.raises(RuntimeError, match="no-such-g"):
        suffix_array(codes, use_native=use_native)
    with pytest.raises(RuntimeError, match="no-such-g"):
        FMIndex.build([Contig("c1", 500, 0)], codes, use_native=use_native)
    # False builds the suffix array without the native library
    assert suffix_array(codes, use_native=False)[0] == 500


def test_chain_batch_raises_without_native_library(monkeypatch, tmp_path):
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.native import build

    codes = np.random.default_rng(0).integers(0, 4, 2000).astype(np.uint8)
    al = Aligner(FMIndex.build([Contig("c1", 2000, 0)], codes),
                 device="cpu")
    rows = np.array([[0, 100, 0, 30]], np.int64)
    assert len(al.chain_batch(rows, np.zeros(1, np.int32),
                              np.array([150]))[0]) == 1
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "GXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        al.chain_batch(rows, np.zeros(1, np.int32), np.array([150]))
