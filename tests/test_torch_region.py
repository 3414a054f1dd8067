"""The port's per-read chain-and-extend path against the JAX package.

* ``Aligner.chain_batch`` + ``extend_batch_rounds`` on ``device="cpu"``
  (native chaining, one ``extend_read`` generator a read, lockstep rounds
  of ``extend_seed_batch``), under both extension layouts, against the JAX
  Aligner's same two calls (``_regs_old`` of ``tests/test_extend_flat.py``),
  every region field for field;
* the port's flat engine (``regions_batch``) against its per-read path on
  the same batches;
* ``extend_seed_batch`` against the JAX one on jobs that retry at double
  band on both sides.

The fixtures are ``tests/test_extend_flat.py``'s (a random genome, a
repeat-heavy one, two contigs with a read shorter than a seed), cut to
64, 64 and 61 reads.  Comparisons run on ``batch.n`` reads: the JAX round
loop also walks the batch's padding rows.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions as JaxOptions
from tpubwa.index.fmindex import FMIndex as JaxIndex
from tpubwa.io.fasta import Contig as JaxContig
from tpubwa_torch.config import MemOptions
from tpubwa_torch.index.fmindex import FMIndex
from tpubwa_torch.io.fasta import Contig
from tpubwa_torch.io.fastq import Read, batch_reads
from tpubwa_torch.utils.dna import decode
from tpubwa_torch.utils.sim import simulate_reads

torch.set_num_threads(1)


def _random():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 60_000).astype(np.uint8)
    contigs = [("c1", codes.size, 0)]
    return codes, contigs, simulate_reads(
        codes, [Contig(*c) for c in contigs], 64, length=150, err=0.02,
        indel=0.002, seed=11)


def _repetitive():
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 3000).astype(np.uint8)
    parts = [rng.integers(0, 4, 5000).astype(np.uint8)]
    for _ in range(12):             # 12 copies at 1 % divergence
        c = unit.copy()
        mut = rng.random(c.size) < 0.01
        c[mut] = (c[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        parts.append(c)
    parts.append(rng.integers(0, 4, 5000).astype(np.uint8))
    codes = np.concatenate(parts)
    contigs = [("rep", codes.size, 0)]
    return codes, contigs, simulate_reads(
        codes, [Contig(*c) for c in contigs], 64, length=150, err=0.01,
        indel=0.001, seed=12)


def _multicontig_short():
    rng = np.random.default_rng(9)
    l1, l2 = 40_000, 25_000
    codes = rng.integers(0, 4, l1 + l2).astype(np.uint8)
    contigs = [("a", l1, 0), ("b", l2, l1)]
    reads = []
    for i in range(60):
        p = int(rng.integers(0, l1 + l2 - 120))
        reads.append((f"r{i}", decode(codes[p:p + 120]), "I" * 120))
    reads.append(("tiny", "ACGTACGT", "IIIIIIII"))  # < min_seed_len
    return codes, contigs, reads


FIXTURES = {"random": _random, "repetitive": _repetitive,
            "multicontig_short": _multicontig_short}
_cache: dict = {}


def _fixture(name):
    """(JAX Aligner, port index, batch, JAX regions), made once a name."""
    if name not in _cache:
        from tpubwa.align.pipeline import Aligner as JaxAligner
        from tpubwa.io.fastq import Read as JaxRead
        from tpubwa.io.fastq import batch_reads as jax_batch_reads

        codes, contigs, reads = FIXTURES[name]()
        B = 128
        jal = JaxAligner(JaxIndex.build([JaxContig(*c) for c in contigs],
                                        codes),
                         JaxOptions(batch_reads=B, max_read_len=160))
        jb = next(jax_batch_reads([JaxRead(*r) for r in reads], B, 160))
        rows, l_rep = jal.seed_batch(jb.codes, jb.lens)
        chains = jal.chain_batch(rows, l_rep, jb.lens)
        want = jal.extend_batch_rounds(jb.codes, jb.lens, chains)[:jb.n]
        idx = FMIndex.build([Contig(*c) for c in contigs], codes)
        batch = next(batch_reads([Read(*r) for r in reads], B, 160))
        _cache[name] = (idx, batch, want)
    return _cache[name]


def _per_read(name, layout="t"):
    """(Aligner, its per-read regions), made once a fixture and layout."""
    from tpubwa_torch.align.pipeline import Aligner

    if (name, layout) not in _cache:
        idx, batch, _ = _fixture(name)
        al = Aligner(idx, MemOptions(batch_reads=128, max_read_len=160),
                     device="cpu", ext_layout=layout)
        rows, l_rep = al.seed_batch(batch.codes, batch.lens)
        chains = al.chain_batch(rows, l_rep, batch.lens)
        _cache[name, layout] = (al, al.extend_batch_rounds(
            batch.codes, batch.lens, chains)[:batch.n])
    return _cache[name, layout]


def _fields(regs):
    return [[dataclasses.astuple(r) for r in rl] for rl in regs]


@pytest.mark.parametrize("layout", ["t", "b"])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_per_read_path_matches_jax(name, layout):
    from tpubwa.align.region import AlnReg as JaxAlnReg
    from tpubwa_torch.align.region import AlnReg

    _, batch, want = _fixture(name)
    _, got = _per_read(name, layout)
    assert sum(map(len, want)) >= batch.n - 1
    assert [f.name for f in dataclasses.fields(AlnReg)] == \
        [f.name for f in dataclasses.fields(JaxAlnReg)]
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_flat_engine_matches_per_read_path(name):
    """The production route (native ext_prepare, waves, replay) gives the
    per-read path's regions, field for field."""
    _, batch, _ = _fixture(name)
    al, per_read = _per_read(name)
    assert _fields(al.regions_batch(batch)) == _fields(per_read)


def _retry_jobs(seed, B=48, Q=40, T=96):
    """Whole-seed jobs whose queries carry a 5-base indel near their start,
    at a band of 6: the best cell leaves the diagonal by more than 3/4 of
    the band, so both sides retry at band 12."""
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("l", "r"):
        t = rng.integers(0, 4, (B, T)).astype(np.int32)
        q = np.full((B, Q), 4, np.int32)
        for b in range(B):
            p = int(rng.integers(2, 8))
            qq = (np.concatenate([t[b, :p], t[b, p + 5:p + 5 + Q]])
                  if b % 2 else
                  np.concatenate([t[b, :p], rng.integers(0, 4, 5), t[b, p:]]))
            q[b] = qq[:Q]
        out[f"q_{side}"] = q
        out[f"t_{side}"] = t
        out[f"qlen_{side}"] = rng.integers(Q - 8, Q + 1, B).astype(np.int32)
        out[f"tlen_{side}"] = rng.integers(T - 20, T + 1, B).astype(np.int32)
    out["qlen_l"][:4] = 0               # seeds at the read's start
    out["qlen_r"][4:8] = 0              # ... and at its end
    out["w0"] = np.full(B, 6, np.int32)
    out["h0"] = rng.integers(19, 40, B).astype(np.int32)
    out["pen5"] = np.full(B, 5, np.int32)
    out["pen3"] = np.full(B, 5, np.int32)
    return out


def test_extend_seed_batch_matches_jax_with_retries():
    import jax.numpy as jnp

    from tpubwa.ops.extend import extend_seed_batch as jax_esb
    from tpubwa_torch.ops.extend import extend_seed_batch

    opt = MemOptions()
    jobs = _retry_jobs(3)
    order = ("q_l", "qlen_l", "t_l", "tlen_l", "q_r", "qlen_r", "t_r",
             "tlen_r")
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins, zdrop=opt.zdrop, mat_max=opt.a)
    mat = opt.score_matrix()
    rest = ("w0", "h0", "pen5", "pen3")
    want = jax_esb(*(jnp.asarray(jobs[k]) for k in order), jnp.asarray(mat),
                   *(jnp.asarray(jobs[k]) for k in rest), **kw)
    got = extend_seed_batch(*(torch.as_tensor(jobs[k]) for k in order),
                            torch.as_tensor(mat),
                            *(torch.as_tensor(jobs[k]) for k in rest), **kw)
    for side in ("left", "right"):
        for g, w in zip(getattr(got, side), getattr(want, side)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for f in ("score0", "aw0", "aw1"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    # both sides retried on lanes with a job there, and only there
    for aw, ql in ((got.aw0, jobs["qlen_l"]), (got.aw1, jobs["qlen_r"])):
        retried = aw.numpy() == 12
        assert retried.sum() >= 20
        assert not retried[ql == 0].any()


def test_per_read_path_on_a_mesh_matches_one_device(monkeypatch):
    """On a mesh of four CPU shards each round's lanes are split into
    four contiguous parts, one a shard; the regions are one device's."""
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.ops import extend

    idx, batch, _ = _fixture("multicontig_short")
    _, want = _per_read("multicontig_short")
    al = Aligner(idx, MemOptions(batch_reads=128, max_read_len=160),
                 device=["cpu"] * 4)
    parts = []
    real = extend.extend_seed_batch

    def counting(*args, **kw):
        parts.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr("tpubwa_torch.align.pipeline.extend_seed_batch",
                        counting)
    rows, l_rep = al.seed_batch(batch.codes, batch.lens)
    got = al.extend_batch_rounds(batch.codes, batch.lens,
                                 al.chain_batch(rows, l_rep, batch.lens))
    assert _fields(got[:batch.n]) == _fields(want)
    # the first round: a lane a read with a chain (60 of 61), four parts
    assert parts[:4] == [15, 15, 15, 15]
