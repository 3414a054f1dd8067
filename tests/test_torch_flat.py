"""The port's flat extension path and global alignment against the JAX
package.

* ``Aligner._regions_flat`` (device seeding, native ext_prepare, the
  port's ``run_phased`` waves, native ``finalize_fields``) against the JAX
  Aligner's ``_regions_flat`` fields on the same batch.
* ``run_waves`` on a job list long enough for the separate left/right
  streams, against the JAX ``run_waves``.
* ``global_align_cigar_batch`` and the flat SAM device halves
  (``_flat_windows``, ``_ga_rows``) against the JAX versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig

torch.set_num_threads(1)

OPT = MemOptions()


def _genome(kind, n=40_000):
    rng = np.random.default_rng(5)
    if kind == "random":
        return rng.integers(0, 4, n).astype(np.uint8)
    # segmental copies at ~3% divergence: multi-region reads, XA lanes
    base = rng.integers(0, 4, n // 4).astype(np.uint8)
    segs = []
    for _ in range(4):
        s = base.copy()
        m = rng.random(s.size) < 0.03
        s[m] = (s[m] + rng.integers(1, 4, int(m.sum()))) % 4
        segs.append(s)
    return np.concatenate(segs)


def _aligners(kind, B):
    from tpubwa.align.pipeline import Aligner as JaxAligner
    from tpubwa.io.fastq import Read, batch_reads
    from tpubwa.utils import sim
    from tpubwa_torch.align.pipeline import Aligner

    codes = _genome(kind)
    contigs = [Contig("c1", 25_000, 0), Contig("c2", codes.size - 25_000,
                                                25_000)]
    idx = FMIndex.build(contigs, codes)
    reads = sim.simulate_reads(codes, contigs, B, length=150, err=0.02,
                               indel=0.003, seed=9)
    batch = next(batch_reads([Read(*r) for r in reads], B, 160))
    opt = MemOptions(batch_reads=B)
    return JaxAligner(idx, opt), Aligner(idx, opt, device="cpu"), batch


@pytest.mark.parametrize("kind", ["random", "repeat"])
def test_regions_flat_matches_jax(kind):
    jal, tal, batch = _aligners(kind, 64)
    (want, wb), _ = jal._regions_flat(batch)
    got, gb = tal._regions_flat(batch)
    np.testing.assert_array_equal(gb, wb)
    n = int(wb[-1])
    assert n >= batch.n // 2
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k][:n], want[k][:n], err_msg=k)


def _jobs(idx, B, J, seed):
    rng = np.random.default_rng(seed)
    l_pac = idx.l_pac
    rev = rng.random(J) < 0.5
    lo = np.where(rev, l_pac, 0)
    hi = np.where(rev, 2 * l_pac, l_pac)
    slen = rng.integers(19, 40, J).astype(np.int32)
    rbeg = np.minimum(lo + rng.integers(0, l_pac - 60, J), hi - slen)
    return {
        "read": rng.integers(0, B, J).astype(np.int32),
        "qbeg": rng.integers(0, 100, J).astype(np.int32),
        "slen": slen,
        "rbeg": rbeg.astype(np.int64),
        "rmax0": np.maximum(lo, rbeg - rng.integers(0, 900, J)),
        "rmax1": np.minimum(hi, rbeg + slen + rng.integers(0, 900, J)),
        "h0": (slen * OPT.a).astype(np.int32),
    }


def test_run_waves_split_streams_match_jax():
    from tpubwa.align.flatext import run_waves as jax_run_waves
    from tpubwa_torch.align.flatext import MIN_WAVE, run_waves

    jal, tal, batch = _aligners("random", 32)
    J = 2 * MIN_WAVE + 77                      # separate left/right streams
    jobs = _jobs(tal.idx, batch.n, J, 3)
    lens = batch.lens
    want = jax_run_waves(jal, jnp.asarray(batch.codes.astype(np.int32)),
                         jnp.asarray(lens), jobs, J, lens_host=lens)
    got = run_waves(tal, tal._put(batch.codes.astype(np.int32)),
                    tal._put(lens), jobs, J, lens_host=lens)
    np.testing.assert_array_equal(got, want)


def test_global_align_cigar_batch_matches_jax():
    from tpubwa.ops.global_align import (
        global_align_cigar_batch as jax_ga)
    from tpubwa_torch.ops.global_align import (global_align,
                                               global_align_cigar_batch,
                                               steps_to_cigar)

    rng = np.random.default_rng(4)
    Bn, Q, T = 40, 64, 96
    t = rng.integers(0, 5, (Bn, T)).astype(np.int32)
    q = t[:, :Q].copy()
    m = rng.random((Bn, Q)) < 0.08
    q[m] = rng.integers(0, 4, int(m.sum()))
    for b in range(0, Bn, 3):                  # gaps
        p = int(rng.integers(2, Q - 6))
        q[b] = np.concatenate([q[b, :p], q[b, p + 3:], q[b, :3]])
    qlen = rng.integers(1, Q + 1, Bn).astype(np.int32)
    tlen = np.clip(qlen + rng.integers(-5, 6, Bn), 1, T).astype(np.int32)
    w = (np.abs(qlen - tlen) + rng.integers(0, 8, Bn)).astype(np.int32)
    mat = OPT.score_matrix()
    kw = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
              e_ins=OPT.e_ins)
    want = jax_ga(*(jnp.asarray(a) for a in (q, qlen, t, tlen, mat, w)),
                  **kw)
    got = global_align_cigar_batch(
        *(torch.as_tensor(a) for a in (q, qlen, t, tlen, mat, w)), **kw)
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(want.score))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    for b in range(0, Bn, 7):                  # and the scalar DP
        sc, cig = global_align(q[b, :qlen[b]], t[b, :tlen[b]], mat,
                               w=int(w[b]), **kw)
        assert (int(got.score[b]), steps_to_cigar(got.steps[b].numpy())) \
            == (sc, cig)


def test_flat_sam_device_halves_match_jax():
    from tpubwa.align import flatsam as jfs
    from tpubwa_torch.align import flatsam as tfs

    jal, tal, batch = _aligners("random", 32)
    rng = np.random.default_rng(8)
    N = 50
    l_pac = tal.idx.l_pac
    rd = rng.integers(0, batch.n, N).astype(np.int32)
    qb = rng.integers(0, 20, N).astype(np.int32)
    lq = rng.integers(100, 131, N).astype(np.int32)
    rlen = np.clip(lq + rng.integers(-4, 5, N), 1, 256).astype(np.int32)
    rev = rng.random(N) < 0.5
    rb = np.where(rev, l_pac, 0) + rng.integers(0, l_pac - 300, N)
    codes = batch.codes.astype(np.int32)
    kw = dict(q_pad=jfs.QPAD, t_win=jfs.TWIN, a=OPT.a, b=OPT.b)
    J = jnp.asarray
    wq, wt, wp = jfs._flat_windows(jal.di, J(codes), J(rd), J(qb), J(lq),
                                   J(rb), J(rlen), J(rev), **kw)
    T = torch.as_tensor
    gq, gt, gp = tfs._flat_windows(tal.di, T(codes), T(rd), T(qb), T(lq),
                                   T(rb), T(rlen), T(rev), **kw)
    for g, w in ((gq, wq), (gt, wt), (gp, wp)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rows = np.arange(0, N, 2).astype(np.int32)
    ww = (np.abs(rlen - lq)[rows] + 3 + rows % 5).astype(np.int32)
    gk = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
              e_ins=OPT.e_ins)
    want = jfs._ga_rows(wq, wt, J(rows), J(lq[rows]), J(rlen[rows]), J(ww),
                        jal.mat_dev, **gk)
    got = tfs._ga_rows(gq, gt, T(rows), T(lq[rows]), T(rlen[rows]), T(ww),
                       tal.mat_dev, **gk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
