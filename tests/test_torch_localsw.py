"""The port's mate-rescue local SW against the JAX package.

* The plain ``localsw_batch`` (what the wrapper runs on the CPU, and what
  the CUDA kernel is held to on the card) equals, on every lane,
  ``tpubwa.ops.localsw.localsw_batch`` and the scalar ``localsw_ref`` on
  rescue-shaped jobs: a mutated mate inside a longer window, N codes,
  empty lanes, minsc spread, and a second pass whose endsc comes from
  the first (as ``matesw_gen`` sets it).
* The three cases of tests/test_matesw.py through the port's
  ``matesw_gen`` + ``run_matesw_rounds`` rescue the same ``AlnReg``
  fields as the JAX run.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubwa.align.region import AlnReg
from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig

torch.set_num_threads(1)

OPT = MemOptions()
MAT = OPT.score_matrix()
KW = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins, e_ins=OPT.e_ins)
BIG = 1 << 30


def _jobs(seed, B, Q, T):
    """First-pass rescue jobs: the query is a mutated piece of the target
    window (or unrelated noise), with N codes and empty lanes."""
    rng = np.random.default_rng(seed)
    q = np.full((B, Q), 4, np.int32)
    t = np.full((B, T), 4, np.int32)
    qlen = rng.integers(1, Q + 1, B).astype(np.int32)
    tlen = rng.integers(Q // 2, T + 1, B).astype(np.int32)
    for b in range(B):
        tt = rng.integers(0, 4, T)
        if b % 4:
            off = int(rng.integers(0, max(tlen[b] - qlen[b], 1)))
            qq = tt[off:off + Q].copy()
            qq = np.concatenate([qq, rng.integers(0, 4, Q - qq.size)])
            mut = rng.random(Q) < rng.choice([0.01, 0.05, 0.15])
            qq[mut] = rng.integers(0, 4, int(mut.sum()))
            if b % 5 == 0:                      # an indel
                p = int(rng.integers(1, Q - 4))
                qq = np.concatenate([qq[:p], qq[p + 3:], qq[:3]])
        else:
            qq = rng.integers(0, 4, Q)
        q[b] = qq
        t[b] = tt
    q[rng.random((B, Q)) < 0.01] = 4
    t[rng.random((B, T)) < 0.01] = 4
    qlen[0] = 0
    tlen[1] = 0
    qlen[2] = tlen[2] = 0
    for b in range(B):
        q[b, qlen[b]:] = 4
        t[b, tlen[b]:] = 4
    minsc = rng.integers(0, 40, B).astype(np.int32)
    endsc = np.full(B, BIG, np.int32)
    return q, qlen, t, tlen, minsc, endsc


def _second_pass(first, res):
    """matesw_gen's reverse pass: the query and target prefixes up to
    (qe, te), reversed, with endsc = the first pass's score."""
    q, qlen, t, tlen, minsc, _ = first
    score, te, qe, _ = res
    q2 = np.full_like(q, 4)
    t2 = np.full_like(t, 4)
    ql2 = np.zeros_like(qlen)
    tl2 = np.zeros_like(tlen)
    for b in range(q.shape[0]):
        if score[b] > 0 and qe[b] >= 0:
            ql2[b], tl2[b] = qe[b] + 1, te[b] + 1
            q2[b, :ql2[b]] = q[b, :ql2[b]][::-1]
            t2[b, :tl2[b]] = t[b, :tl2[b]][::-1]
    return q2, ql2, t2, tl2, minsc, np.maximum(score, 1).astype(np.int32)


def _both(jobs):
    from tpubwa.ops.localsw import localsw_batch as jax_sw
    from tpubwa_torch.ops.localsw_cuda import localsw_core

    q, qlen, t, tlen, minsc, endsc = jobs
    want = np.stack([np.asarray(f) for f in jax_sw(
        jnp.asarray(q), jnp.asarray(qlen), jnp.asarray(t), jnp.asarray(tlen),
        jnp.asarray(MAT), jnp.asarray(minsc), jnp.asarray(endsc), **KW)])
    n0 = localsw_core.launches
    got = np.stack([f.numpy() for f in localsw_core(
        *(torch.as_tensor(a) for a in (q, qlen, t, tlen, MAT, minsc,
                                        endsc)), **KW)])
    assert localsw_core.launches == n0      # CPU tensors: plain version
    return got, want


@pytest.mark.parametrize("T,ref_every", [(256, 1), (1024, 4)])
def test_plain_localsw_equals_jax_and_ref(T, ref_every):
    from tpubwa.ops.localsw import localsw_ref

    first = _jobs(T, 64, 160, T)
    got1, want1 = _both(first)
    np.testing.assert_array_equal(got1, want1)
    second = _second_pass(first, got1)
    got2, want2 = _both(second)
    np.testing.assert_array_equal(got2, want2)
    for (q, qlen, t, tlen, minsc, endsc), got in ((first, got1),
                                                  (second, got2)):
        for b in range(0, q.shape[0], ref_every):
            if qlen[b] == 0:      # localsw_ref needs a query
                continue
            ref = localsw_ref(q[b, :qlen[b]], t[b, :tlen[b]], MAT, **KW,
                              minsc=int(minsc[b]), endsc=int(endsc[b]))
            assert tuple(got[:, b]) == ref, b
    # the jobs exercise what they are meant to
    assert (got1[:, :3] == np.array([[0], [-1], [-1], [-1]])).all()
    assert (got1[0] >= 40).sum() > 10 and (got1[3] >= 0).sum() > 5
    live = second[1] > 0
    assert (got2[0][live] == got1[0][live]).all()   # endsc reached
    assert (got2[1][live] < second[3][live] - 1).any()   # ... early


# --------------------------------------------- mate rescue rounds ----

def _mk_idx(rng, la=8000, lb=8000):
    codes = rng.integers(0, 4, la + lb).astype(np.uint8)
    contigs = [Contig("a", la, 0), Contig("b", lb, la)]
    return FMIndex.build(contigs, codes), codes


def _anchor(rb, rid=0):
    a = AlnReg()
    a.rid = rid
    a.rb = rb
    a.re = rb + 100
    a.qb, a.qe = 0, 100
    a.score = a.truesc = 100
    a.frac_rep = 0.0
    a.secondary = -1
    return a


def _case(name):
    """tests/test_matesw.py's three cases: (idx, anchor, mate sequence,
    pestats, mate regions before the rescue, regions expected after)."""
    from tpubwa.align.pair import PEStat

    seed, rb, m0 = {"falls_through": (77, 7500, 7700),
                    "stops_after_first": (78, 4000, 4300),
                    "skips_consistent": (79, 4000, 4300)}[name]
    idx, codes = _mk_idx(np.random.default_rng(seed))
    a = _anchor(rb)
    ms = (3 - codes[m0:m0 + 100].astype(np.uint8))[::-1].copy()
    ma = []
    if name == "falls_through":
        pes = [PEStat(low=300, high=900, failed=False),
               PEStat(low=100, high=500, failed=False),
               PEStat(failed=True), PEStat(failed=True)]
        n_after = 1
    elif name == "stops_after_first":
        pes = [PEStat(low=100, high=150, failed=False),
               PEStat(low=200, high=500, failed=False),
               PEStat(failed=True), PEStat(failed=True)]
        n_after = 0
    else:
        pes = [PEStat(failed=True), PEStat(low=200, high=500, failed=False),
               PEStat(failed=True), PEStat(failed=True)]
        l2 = idx.l_pac * 2
        existing = _anchor(l2 - 4400, rid=0)
        existing.re = l2 - 4300
        ma = [existing]
        n_after = 1
    return idx, a, ms, pes, ma, n_after


@pytest.mark.parametrize("name", ["falls_through", "stops_after_first",
                                  "skips_consistent"])
def test_matesw_rounds_match_jax(name):
    import copy

    from tpubwa.align import pair as jax_pair
    from tpubwa.ops.localsw import localsw_batch
    from tpubwa_torch.align import pair

    idx, a, ms, pes, ma, n_after = _case(name)
    ma_jax, ma_port = copy.deepcopy(ma), copy.deepcopy(ma)
    n_jax = jax_pair.run_matesw_rounds(
        OPT, [jax_pair.matesw_gen(OPT, idx, pes, a, len(ms), ms, ma_jax)],
        localsw_batch, MAT)
    n_port = pair.run_matesw_rounds(
        OPT, [pair.matesw_gen(OPT, idx, pes, a, len(ms), ms, ma_port)],
        torch.as_tensor(MAT))
    assert n_port == n_jax
    assert [dataclasses.asdict(r) for r in ma_port] == \
        [dataclasses.asdict(r) for r in ma_jax]
    assert len(ma_port) == n_after


# ------------------------- the adversarial jobs, and K4's wrapper ----

@pytest.mark.parametrize("T", [96, 300])
def test_edge_jobs_plain_equals_jax_and_ref(T):
    """qlen 0/1/31/32/33/Q, tlen 0/1/T, endsc reached on row 0 and never,
    all-N, ties for te and qe, a second copy for score2."""
    from tpubwa.ops.localsw import localsw_ref
    from tpubwa_torch.utils.sim import localsw_edge_jobs

    jobs = localsw_edge_jobs(T, 40, T)
    got, want = _both(jobs)
    np.testing.assert_array_equal(got, want)
    q, qlen, t, tlen, minsc, endsc = jobs
    for b in range(0, len(qlen), 5):
        if qlen[b] == 0:
            continue
        ref = localsw_ref(q[b, :qlen[b]], t[b, :tlen[b]], MAT, **KW,
                          minsc=int(minsc[b]), endsc=int(endsc[b]))
        assert tuple(got[:, b]) == ref, b
    dead = (qlen == 0) | (tlen == 0)
    assert (got[:, dead] == np.array([[0], [-1], [-1], [-1]])).all()
    assert (got[3] > 0).any()                           # a score2
    assert ((endsc == 1) & (got[1] == 0)).any()         # stopped on row 0
    assert ((endsc == 30) & (got[0] >= 30) & (got[1] < tlen - 1)).any()


def test_wrapper_reads_buffer_slices_and_refuses_wide_queries():
    from tpubwa_torch.ops import localsw_cuda
    from tpubwa_torch.ops.extend_cuda import as_codes

    # the rescue rounds hand over column slices of one int32 buffer
    buf = torch.as_tensor(np.random.default_rng(1).integers(
        0, 5, (6, 40 + 96 + 4)).astype(np.int32))
    for view in (buf[:, :40], buf[:, 40:136]):
        got = as_codes(view)                    # no copy: same memory
        assert got.data_ptr() == view.data_ptr() and got.stride(0) == 140

    z = torch.zeros(3, dtype=torch.int32)

    def call(Q=8, mat=MAT, n=3):
        v = torch.zeros(n, dtype=torch.int32)
        return localsw_cuda._launch(
            torch.zeros((3, Q), dtype=torch.int32), v,
            torch.zeros((3, 9), dtype=torch.int32), z, mat, z, z, **KW)

    with pytest.raises(ValueError, match="Q="):
        call(Q=localsw_cuda.MAX_Q + 1)
    with pytest.raises(ValueError, match="qlen"):
        call(n=2)
    with pytest.raises(ValueError, match="5x5"):
        call(mat=np.zeros(24, np.int32))
