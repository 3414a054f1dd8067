"""The plain references of the global-alignment kernel (K3) against the
JAX package, on seeded lanes built to reach every branch the kernel has:
single-base and long gaps, more CIGAR segments than the pack holds
(``nseg > GA_K``), a target or a query of one base, N codes, the band at
its cap (4 * opt.w) and at its floor (``|qlen - tlen|``).

``_ga_rows`` (the int16 pack the flat SAM path downloads) and
``global_align_cigar_core`` (the step rows of the generator tier's
executor) run their plain versions on CPU tensors; both are compared
exactly (integers) with ``tpubwa.align.flatsam._ga_rows`` and
``tpubwa.ops.global_align.global_align_cigar_batch``.  The scalar numpy
``global_align`` is held to the same lanes.  The lanes are
``tpubwa_torch.utils.sim.ga_lanes``: the same generator feeds the on-card
comparisons (chip_smoke.py, tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa_torch.utils.sim import ga_lanes as make_lanes

torch.set_num_threads(1)

OPT = MemOptions()
GAPS = {"default": dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
                        e_ins=OPT.e_ins),
        "skewed": dict(o_del=4, e_del=2, o_ins=7, e_ins=1)}


@pytest.mark.parametrize("gaps", ["default", "skewed"])
def test_ga_rows_pack_matches_jax(gaps):
    from tpubwa.align.flatsam import GA_K as JAX_GA_K
    from tpubwa.align.flatsam import _ga_rows as jax_ga_rows
    from tpubwa_torch.align.flatsam import GA_K, _ga_rows

    assert GA_K == JAX_GA_K == 24
    n = 96
    qD, tD, qlen, tlen, w = make_lanes(1 if gaps == "default" else 3, n)
    rows = np.random.default_rng(0).permutation(n)[:n - 5].astype(np.int64)
    mat = OPT.score_matrix()
    want = np.asarray(jax_ga_rows(
        jnp.asarray(qD), jnp.asarray(tD), jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(qlen[rows]), jnp.asarray(tlen[rows]),
        jnp.asarray(w[rows]), jnp.asarray(mat), **GAPS[gaps]))
    got = _ga_rows(torch.as_tensor(qD), torch.as_tensor(tD),
                   torch.as_tensor(rows), torch.as_tensor(qlen[rows]),
                   torch.as_tensor(tlen[rows]), torch.as_tensor(w[rows]),
                   torch.as_tensor(mat), **GAPS[gaps])
    assert got.dtype == torch.int16 and tuple(got.shape) == (n - 5, 2 + GA_K)
    np.testing.assert_array_equal(got.numpy(), want)
    nseg = want[:, 1]
    assert (nseg > GA_K).sum() >= 3           # overflowing packs, all zero
    assert not want[nseg > GA_K, 2:].any()
    assert ((nseg > 1) & (nseg <= GA_K)).sum() >= 30      # gapped cigars
    assert (tlen[rows] == 1).any() and (qlen[rows] == 1).any()
    lens = want[:, 2:] >> 2                   # a gap of >= 20 in one piece
    assert (((want[:, 2:] & 3) != 0) & (lens >= 20)).any()


def test_ga_rows_empty_batch():
    from tpubwa_torch.align.flatsam import GA_K, _ga_rows

    qD, tD, qlen, tlen, w = make_lanes(1, 8)
    e = torch.zeros(0, dtype=torch.int32)
    got = _ga_rows(torch.as_tensor(qD), torch.as_tensor(tD),
                   torch.zeros(0, dtype=torch.int64), e, e, e,
                   torch.as_tensor(OPT.score_matrix()), **GAPS["default"])
    assert tuple(got.shape) == (0, 2 + GA_K) and got.dtype == torch.int16


@pytest.mark.parametrize("Q,T", [(64, 128), (192, 256)])
def test_cigar_core_matches_jax_and_scalar(Q, T):
    """The executor's entry point on CPU tensors (its plain version):
    scores and whole step rows equal the JAX scan's; the cigars equal the
    scalar numpy DP's."""
    from tpubwa.ops.global_align import \
        global_align_cigar_batch as jax_cigar_batch
    from tpubwa_torch.ops.global_align import global_align, steps_to_cigar
    from tpubwa_torch.ops.global_align_cuda import global_align_cigar_core

    n = 48
    qD, tD, qlen, tlen, w = make_lanes(2, n, Q=min(Q, 192), T=T)
    qlen = np.minimum(qlen, Q)
    qD = qD[:, :Q].astype(np.int32)
    tD = tD.astype(np.int32)
    w = np.maximum(w, np.abs(qlen - tlen))
    mat = OPT.score_matrix()
    kw = GAPS["default"]
    want = jax_cigar_batch(jnp.asarray(qD), jnp.asarray(qlen),
                           jnp.asarray(tD), jnp.asarray(tlen),
                           jnp.asarray(mat), jnp.asarray(w), **kw)
    got = global_align_cigar_core(
        torch.as_tensor(qD), torch.as_tensor(qlen), torch.as_tensor(tD),
        torch.as_tensor(tlen), torch.as_tensor(mat), torch.as_tensor(w), **kw)
    assert global_align_cigar_core.launches == 0     # no kernel on the CPU
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(want.score))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    for r in range(n):
        sc, cig = global_align(qD[r, :qlen[r]], tD[r, :tlen[r]], mat,
                               kw["o_del"], kw["e_del"], kw["o_ins"],
                               kw["e_ins"], int(w[r]))
        assert sc == int(got.score[r])
        assert cig == steps_to_cigar(got.steps[r].numpy())


EDGE_CASES = {
    # name: (Q, T, gaps, lanes taken)
    "192x256-default": (192, 256, "default", None),
    "192x256-skewed": (192, 256, "skewed", None),
    "64x128-default": (64, 128, "default", None),
    "320x512-skewed": (320, 512, "skewed", 300),
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_ga_rows_pack_matches_jax_on_edge_lanes(case):
    """The plain pack on ``utils.sim.ga_edge_lanes`` (w = -1, 0 and
    >= Q + T, the corner outside the band, qlen and tlen 0 and 1,
    nseg > GA_K, long leading and trailing deletions, lanes picked by a
    permutation) equals the JAX package's, whole array."""
    from tpubwa.align.flatsam import _ga_rows as jax_ga_rows
    from tpubwa_torch.align.flatsam import GA_K, _ga_rows
    from tpubwa_torch.utils.sim import ga_edge_lanes

    Q, T, gaps, take = EDGE_CASES[case]
    qD, tD, rows, qlen, tlen, w = ga_edge_lanes(1, Q, T)
    if take:
        rows, qlen, tlen, w = (a[:take] for a in (rows, qlen, tlen, w))
    mat = OPT.score_matrix()
    want = np.asarray(jax_ga_rows(
        jnp.asarray(qD), jnp.asarray(tD), jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(qlen), jnp.asarray(tlen), jnp.asarray(w),
        jnp.asarray(mat), **GAPS[gaps]))
    got = _ga_rows(*(torch.as_tensor(a) for a in (qD, tD, rows, qlen, tlen,
                                                  w, mat)), **GAPS[gaps])
    np.testing.assert_array_equal(got.numpy(), want)
    nseg = want[:, 1]
    assert not want[nseg > GA_K, 2:].any()
    if Q < 150:              # the small windows hold fewer of the kinds
        return
    # the set holds what it promises
    assert (nseg > GA_K).any()
    d = np.abs(qlen - tlen)
    assert ((w == 0) & (qlen == tlen) & (qlen > 1)).any()
    assert (w >= Q + T).any() and (w < 0).any()
    assert ((w < d) & (qlen > 0) & (tlen > 0)).any()     # corner outside
    assert {0, 1} <= set(qlen.tolist()) and {0, 1} <= set(tlen.tolist())
    lens = want[:, 2:] >> 2
    ops = want[:, 2:] & 3
    first = want[:, 2]
    last = want[np.arange(len(nseg)), 1 + np.clip(nseg, 1, GA_K)]
    assert (((first & 3) == 2) & ((first >> 2) >= 30)).any()   # leading D
    assert (((last & 3) == 2) & ((last >> 2) >= 30)).any()     # trailing D
    assert ((ops != 0) & (lens >= 20)).any()


@pytest.mark.parametrize("Q,T", [(192, 256), (320, 512)])
def test_cigar_core_matches_jax_on_edge_lanes(Q, T):
    """The executor's entry point on CPU tensors on the same lanes: scores
    and whole step rows equal the JAX scan's."""
    from tpubwa.ops.global_align import \
        global_align_cigar_batch as jax_cigar_batch
    from tpubwa_torch.ops.global_align_cuda import global_align_cigar_core
    from tpubwa_torch.utils.sim import ga_edge_lanes

    qD, tD, rows, qlen, tlen, w = ga_edge_lanes(2, Q, T)
    m = 240
    q = qD[rows[:m]].astype(np.int32)
    t = tD[rows[:m]].astype(np.int32)
    mat = OPT.score_matrix()
    kw = GAPS["default"]
    want = jax_cigar_batch(jnp.asarray(q), jnp.asarray(qlen[:m]),
                           jnp.asarray(t), jnp.asarray(tlen[:m]),
                           jnp.asarray(mat), jnp.asarray(w[:m]), **kw)
    n0 = global_align_cigar_core.launches
    got = global_align_cigar_core(
        torch.as_tensor(q), torch.as_tensor(qlen[:m]), torch.as_tensor(t),
        torch.as_tensor(tlen[:m]), torch.as_tensor(mat),
        torch.as_tensor(w[:m]), **kw)
    assert global_align_cigar_core.launches == n0    # no kernel on the CPU
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(want.score))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))


@pytest.mark.parametrize("M,Q,T,want", [
    # the main path's windows: two launches, 7 four-warp blocks an SM
    (14870, 192, 256, dict(store=7168, blocks_narrow=924, blocks_wide=1188,
                           narrow_bytes=31616, wide_bytes=25408)),
    (1972, 192, 256, dict(store=7168, blocks_narrow=493, blocks_wide=1188,
                          narrow_bytes=31616, wide_bytes=25408)),
    (1, 192, 256, dict(store=7168, blocks_narrow=1, blocks_wide=1,
                       narrow_bytes=31616, wide_bytes=25408)),
    # a warp of the first launch holds any lane: no second launch
    (500, 64, 128, dict(store=4096, blocks_narrow=125, blocks_wide=0,
                        narrow_bytes=18304, wide_bytes=4672)),
    # the generator tier's largest bucket: one wide block an SM
    (300, 320, 1024, dict(store=7168, blocks_narrow=75, blocks_wide=132,
                          narrow_bytes=35200, wide_bytes=165568)),
])
def test_launch_plan_is_pinned(M, Q, T, want):
    """How the wrapper lays a call on a card of 132 SMs."""
    from tpubwa_torch.ops.global_align_cuda import launch_plan

    assert launch_plan(M, Q, T, 132) == want


def test_wrapper_constants_match_the_source():
    """The constants the wrapper sizes its launches by are the kernel
    source's."""
    import re
    from pathlib import Path

    import tpubwa_torch
    from tpubwa_torch.ops import global_align_cuda as k3

    src = (Path(tpubwa_torch.__file__).parent / "csrc"
           / "global_align.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxQ") == k3.MAX_Q
    assert const("kNarrowWarps") == k3.NARROW_WARPS
    assert const("kNarrowBw") == k3.NARROW_BW
    assert const("kMaxPack") == k3.MAX_PACK
    assert const("kMatPad") * 4 == 128
    assert k3.NARROW_STORE % 4 == 0


def test_ga_pack_takes_cuda_tensors_only():
    """ga_pack has no plain path: CPU tensors raise (``_ga_rows`` is what
    picks the plain version for them)."""
    from tpubwa_torch.ops.global_align_cuda import ga_pack

    qD, tD, qlen, tlen, w = make_lanes(1, 8)
    with pytest.raises(ValueError, match="no global-alignment kernel"):
        ga_pack(torch.as_tensor(qD), torch.as_tensor(tD), torch.arange(8),
                torch.as_tensor(qlen), torch.as_tensor(tlen),
                torch.as_tensor(w), OPT.score_matrix(), **GAPS["default"],
                ga_k=24)
    assert ga_pack.launches == 0
