"""Batched banded affine-gap seed extension — the plain PyTorch version.

Port of ``tpubwa.ops.extend._extend_core``: bwa's ``ksw_extend2``, one
batch lane per extension job, each DP row a vectorised [B, Q] update with
F taken as an exclusive running max of (max(M - oe_ins, 0) + j*e_ins).
This is the reference the CUDA kernel (``ops.extend_cuda``) is held to,
and what the wrapper runs for tensors on the CPU.

``extend_batch`` is the single-extension entry (K1's wrapper:
``ops.extend_cuda.extend_core``); ``extend_seed_batch`` is a whole seed
in one call, left then right with bwa's band-doubling retry
(``_with_retry``, which the flat job programs of ``ops.extend_flat`` use
too).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

I32 = torch.int32
NEG = -(1 << 30)
ALIVE_CHECK = 8   # rows between "any lane alive" host checks


class ExtendBatchResult(NamedTuple):
    score: torch.Tensor
    qle: torch.Tensor
    tle: torch.Tensor
    gtle: torch.Tensor
    gscore: torch.Tensor
    max_off: torch.Tensor


def clamp_band_batch(w, qlen, mat_max: int, o_del: int, e_del: int,
                     o_ins: int, e_ins: int, end_bonus):
    """Vectorised ksw band clamp (floor division matches the C
    double->int cast for the non-negative values that occur here)."""
    max_ins = torch.div(qlen * mat_max + end_bonus - o_ins, e_ins,
                        rounding_mode="floor") + 1
    w = torch.minimum(w, max_ins.clamp(min=1))
    max_del = torch.div(qlen * mat_max + end_bonus - o_del, e_del,
                        rounding_mode="floor") + 1
    return torch.minimum(w, max_del.clamp(min=1)).to(I32)


def score_values(mat) -> tuple[int, int, int]:
    """(match, mismatch, vs-N) from a bwa_fill_scmat-structured [5, 5]
    scoring matrix: the DP computes scores from these three values."""
    flat = torch.as_tensor(mat).reshape(-1)
    return tuple(int(v) for v in flat[[0, 1, 4]].tolist())


def _extend_core(query: torch.Tensor, qlen: torch.Tensor,
                 target: torch.Tensor, tlen: torch.Tensor, mat,
                 w: torch.Tensor, h0: torch.Tensor, end_bonus: torch.Tensor,
                 *, o_del: int, e_del: int, o_ins: int, e_ins: int,
                 zdrop: int, mat_max: int,
                 stats: dict | None = None) -> ExtendBatchResult:
    """Batched ksw_extend2.

    query:  [B, Q] codes 0..4 (padded arbitrarily past qlen)
    target: [B, T] codes 0..4 (padded arbitrarily past tlen)
    mat:    [5, 5] scoring matrix with bwa_fill_scmat structure
    w / h0 / end_bonus / qlen / tlen: [B] per-lane parameters

    Rows stop once no lane is alive: dead lanes are no-ops, so this
    changes nothing in the result.  ``stats`` (a dict, for measurement)
    receives ``cells``: the band cells of the rows each job really visits
    before its own exit, the work a per-job kernel has to do, and
    ``cells_per_job``, the same count job by job (int64 [B])."""
    B, Q = query.shape
    T = target.shape[1]
    dev = query.device
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    s_match, s_mis, s_n = score_values(mat)
    query = query.to(I32)
    target = target.to(I32)
    qlen = qlen.to(I32)
    tlen = tlen.to(I32)
    h0 = h0.to(I32)
    w = clamp_band_batch(w.to(I32), qlen, mat_max, o_del, e_del, o_ins,
                         e_ins, end_bonus.to(I32))

    jb = torch.arange(Q, dtype=I32, device=dev)[None, :]       # [1, Q]
    q_is_n = query >= 4
    qlen_idx = qlen.to(torch.int64)[:, None]

    # H boundary row i=-1: H(-1, j) = max(0, h0 - oe_ins - j*e_ins)
    h_init = torch.clamp(h0[:, None] - oe_ins - jb * e_ins, min=0)
    H_prev = torch.cat([h0[:, None], h_init], dim=1)           # [B, Q+1]
    E = torch.zeros((B, Q), dtype=I32, device=dev)
    M_prev = torch.zeros((B, Q), dtype=I32, device=dev)
    best = h0.clone()
    best_i = torch.full((B,), -1, dtype=I32, device=dev)
    best_j = best_i.clone()
    max_ie = best_i.clone()
    gscore = best_i.clone()
    max_off = torch.zeros(B, dtype=I32, device=dev)
    alive = (qlen > 0) & (tlen > 0)
    neg_col = torch.full((B, 1), NEG, dtype=I32, device=dev)
    cells = torch.zeros(B, dtype=torch.int64, device=dev)

    for i in range(T):
        if i % ALIVE_CHECK == 0 and not bool(alive.any()):
            break
        t_i = target[:, i]
        act = alive & (i < tlen)

        in_band = (jb >= i - w[:, None]) & (jb < i + w[:, None] + 1) \
            & (jb < qlen[:, None])
        if stats is not None:
            cells += (in_band & act[:, None]).sum(dim=1)
        is_n = q_is_n | (t_i >= 4)[:, None]
        s_row = torch.where(is_n, s_n, torch.where(
            t_i[:, None] == query, s_match, s_mis))

        hd = H_prev[:, :Q]                                     # H(i-1, j-1)
        M = torch.where(hd > 0, hd + s_row, 0)
        M = torch.where(in_band, M, 0)

        if i > 0:
            E_new = torch.clamp(torch.maximum(M_prev - oe_del, E - e_del),
                                min=0)
        else:
            E_new = E

        # F via exclusive running max of g = max(M - oe_ins, 0) + j*e_ins
        g = torch.clamp(M - oe_ins, min=0) + jb * e_ins
        cm = torch.cummax(g, dim=1).values
        cm_excl = torch.cat([neg_col, cm[:, :-1]], dim=1)
        F = torch.clamp(cm_excl - (jb - 1) * e_ins, min=0)
        beg = torch.clamp(i - w, min=0)[:, None]
        F = torch.where(jb > beg, F, 0)

        H = torch.maximum(torch.maximum(M, E_new), F)
        H = torch.where(in_band, H, 0)

        m = H.max(dim=1).values
        mj = torch.where(in_band & (H == m[:, None]), jb, -1).max(dim=1).values

        boundary = torch.where(
            i <= w, torch.clamp(h0 - o_del - e_del * (i + 1), min=0), 0)
        H_row = torch.cat([boundary[:, None], H], dim=1)

        # gscore update when the band touches the query end
        reach_end = act & (i + w + 1 >= qlen)
        h_last = H_row.gather(1, qlen_idx)[:, 0]
        g_upd = reach_end & (h_last >= gscore)
        gscore = torch.where(g_upd, h_last, gscore)
        max_ie = torch.where(g_upd, i, max_ie)

        # termination + best tracking
        zero_break = act & (m == 0)
        live = act & ~zero_break
        better = live & (m > best)
        if zdrop > 0:
            di = i - best_i
            dj = mj - best_j
            zcond = torch.where(di > dj,
                                best - m - (di - dj) * e_del > zdrop,
                                best - m - (dj - di) * e_ins > zdrop)
            z_break = live & ~better & zcond
        else:
            z_break = torch.zeros_like(zero_break)
        max_off = torch.where(
            better, torch.maximum(max_off, (mj - i).abs()), max_off)
        best = torch.where(better, m, best)
        best_i = torch.where(better, i, best_i)
        best_j = torch.where(better, mj, best_j)
        alive = alive & ~zero_break & ~z_break & ((i + 1) < tlen)

        keep = (act & ~zero_break & ~z_break)[:, None]
        H_prev = torch.where(keep, H_row, H_prev)
        E = torch.where(keep, E_new, E)
        M_prev = torch.where(keep, M, M_prev)

    if stats is not None:
        stats["cells"] = int(cells.sum())
        stats["cells_per_job"] = cells
    return ExtendBatchResult(score=best, qle=best_j + 1, tle=best_i + 1,
                             gtle=max_ie + 1, gscore=gscore, max_off=max_off)


def extend_batch(query, qlen, target, tlen, mat, w, h0, end_bonus, *,
                 o_del: int, e_del: int, o_ins: int, e_ins: int, zdrop: int,
                 mat_max: int) -> ExtendBatchResult:
    """Batched ksw_extend2 (``_extend_core``'s contract): the plain version
    for CPU tensors, K1 (``ops.extend_cuda.extend_core``) for CUDA
    tensors."""
    from tpubwa_torch.ops.extend_cuda import extend_core  # imports us

    return extend_core(query, qlen, target, tlen, mat, w, h0, end_bonus,
                       o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                       zdrop=zdrop, mat_max=mat_max)


def _with_retry(core, q, ql, t, tl, mat, w0v, h, bonus, prev_score, kw):
    """One extension side plus bwa's retry at double band for lanes whose
    max_off crossed 3/4 of the band; returns (result, band used).  The
    retry is one more launch over every lane, with qlen 0 (nothing to do)
    where a lane does not retry."""
    res0 = core(q, ql, t, tl, mat, w0v, h, bonus, **kw)
    thresh0 = (w0v >> 1) + (w0v >> 2)
    retry = (ql > 0) & (res0.score != prev_score) & (res0.max_off >= thresh0)
    res1 = core(q, torch.where(retry, ql, 0), t, tl, mat, 2 * w0v, h, bonus,
                **kw)
    res = ExtendBatchResult(*(torch.where(retry, b, a)
                              for a, b in zip(res0, res1)))
    return res, torch.where(retry, 2 * w0v, w0v)


class SeedExtResult(NamedTuple):
    left: ExtendBatchResult    # fields are garbage where qlen_l == 0
    right: ExtendBatchResult   # fields are garbage where qlen_r == 0
    score0: torch.Tensor       # [B] score after the left half (= h0 input
    #                            of the right half)
    aw0: torch.Tensor          # [B] band actually used on the left
    aw1: torch.Tensor          # [B] band actually used on the right


def extend_seed_batch(q_l, qlen_l, t_l, tlen_l, q_r, qlen_r, t_r, tlen_r,
                      mat, w0, h0, pen5, pen3, *, o_del: int, e_del: int,
                      o_ins: int, e_ins: int, zdrop: int, mat_max: int,
                      core=None) -> SeedExtResult:
    """Whole-seed extension: left extension (reversed sequences) with its
    retry, then the right extension seeded with the left score, with its
    own retry — bwa's per-seed loop in mem_chain2aln ([src] bwamem.cpp;
    SURVEY.md §3.1 worker_aln).

    h0: [B] initial score (seed_len * a).  ``core`` is the single-
    extension function; the default is K1's wrapper (``extend_batch``:
    the plain version for CPU tensors, K1 for CUDA tensors), the Aligner
    passes its layout's (``align.pipeline.EXT_CORES``)."""
    core = core or extend_batch
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, mat_max=mat_max)
    left, aw0 = _with_retry(core, q_l, qlen_l, t_l, tlen_l, mat, w0, h0,
                            pen5, -1, kw)
    score0 = torch.where(qlen_l > 0, left.score, h0)
    right, aw1 = _with_retry(core, q_r, qlen_r, t_r, tlen_r, mat, w0, score0,
                             pen3, score0, kw)
    return SeedExtResult(left=left, right=right, score0=score0, aw0=aw0,
                         aw1=aw1)
