"""Banded global (Needleman-Wunsch, affine gap) alignment with traceback —
CIGAR generation for surviving alignments (port of
``tpubwa.ops.global_align``).

Semantics of bwa's ksw_global2: gaps open from the match-path score M (no
adjacent I/D), ties prefer M over E(del) over F(ins), gap-extension
continuation flags are set on strict inequality, and the traceback state
machine reads 2 bits per state from the direction byte.

The numpy functions (``global_align``, ``traceback_cigar``,
``steps_to_cigar``, ``cigar_nm_md``) are carried over unchanged; the
batched DP fill and traceback here are the plain version, torch ops row
by row and step by step.  ``ops.global_align_cuda`` holds their CUDA
kernel (``csrc/global_align.cu``) and runs these for CPU tensors only.

CIGAR op codes: 0=M 1=I 2=D 3=S 4=H (tpubwa.io.sam.CIGAR_OPS).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MINUS_INF = -0x40000000


def global_align(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
                 o_del: int, e_del: int, o_ins: int, e_ins: int,
                 w: int) -> tuple[int, list[tuple[int, int]]]:
    """Global alignment of full query (codes) vs full target (codes).

    Returns (score, cigar) where cigar is [(op, len), ...] in
    query/target-forward order.  Callers must ensure w >= |qlen - tlen| (as
    bwa_gen_cigar2 does), else the band may not reach the corner.

    Direction byte per cell: bits0-1 = H source (0=M, 1=E/del, 2=F/ins),
    bits2-3 = 1 if E(i+1,j) extends E (else reopens from M), bits4-5 = 2 if
    F(i,j+1) extends F.
    """
    qlen, tlen = len(query), len(target)
    assert qlen > 0 and tlen > 0
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins

    H_prev = np.full(qlen + 1, MINUS_INF, dtype=np.int64)  # H_prev[j+1]=H(i-1,j)
    H_prev[0] = 0
    fill = min(qlen, w)
    H_prev[1 : fill + 1] = -(o_ins + e_ins * np.arange(1, fill + 1, dtype=np.int64))
    E = np.full(qlen, MINUS_INF, dtype=np.int64)
    M_prev = np.full(qlen, MINUS_INF, dtype=np.int64)

    z = np.zeros((tlen, qlen), dtype=np.uint8)
    mat = mat.astype(np.int64)

    for i in range(tlen):
        beg = max(0, i - w)
        end = min(qlen, i + w + 1)
        n = end - beg
        jrel = np.arange(n, dtype=np.int64)

        M = H_prev[beg:end] + mat[target[i], query[beg:end]]
        if i > 0:
            E = np.maximum(M_prev - oe_del, E - e_del)
        e = E[beg:end]

        # incoming F per column: f[0] = -inf; f[j] = max_{j'<j}(M[j']-oe_ins
        #                                               - (j-1-j')*e_ins)
        g = M - oe_ins + jrel * e_ins
        run = np.maximum.accumulate(g)
        f_in = np.full(n, MINUS_INF, dtype=np.int64)
        if n > 1:
            f_in[1:] = run[:-1] - (jrel[1:] - 1) * e_ins

        d = np.where(M >= e, 0, 1).astype(np.uint8)
        h = np.maximum(M, e)
        d = np.where(h >= f_in, d, 2).astype(np.uint8)
        h = np.maximum(h, f_in)

        # E(i+1, j): extend flag on strict >
        t = M - oe_del
        e2 = e - e_del
        d |= (e2 > t).astype(np.uint8) << 2
        E[beg:end] = np.maximum(e2, t)

        # F(i, j+1): extend flag on strict > (stored in this cell)
        t = M - oe_ins
        f2 = f_in - e_ins
        d |= (f2 > t).astype(np.uint8) << 5  # value 2 in bits 4-5
        z[i, beg:end] = d

        H_row = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
        if beg == 0:
            H_row[0] = -(o_del + e_del * (i + 1))
        H_row[beg + 1 : end + 1] = h
        M_full = np.full(qlen, MINUS_INF, dtype=np.int64)
        M_full[beg:end] = M
        H_prev = H_row
        M_prev = M_full

    score = int(H_prev[qlen])
    return score, traceback_cigar(z, tlen, qlen, w)


def traceback_cigar(z: np.ndarray, tlen: int, qlen: int,
                    w: int) -> list[tuple[int, int]]:
    """Walk the direction matrix z [>=tlen, >=qlen] back from the corner."""
    cigar: list[tuple[int, int]] = []

    def push(op, ln):
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + ln)
        else:
            cigar.append((op, ln))

    i = tlen - 1
    k = min(i + w + 1, qlen) - 1
    which = 0
    while i >= 0 and k >= 0:
        which = (int(z[i, k]) >> (which << 1)) & 3
        if which == 0:
            push(0, 1)
            i -= 1
            k -= 1
        elif which == 1:
            push(2, 1)  # deletion: consumes target
            i -= 1
        else:
            push(1, 1)  # insertion: consumes query
            k -= 1
    if i >= 0:
        push(2, i + 1)
    if k >= 0:
        push(1, k + 1)
    cigar.reverse()
    return cigar


class GlobalBatchResult(NamedTuple):
    score: torch.Tensor   # [B] int32
    z: torch.Tensor       # [B, T, Q] uint8 direction bytes


def global_align_batch(query, qlen, target, tlen, mat, w, *,
                       o_del: int, e_del: int, o_ins: int,
                       e_ins: int) -> GlobalBatchResult:
    """Batched banded global alignment DP fill (device).

    One lane = one (query, target) pair; the fill runs row by row over the
    target with vectorised [B, Q] row updates and the same direction bytes
    as the scalar ``global_align`` above.  Rows past the longest target
    are skipped (they would write zero direction bytes and change no
    state).

    query [B, Q] / target [B, T]: int codes (pad value arbitrary).
    qlen / tlen / w: [B]; callers guarantee w >= |qlen - tlen|.
    """
    I32 = torch.int32
    U8 = torch.uint8
    B, Q = query.shape
    T = target.shape[1]
    dev = query.device
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    NEG = MINUS_INF
    query = query.to(I32)
    target = target.to(I32)
    qlen = qlen.to(I32)
    tlen = tlen.to(I32)
    w = w.to(I32)
    mat_flat = torch.as_tensor(mat, device=dev).reshape(-1).to(I32)

    jb = torch.arange(Q, dtype=I32, device=dev)[None, :]          # j
    j1 = jb + 1                                                   # H_prev idx

    # init row i=-1: H_prev[0]=0, H_prev[j]= -(o_ins+e_ins*j) for j<=min(q,w)
    fill = torch.minimum(qlen, w)[:, None]
    h_tail = torch.where(j1 <= fill, -(o_ins + e_ins * j1), NEG)
    H_prev = torch.cat([torch.zeros((B, 1), dtype=I32, device=dev), h_tail],
                       dim=1)                                     # [B, Q+1]
    E = torch.full((B, Q), NEG, dtype=I32, device=dev)
    M_prev = torch.full((B, Q), NEG, dtype=I32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=I32, device=dev)
    z = torch.zeros((B, T, Q), dtype=U8, device=dev)

    n_rows = min(T, int(tlen.max())) if B else 0
    for i in range(n_rows):
        act = i < tlen                                            # [B]
        in_band = (jb >= i - w[:, None]) & (jb < i + w[:, None] + 1) \
            & (jb < qlen[:, None])
        s_row = mat_flat[target[:, i:i + 1] * 5 + query]          # [B, Q]

        M = H_prev[:, :Q] + s_row                           # H(i-1,j-1)+s
        M = torch.where(in_band, M, NEG)
        if i > 0:
            E = torch.maximum(M_prev - oe_del, E - e_del)
        e = torch.where(in_band, E, NEG)

        # incoming F: exclusive running max of (M - oe_ins + j*e_ins)
        g = torch.where(in_band, M - oe_ins + jb * e_ins, NEG)
        run = torch.cummax(g, dim=1).values
        f_in = torch.cat([neg_col, run[:, :-1]], dim=1) - (jb - 1) * e_ins
        f_in = torch.where(in_band & (jb > 0), f_in, NEG)

        d = torch.where(M >= e, 0, 1).to(U8)
        h = torch.maximum(M, e)
        d = torch.where(h >= f_in, d, 2).to(U8)
        h = torch.maximum(h, f_in)

        t = M - oe_del
        e2 = e - e_del
        d = d | ((e2 > t).to(U8) << 2)
        E_next = torch.maximum(e2, t)

        t = M - oe_ins
        f2 = f_in - e_ins
        d = d | ((f2 > t).to(U8) << 5)
        z[:, i] = torch.where(in_band & act[:, None], d, 0).to(U8)

        h0 = torch.where(i - w <= 0, -(o_del + e_del * (i + 1)), NEG)
        H_row = torch.cat([h0[:, None], torch.where(in_band, h, NEG)], dim=1)
        M_full = torch.where(in_band, M, NEG)

        keep = act[:, None]
        H_prev = torch.where(keep, H_row, H_prev)
        E = torch.where(keep, E_next, E)
        M_prev = torch.where(keep, M_full, M_prev)

    score = H_prev.gather(1, qlen.to(torch.int64)[:, None])[:, 0]
    return GlobalBatchResult(score=score, z=z)


class GlobalCigarResult(NamedTuple):
    score: torch.Tensor   # [B] int32
    steps: torch.Tensor   # [B, T+Q] uint8 CIGAR op per traceback step,
    #                       emitted corner-to-origin (reverse); 3 = end


TRACE_CHECK = 16   # traceback steps between "all lanes done" host checks


def global_align_cigar_batch(query, qlen, target, tlen, mat, w, *,
                             o_del: int, e_del: int, o_ins: int,
                             e_ins: int) -> GlobalCigarResult:
    """Batched global alignment: DP fill + device-side traceback.

    The direction matrix z stays on the device; the O(T+Q) traceback walk
    runs one batched gather per step and returns per-lane op sequences
    (0=M 1=I 2=D, 3=end) in reverse order, which the host run-length
    encodes (steps_to_cigar).  Once every lane has ended the remaining
    steps are all 3 and are filled in without walking."""
    I32 = torch.int32
    B, Q = query.shape
    T = target.shape[1]
    res = global_align_batch(query, qlen, target, tlen, mat, w,
                             o_del=o_del, e_del=e_del, o_ins=o_ins,
                             e_ins=e_ins)
    zflat = res.z.reshape(B, T * Q)
    qlen = qlen.to(I32)
    w = w.to(I32)
    i = tlen.to(I32) - 1
    k = torch.minimum(i + w + 1, qlen) - 1
    which = torch.zeros(B, dtype=I32, device=query.device)
    steps = torch.full((B, T + Q), 3, dtype=torch.uint8, device=query.device)

    for s in range(T + Q):
        if s % TRACE_CHECK == 0 and not bool(((i >= 0) | (k >= 0)).any()):
            break
        in_walk = (i >= 0) & (k >= 0)
        idx = (i.clamp(min=0) * Q + k.clamp(min=0)).to(torch.int64)
        zv = zflat.gather(1, idx[:, None])[:, 0].to(I32)
        which_new = (zv >> (which << 1)) & 3
        # cigar op: 0=M 1=I(query) 2=D(target); 3 = done
        op_walk = torch.where(which_new == 0, 0,
                              torch.where(which_new == 1, 2, 1))
        op = torch.where(in_walk, op_walk,
                         torch.where(i >= 0, 2, torch.where(k >= 0, 1, 3)))
        i = i - ((op == 0) | (op == 2)).to(I32)
        k = k - ((op == 0) | (op == 1)).to(I32)
        which = torch.where(in_walk, which_new, which)
        steps[:, s] = op.to(torch.uint8)
    return GlobalCigarResult(score=res.score, steps=steps)


def steps_to_cigar(steps_row: np.ndarray) -> list[tuple[int, int]]:
    """Run-length encode one device traceback row into [(op, len), ...]."""
    ops = steps_row[steps_row != 3][::-1]
    if ops.size == 0:
        return []
    cut = np.flatnonzero(np.diff(ops)) + 1
    bounds = np.concatenate([[0], cut, [ops.size]])
    return [(int(ops[bounds[i]]), int(bounds[i + 1] - bounds[i]))
            for i in range(len(bounds) - 1)]


_MD_CHARS = "ACGTN"


def cigar_nm_md(query: np.ndarray, target: np.ndarray,
                cigar: list[tuple[int, int]]) -> tuple[int, str]:
    """NM edit distance + MD tag from an M/I/D cigar over code sequences
    (query/target in the same orientation the cigar was computed in).
    M runs are compared vectorized (reads are usually a single long M)."""
    qi = ti = 0
    nm = 0
    md = []
    match_run = 0
    for op, ln in cigar:
        if op == 0:  # M
            q = np.asarray(query[qi:qi + ln])
            t = np.asarray(target[ti:ti + ln])
            mm = np.flatnonzero((q != t) | (q >= 4))
            prev = 0
            for j in mm:
                j = int(j)
                md.append(str(match_run + j - prev))
                md.append(_MD_CHARS[min(int(t[j]), 4)])
                match_run = 0
                prev = j + 1
            match_run += ln - prev
            nm += len(mm)
            qi += ln
            ti += ln
        elif op == 1:  # I
            qi += ln
            nm += ln
        elif op == 2:  # D
            md.append(str(match_run))
            match_run = 0
            md.append("^" + "".join(
                _MD_CHARS[min(int(c), 4)] for c in target[ti:ti + ln]))
            nm += ln
            ti += ln
        elif op in (3, 4):  # clips: query only (not part of NM/MD)
            qi += ln if op == 3 else 0
    md.append(str(match_run))
    return nm, "".join(md)
