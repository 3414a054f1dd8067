"""Batched local Smith-Waterman for mate rescue — the plain PyTorch version.

Port of ``tpubwa.ops.localsw`` (bwa's ksw_align2 / kswv semantics):

  E(i,j) = max(0, E(i-1,j) - e_del, H(i-1,j) - oe_del)
  F(i,j) = max(0, F(i,j-1) - e_ins, H(i,j-1) - oe_ins)
  H(i,j) = max(0, H(i-1,j-1) + S(t_i, q_j), E(i,j), F(i,j))

Outputs per lane: score (global max), te (first row reaching it), qe
(first column reaching that row's max), score2 (best row max at rows
farther than qlen from te, among rows with row max >= minsc; -1 if none).
A per-lane endsc stops the scan after the first row whose max reaches it.

``localsw_batch`` is the JAX scan written as a loop over target rows, F
taken as an exclusive running max (``torch.cummax``) of H-without-F; it
is the reference the CUDA kernel (``ops.localsw_cuda``) is held to, and
what the wrapper runs for tensors on the CPU.  ``localsw_ref`` is the
numpy scalar oracle, copied.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

I32 = torch.int32
BIG = 1 << 30


class LocalSWResult(NamedTuple):
    score: torch.Tensor
    te: torch.Tensor
    qe: torch.Tensor
    score2: torch.Tensor


def localsw_ref(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
                o_del: int, e_del: int, o_ins: int, e_ins: int,
                minsc: int = 0, endsc: int = BIG
                ) -> tuple[int, int, int, int]:
    """Scalar reference.  Returns (score, te, qe, score2)."""
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    H_prev = np.zeros(qlen, dtype=np.int64)
    E = np.zeros(qlen, dtype=np.int64)
    rowmax = []
    rowarg = []
    for i in range(tlen):
        s_row = mat[target[i], query].astype(np.int64)
        M = np.concatenate([[0], H_prev[:-1]]) + s_row
        E = np.maximum(0, np.maximum(E - e_del, H_prev - oe_del))
        H = np.zeros(qlen, dtype=np.int64)
        f = 0
        for j in range(qlen):
            h = max(0, M[j], E[j], f)
            H[j] = h
            f = max(0, f - e_ins, h - oe_ins)
        rowmax.append(int(H.max()))
        rowarg.append(int(H.argmax()))
        H_prev = H
        if rowmax[-1] >= endsc:
            break
    if not rowmax:
        return 0, -1, -1, -1
    gmax = max(rowmax)
    if gmax == 0:
        return 0, -1, -1, -1
    te = rowmax.index(gmax)
    qe = rowarg[te]
    score2 = -1
    for t, m in enumerate(rowmax):
        if m >= minsc and (t < te - qlen or t > te + qlen) and m > score2:
            score2 = m
    return gmax, te, qe, score2


def localsw_batch(query: torch.Tensor, qlen: torch.Tensor,
                  target: torch.Tensor, tlen: torch.Tensor, mat,
                  minsc: torch.Tensor, endsc: torch.Tensor, *, o_del: int,
                  e_del: int, o_ins: int, e_ins: int) -> LocalSWResult:
    """Batched local SW.  query [B,Q], target [B,T] int32 codes (pad=4);
    qlen, tlen, minsc, endsc [B]; mat [5,5].

    Rows past every lane's tlen are not scanned: they count nowhere."""
    B, Q = query.shape
    T = target.shape[1]
    dev = query.device
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    query = query.to(I32)
    target = target.to(I32)
    qlen = qlen.to(I32)
    tlen = tlen.to(I32)
    jb = torch.arange(Q, dtype=I32, device=dev)[None, :]
    in_q = jb < qlen[:, None]
    mat_flat = torch.as_tensor(mat, device=dev).reshape(-1).to(I32)
    neg_col = torch.full((B, 1), -BIG, dtype=I32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=I32, device=dev)
    jbe1 = (jb - 1) * e_ins

    R = torch.full((B, T), -1, dtype=I32, device=dev)
    C = torch.zeros((B, T), dtype=torch.int64, device=dev)
    H = torch.zeros((B, Q), dtype=I32, device=dev)
    E = torch.zeros((B, Q), dtype=I32, device=dev)
    n_rows = min(int(tlen.max()), T) if B else 0
    for i in range(n_rows):
        s_row = mat_flat[target[:, i:i + 1] * 5 + query]
        M = torch.cat([zero_col, H[:, :-1]], dim=1) + s_row
        E = torch.clamp(torch.maximum(E - e_del, H - oe_del), min=0)
        Hnf = torch.where(in_q, torch.clamp(torch.maximum(M, E), min=0), 0)
        cm = torch.cummax(Hnf - oe_ins + jb * e_ins, dim=1).values
        F = torch.cat([neg_col, cm[:, :-1]], dim=1) - jbe1
        H = torch.where(in_q, torch.maximum(Hnf, F), 0)
        active = i < tlen
        H = torch.where(active[:, None], H, 0)
        R[:, i] = torch.where(active, H.max(dim=1).values, -1)
        C[:, i] = H.argmax(dim=1)          # first column reaching the max

    trow = torch.arange(T, dtype=I32, device=dev)[None, :]
    # endsc stop: rows at or before the first row reaching endsc
    reached = (R >= endsc[:, None]).to(I32)
    stop_row = torch.where(reached.any(dim=1), reached.argmax(dim=1), T - 1)
    eff = (trow <= stop_row[:, None]) & (trow < tlen[:, None])
    Reff = torch.where(eff, R, -1)
    gmax = Reff.max(dim=1).values
    te = (Reff == gmax[:, None]).to(I32).argmax(dim=1)   # first row
    qe = C.gather(1, te[:, None])[:, 0].to(I32)
    te = te.to(I32)
    none = gmax <= 0
    score2_mask = eff & (Reff >= minsc[:, None]) \
        & ((trow < (te - qlen)[:, None]) | (trow > (te + qlen)[:, None]))
    score2 = torch.where(score2_mask, Reff, -1).max(dim=1).values
    return LocalSWResult(
        score=torch.where(none, 0, gmax),
        te=torch.where(none, -1, te),
        qe=torch.where(none, -1, qe),
        score2=torch.where(none, -1, score2))
