"""The best alignment a read's true origin offers, in plain PyTorch.

For each read (forward strand) and a window of the reference around the
bases it was cut from, the exact optimum over all alignments of

    score - pen_clip5 * [the read's start is clipped]
          - pen_clip3 * [the read's end is clipped]

under affine gaps (a gap of length k costs o + k * e), the quantity bwa-mem's
extension maximises when it picks a clipped or an end-to-end alignment
(its extension takes the end-to-end score where that beats the local one
less the clipping penalty).  The window is free at both ends.

Rows are read bases; a row's horizontal gaps are a running maximum
(``torch.cummax``) over the row's cells without horizontal gaps, which is
exact for affine gaps: a gap that starts from a gap is never better than
one gap.  Works on any device; integer arithmetic throughout.
"""
from __future__ import annotations

import torch

NEG = -(1 << 28)


def score_matrix(a: int, b: int) -> torch.Tensor:
    """5x5: a on the diagonal of ACGT, -b off it, -1 against N (4)."""
    m = torch.full((5, 5), -b, dtype=torch.int32)
    m.fill_diagonal_(a)
    m[4, :] = -1
    m[:, 4] = -1
    return m


def best_clipped(reads: torch.Tensor, lens: torch.Tensor,
                 windows: torch.Tensor, sc: dict) -> torch.Tensor:
    """reads [N, Q] (codes, anything past `lens`), windows [N, T] (codes) ->
    [N] int32: the best clip-penalised score of each read in its window."""
    dev = reads.device
    n, q = reads.shape
    t = windows.shape[1]
    mat = score_matrix(sc["a"], sc["b"]).to(dev)
    o_del, e_del = sc["o_del"], sc["e_del"]
    o_ins, e_ins = sc["o_ins"], sc["e_ins"]
    lens = lens.to(dev).long()
    win = windows.long().clamp(0, 4)
    ej = torch.arange(t, device=dev, dtype=torch.int32) * e_del
    neg = torch.full((n, 1), NEG, dtype=torch.int32, device=dev)
    h_prev = torch.full((n, t), NEG, dtype=torch.int32, device=dev)
    f = torch.full((n, t), NEG, dtype=torch.int32, device=dev)
    best = torch.full((n,), NEG, dtype=torch.int32, device=dev)
    for i in range(q):
        s = mat[reads[:, i].long().clamp(0, 4)[:, None], win]
        start = 0 if i == 0 else -sc["pen_clip5"]
        # the pair (i, j) after the pair (i-1, j-1), or as the first pair
        diag = torch.cat([neg, h_prev[:, :-1]], dim=1)
        hn = torch.maximum(diag, torch.full_like(diag, start)) + s
        # a vertical gap: read base i against no window base
        f = torch.maximum(h_prev - (o_ins + e_ins), f - e_ins)
        hn = torch.maximum(hn, f)
        # a horizontal gap: window bases against no read base
        run = torch.cummax(hn + ej, dim=1).values
        e = torch.cat([neg, run[:, :-1]], dim=1) - o_del - ej
        h = torch.maximum(hn, e)
        live = (i < lens)[:, None]
        h = torch.where(live, h, NEG)
        f = torch.where(live, f, NEG)
        end_pen = torch.where(i + 1 < lens, sc["pen_clip3"], 0).to(torch.int32)
        best = torch.maximum(best, h.max(dim=1).values - end_pen)
        h_prev = h
    return best
