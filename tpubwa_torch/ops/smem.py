"""Shared SMEM data structures and small batched helpers (PyTorch).

Port of ``tpubwa.ops.smem``: every read in a batch advances in lockstep
through masked chain steps, and fixed-shape buffers with validity counts
carry the irregular per-read output.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Smems(NamedTuple):
    """Fixed-shape SMEM buffers: [B, M] each + count/overflow [B]."""

    k: torch.Tensor
    l: torch.Tensor
    s: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    n: torch.Tensor
    overflow: torch.Tensor


def _take_q(q: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """q: [B, L]; i: [B] -> q[b, i[b]] (out-of-range returns 4)."""
    L = q.shape[-1]
    qi = q.gather(-1, i.clamp(0, L - 1).to(torch.int64)[..., None])[..., 0]
    return torch.where((i >= 0) & (i < L), qi, 4)


def _pick_base(arr4: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """arr4: [..., 4]; c: [...] -> arr4[..., clip(c, 0, 3)]."""
    idx = c.clamp(0, 3).to(torch.int64)[..., None]
    return arr4.gather(-1, idx)[..., 0]
