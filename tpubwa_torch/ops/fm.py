"""Device-side FM-index search primitives (PyTorch).

Port of ``tpubwa.ops.fm`` (narrow layout: index text < 2^31).  Each occ
query is ONE gather row from the fused ``cp[nblocks, 8]`` int32 tensor
(4 cumulative counts + 64 BWT symbols packed 2-bit into 4 words),
followed by a popcount.

torch has no popcount op and no arithmetic on uint32, and ``>>`` on int32
is arithmetic.  So the packed words are widened to int64 and masked to
their 32-bit value right after the gather, and the popcount is a SWAR bit
count on those int64 values.  ``pac_words`` keeps the uint32 bit pattern
in an int32 tensor: its 2-bit fields are read as ``(w >> 2k) & 3`` with
``2k <= 30``, which an arithmetic shift answers exactly.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from tpubwa.index.fmindex import FMIndex

_M32 = 0xFFFFFFFF


class DeviceIndex(NamedTuple):
    """Device-resident FM-index tensors (narrow layout)."""

    cp: torch.Tensor         # int32 [nblocks, 8]
    sa: torch.Tensor         # int32 [N+1]
    pac_words: torch.Tensor  # int32 [ceil(l_pac/16)] (uint32 bit pattern)
    L2: torch.Tensor         # int32 [5]
    primary: int
    l_pac: int

    @classmethod
    def from_host(cls, idx: FMIndex, device) -> "DeviceIndex":
        if idx.seq_len + 1 >= 1 << 31:
            raise NotImplementedError(
                "wide (>= 2^31) indexes are not ported yet "
                "(ROADMAP.md queue 1, item P8)")
        return cls.from_numpy(dict(
            cp=idx.cp, sa=idx.sa_ls, pac_words=idx.pac_words, L2=idx.L2,
            primary=idx.primary, l_pac=idx.l_pac), device)

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray],
                   device) -> "DeviceIndex":
        """Build from numpy arrays named like the fields (for example
        ``np.asarray`` of each field of ``tpubwa.ops.fm.DeviceIndex``)."""
        def i32(a):
            a = np.ascontiguousarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            return torch.as_tensor(a.astype(np.int32), device=device)

        return cls(cp=i32(arrays["cp"]), sa=i32(arrays["sa"]),
                   pac_words=i32(arrays["pac_words"]),
                   L2=i32(arrays["L2"]),
                   primary=int(arrays["primary"]),
                   l_pac=int(arrays["l_pac"]))


class BiInterval(NamedTuple):
    """Bidirectional SA interval: [k, k+s) for pattern P, [l, l+s) for
    revcomp(P)."""

    k: torch.Tensor
    l: torch.Tensor
    s: torch.Tensor


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def occ4(cp: torch.Tensor, primary: int, i: torch.Tensor) -> torch.Tensor:
    """occ_full(c, i) for all 4 bases: i [...] in [0, N+1] -> [..., 4]
    counts of each base in BWT_full[0:i) (the sentinel is never counted)."""
    j = i - (i > primary).to(i.dtype)
    off = (j & 63).to(torch.int64)
    row = cp[j >> 6]                                   # [..., 8] one gather
    counts = row[..., 0:4]
    words = row[..., 4:8].to(torch.int64) & _M32       # [..., 4]
    ids = torch.arange(4, dtype=torch.int64, device=cp.device)
    p = (off[..., None] - 16 * ids).clamp(0, 16)       # per-word prefix
    mask = torch.where(p >= 16, _M32, (torch.ones_like(p) << (2 * p)) - 1)
    pat = ids * 0x55555555                             # c repeated 16x
    x = words[..., None, :] ^ pat[:, None]             # [..., 4c, 4w]
    neq_bits = (x | (x >> 1)) & 0x55555555
    neq = popcount32(neq_bits & mask[..., None, :]).sum(-1)   # [..., 4c]
    return counts + (off[..., None] - neq).to(counts.dtype)


def ext_core(di: DeviceIndex, kk: torch.Tensor, ll: torch.Tensor,
             s: torch.Tensor):
    """Backward-prepend update on an explicit (kk, ll, s) pair; returns
    (k_b, l_b, s_b), each [..., 4].  Forward (append) steps swap k/l on
    the way in and out."""
    occ2 = occ4(di.cp, di.primary, torch.stack([kk, kk + s], dim=-1))
    occ_k = occ2[..., 0, :]
    s_b = occ2[..., 1, :] - occ_k
    k_b = di.L2[0:4] + occ_k
    # the sentinel row inside [kk, kk+s) consumes one slot of the
    # co-interval
    sent = ((kk <= di.primary) & (di.primary < kk + s)).to(ll.dtype)
    l3 = ll + sent
    l2 = l3 + s_b[..., 3]
    l1 = l2 + s_b[..., 2]
    l0 = l1 + s_b[..., 1]
    return k_b, torch.stack([l0, l1, l2, l3], dim=-1), s_b


def set_intv(di: DeviceIndex, c: torch.Tensor) -> BiInterval:
    """Initial bi-interval for a single base c (clipped to 0..3; callers
    mask ambiguous bases themselves)."""
    c = c.clamp(0, 3).to(torch.int64)
    k = di.L2[c]
    return BiInterval(k=k, l=di.L2[3 - c], s=di.L2[c + 1] - k)


def sa_lookup(di: DeviceIndex, r: torch.Tensor) -> torch.Tensor:
    """Suffix-array positions for rows r."""
    return di.sa[r]


# ------------------------------------------- contiguous window fetch ----
#
# Extension and SAM windows are consecutive reference spans that never
# cross the l_pac strand boundary: gather the 2-bit packed WORDS (1/16th
# the gathered elements of a per-base gather), unpack, then shift each row
# to its phase within the first word.


def _ref_window_block(di: DeviceIndex, lo: torch.Tensor,
                      T: int) -> torch.Tensor:
    """Physical-coordinate codes [J, T] ascending from per-row ``lo``
    (forward-strand coords; lo may be negative or past l_pac — such slots
    hold garbage that callers mask by window length)."""
    J = lo.shape[0]
    dev = lo.device
    WN = T // 16 + 1
    n_words = di.pac_words.shape[0]
    w_idx = (lo[:, None] >> 4) + torch.arange(WN, device=dev)[None, :]
    words = di.pac_words[w_idx.clamp(0, n_words - 1)]          # [J, WN]
    shifts = torch.arange(16, dtype=torch.int32, device=dev) * 2
    u = ((words[:, :, None] >> shifts) & 3).reshape(J, WN * 16)
    o = lo & 15                                 # row phase within its word
    zeros = torch.zeros((J, 8), dtype=u.dtype, device=dev)
    for s in (8, 4, 2, 1):                      # per-row left shift by o
        shifted = torch.cat([u[:, s:], zeros[:, :s]], dim=1)
        u = torch.where((o[:, None] & s) != 0, shifted, u)
    return u[:, :T]


def ref_window_right(di: DeviceIndex, start: torch.Tensor,
                     T: int) -> torch.Tensor:
    """out[j, t] = ref code at (start[j] + t) in 2*l_pac coords, for a
    window that stays on one strand; slots past the strand-valid span are
    garbage (callers mask by tlen)."""
    rev = start >= di.l_pac
    hi = 2 * di.l_pac - 1 - start               # rev-strand physical top
    block = _ref_window_block(di, torch.where(rev, hi - (T - 1), start), T)
    return torch.where(rev[:, None], (3 - block).flip(1), block)


def ref_window_left(di: DeviceIndex, b: torch.Tensor,
                    T: int) -> torch.Tensor:
    """out[j, t] = ref code at (b[j] - 1 - t): a window read DESCENDING
    from b-1 (the left-extension target order); same masking contract."""
    rev = (b - 1) >= di.l_pac
    block = _ref_window_block(di, torch.where(rev, 2 * di.l_pac - b, b - T),
                              T)
    return torch.where(rev[:, None], 3 - block, block.flip(1))
