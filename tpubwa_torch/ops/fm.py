"""Device-side FM-index search primitives (PyTorch).

Port of ``tpubwa.ops.fm``.  Each occ query is ONE gather row from the
fused ``cp[nblocks, 8]`` tensor (4 cumulative counts + 64 BWT symbols
packed 2-bit into 4 words), followed by a popcount.  Two dtype layouts
share one code path (every op follows the dtypes of its inputs):

- **narrow** (seq_len + 1 < 2^31): ``cp``, ``sa`` and ``L2`` are int32;
- **wide** (>= 2^31, e.g. GRCh38's 6.2 Gbp index text): ``cp``, ``sa``
  and ``L2`` are int64, and ``cp``'s columns 4..7 hold the packed words'
  unsigned values, so an occ query is still one gather row.

torch has no popcount op and no arithmetic on uint32, and ``>>`` on int32
is arithmetic.  So the packed words are widened to int64 and masked to
their 32-bit value right after the gather, and the popcount is a SWAR bit
count on those int64 values.  ``pac_words`` keeps the uint32 bit pattern
in an int32 tensor: its 2-bit fields are read as ``(w >> 2k) & 3`` with
``2k <= 30``, which an arithmetic shift answers exactly.

The sampled suffix array (``SampledSA``, ``build_sampled_sa``,
``sa_lookup_sampled``) is the single-device mode for genomes whose full SA
does not fit: it keeps the SA positions that are multiples of 2^shift and
LF-walks back to one of them.  ``sa_lookup_sampled`` here is the plain
version; ``ops.sa_sampled_cuda`` holds its CUDA kernel.

The sharded suffix array (``ShardedSA``, ``sa_lookup_sharded``) is the
mode of a device mesh: the SA is split over the mesh's devices and each
lookup asks every shard.  It is plain torch ops and copies between
devices.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from tpubwa_torch.index.fmindex import FMIndex

_M32 = 0xFFFFFFFF


def _tensor(a, device) -> torch.Tensor:
    """numpy -> tensor on `device`: int64 stays int64, uint32 keeps its
    bit pattern as int32, everything else becomes int32."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:   # e.g. np.asarray of a JAX array
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int64:
        a = a.astype(np.int32)
    return torch.as_tensor(a, device=device)


def wide_layout(idx: FMIndex) -> bool:
    """Whether the index text of `idx` needs the wide (int64) layout:
    seq_len + 1 >= 2^31."""
    return idx.seq_len + 1 >= 1 << 31


class DeviceIndex(NamedTuple):
    """Device-resident FM-index tensors (narrow or wide layout)."""

    cp: torch.Tensor         # int32|int64 [nblocks, 8]
    sa: torch.Tensor         # int32|int64 [N+1] ([1] under sa_stub)
    pac_words: torch.Tensor  # int32 [ceil(l_pac/16)] (uint32 bit pattern)
    L2: torch.Tensor         # int32|int64 [5]
    primary: int
    l_pac: int

    @classmethod
    def from_host(cls, idx: FMIndex, device, wide: bool | None = None,
                  sa_stub: bool = False) -> "DeviceIndex":
        """The device layout of `idx`: wide when ``wide`` says so, or by
        default when the index text needs it (seq_len + 1 >= 2^31).
        ``sa_stub`` keeps only ``sa[:1]`` (sampled-SA serving resolves
        positions through a ``SampledSA`` instead)."""
        if wide is None:
            wide = wide_layout(idx)
        if not wide:
            return cls.from_numpy(dict(
                cp=idx.cp.astype(np.int32),
                sa=idx.sa_ls[:1] if sa_stub else idx.sa_ls,
                pac_words=idx.pac_words,
                L2=np.asarray(idx.L2).astype(np.int32),
                primary=idx.primary, l_pac=idx.l_pac), device)
        cp_wide = np.zeros((idx.cp.shape[0], 8), dtype=np.int64)
        counts = idx.cp[:, 0:4].view(np.uint32).astype(np.int64)
        if idx.cp_hi is not None:   # >= 2^31 builds carry the high words
            counts |= idx.cp_hi.astype(np.int64) << 32
        cp_wide[:, 0:4] = counts
        cp_wide[:, 4:8] = idx.cp[:, 4:8].view(np.uint32)
        di = cls.from_numpy(dict(
            cp=cp_wide, sa=np.asarray([int(idx.sa_ls[0])
                                       | (int(idx.sa_ms[0]) << 32)],
                                      np.int64),
            pac_words=idx.pac_words, L2=np.asarray(idx.L2).astype(np.int64),
            primary=idx.primary, l_pac=idx.l_pac), device)
        return di if sa_stub else di._replace(sa=wide_sa(idx, device))

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray],
                   device) -> "DeviceIndex":
        """Build from numpy arrays named like the fields (for example
        ``np.asarray`` of each field of ``tpubwa.ops.fm.DeviceIndex``):
        int64 arrays stay int64, uint32 ones keep their bit pattern as
        int32, the rest become int32."""
        return cls(cp=_tensor(arrays["cp"], device),
                   sa=_tensor(arrays["sa"], device),
                   pac_words=_tensor(arrays["pac_words"], device),
                   L2=_tensor(arrays["L2"], device),
                   primary=int(arrays["primary"]),
                   l_pac=int(arrays["l_pac"]))


def wide_sa(idx: FMIndex, device, chunk: int = 1 << 26) -> torch.Tensor:
    """The int64 suffix array of `idx` on `device`, made there from its
    5-byte split storage a chunk of rows at a time: the host never holds
    an int64 copy of the whole SA (19.2 GB at 1.2 Gbp)."""
    n = idx.sa_ls.shape[0]
    sa = torch.empty(n, dtype=torch.int64, device=device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        ls = _tensor(idx.sa_ls[lo:hi], device).to(torch.int64) & _M32
        ms = _tensor(idx.sa_ms[lo:hi], device).to(torch.int64)
        sa[lo:hi] = ls | (ms << 32)
    return sa


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


def backward_ext_all(di: DeviceIndex, ik: BiInterval,
                     is_back: bool) -> BiInterval:
    """Extend the bi-interval by every base at once (bwa's bwt_extend).

    is_back=True: prepend base b to the pattern (backward search step).
    is_back=False: append base b (forward step, via the revcomp interval).
    Returns a BiInterval with a trailing axis of 4, one per base b."""
    if is_back:
        return BiInterval(*ext_core(di, ik.k, ik.l, ik.s))
    k_b, l_b, s_b = ext_core(di, ik.l, ik.k, ik.s)
    return BiInterval(k=l_b, l=k_b, s=s_b)


def set_intv(di: DeviceIndex, c: torch.Tensor) -> BiInterval:
    """Initial bi-interval for a single base c (clipped to 0..3; callers
    mask ambiguous bases themselves)."""
    c = c.clamp(0, 3).to(torch.int64)
    k = di.L2[c]
    return BiInterval(k=k, l=di.L2[3 - c], s=di.L2[c + 1] - k)


def sa_lookup(di: DeviceIndex, r: torch.Tensor) -> torch.Tensor:
    """Suffix-array positions for rows r."""
    return di.sa[r]


# ------------------------------------------------------- sharded SA ----
#
# The serving mode for a suffix array too big for one card (GRCh38's int64
# SA is ~49.6 GB): the SA is split over the devices of a mesh, and every
# lookup asks all of them.


class ShardedSA(NamedTuple):
    """The suffix array padded with zeros to a multiple of N and split
    into N contiguous pieces of ``rows`` rows, piece d on device d of the
    mesh (the dtypes of ``DeviceIndex.sa``)."""

    shards: tuple
    rows: int

    @property
    def n_rows(self) -> int:
        """Rows of the padded SA."""
        return self.rows * len(self.shards)

    @classmethod
    def from_host(cls, idx: FMIndex, devices, wide: bool) -> "ShardedSA":
        """Split ``idx``'s SA over `devices` (one piece each, in order),
        a piece at a time: the whole SA is never held as one array."""
        n = idx.sa_ls.shape[0]
        per = -(-n // len(devices))
        shards = []
        for d, dev in enumerate(devices):
            lo, hi = min(d * per, n), min((d + 1) * per, n)
            piece = (idx.sa_ls[lo:hi].astype(np.int64)
                     | (idx.sa_ms[lo:hi].astype(np.int64) << 32)) if wide \
                else idx.sa_ls[lo:hi]
            padded = np.zeros(per, np.int64 if wide else np.int32)
            padded[:hi - lo] = piece
            shards.append(_tensor(padded, dev))
        return cls(shards=tuple(shards), rows=per)


def sa_lookup_sharded(ssa: ShardedSA, rows: list) -> list:
    """Suffix positions for global rows (each in [0, ssa.n_rows)) when the
    SA is sharded: ``rows`` holds one tensor a requester, on any device;
    the answers come back in the same order, each on its requester's
    device.

    Every shard gathers all requests onto its device and answers those
    inside its slice (0 elsewhere); the answers are then summed back to
    each requester.  Exactly one shard hits each request, so the sum is
    the answer.  What moves between devices is the requests and the
    answers, never the SA."""
    if not rows:
        return []
    sizes = [r.numel() for r in rows]
    answers = []
    for d, sa_d in enumerate(ssa.shards):
        dev = sa_d.device
        allrows = torch.cat([r.reshape(-1).to(dev, non_blocking=True)
                             for r in rows])
        loc = allrows - d * ssa.rows
        hit = (loc >= 0) & (loc < ssa.rows)
        answers.append(torch.where(hit, sa_d[loc.clamp(0, ssa.rows - 1)],
                                   0))
    out = []
    off = 0
    for r, n in zip(rows, sizes):
        acc = None
        for ans in answers:
            part = ans[off:off + n].to(r.device, non_blocking=True)
            acc = part if acc is None else acc + part
        out.append(acc.reshape(r.shape))
        off += n
    return out


# ------------------------------------------------------- sampled SA ----
#
# Rows are sampled by SUFFIX POSITION (rows r with sa[r] % 2^shift == 0),
# so the LF-walk back to a sample is bounded at 2^shift - 1 steps.  Each
# step is two gathers per lane: a rank-directory row and a cp row.  The
# results are exactly the full SA's.


class SampledSA(NamedTuple):
    """Position-sampled suffix array + rank directory.

    blocks: int32|int64 [nblocks, 4] — per 64 rows: (rank_before,
            mask_lo, mask_hi, 0); mask bit b set <=> row 64*blk + b is
            sampled.  The mask words are stored as signed 32-bit values
            (their uint32 bit pattern), sign-extended in an int64 tensor.
    vals:   int32|int64 [n_sampled] — suffix positions of sampled rows in
            row order
    """

    blocks: torch.Tensor
    vals: torch.Tensor

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray],
                   device) -> "SampledSA":
        """Build from ``np.asarray`` of each field of
        ``tpubwa.ops.fm.SampledSA`` (dtypes as in ``DeviceIndex``)."""
        return cls(blocks=_tensor(arrays["blocks"], device),
                   vals=_tensor(arrays["vals"], device))


def build_sampled_sa(sa_host, shift: int, wide: bool, idx=None, *,
                     device) -> SampledSA:
    """Host-side construction, CHUNKED: a Gbp-scale SA is ~19 GB as
    int64, and a one-shot vectorized build holds several times that in
    transients.  Chunks of 64M rows keep the working set ~1 GB.  The
    tables go to ``device``, which the caller names (there is no
    default: a forgotten device would put them on the CPU).

    Pass ``idx`` (FMIndex) instead of ``sa_host`` to avoid materializing
    the full int64 SA at all — chunks combine the 5-byte split storage
    (sa_ls/sa_ms) on the fly."""
    intv = 1 << shift
    if idx is not None:
        n = idx.sa_ls.shape[0]

        def chunk(lo, hi):
            return (idx.sa_ls[lo:hi].astype(np.int64)
                    | (idx.sa_ms[lo:hi].astype(np.int64) << 32))
    else:
        n = sa_host.shape[0]

        def chunk(lo, hi):
            return sa_host[lo:hi]

    nblocks = (n + 63) // 64
    dt = np.int64 if wide else np.int32
    blocks = np.zeros((nblocks, 4), dtype=dt)
    vals_parts = []
    shifts32 = np.arange(32, dtype=np.uint32)[None, :]
    C = 1 << 26  # 64M rows per chunk (multiple of 64)
    rank = 0
    for lo in range(0, n, C):
        hi = min(lo + C, n)
        sa_c = chunk(lo, hi)
        mask = (sa_c % intv) == 0
        vals_parts.append(sa_c[mask].astype(dt))
        nb = (hi - lo + 63) // 64
        bits = np.zeros(nb * 64, dtype=bool)
        bits[: hi - lo] = mask
        w = bits.reshape(nb, 2, 32)
        words = (w.astype(np.uint32) << shifts32[None, :, :]).sum(
            axis=2, dtype=np.uint32)
        cnt = bits.reshape(nb, 64).sum(axis=1)
        b0 = lo // 64
        blocks[b0:b0 + nb, 0] = rank + np.cumsum(cnt) - cnt
        blocks[b0:b0 + nb, 1] = words[:, 0].view(np.int32)
        blocks[b0:b0 + nb, 2] = words[:, 1].view(np.int32)
        rank += int(cnt.sum())
    vals = np.concatenate(vals_parts) if vals_parts else \
        np.zeros(0, dtype=dt)
    return SampledSA.from_numpy(dict(blocks=blocks, vals=vals), device)


def lf_step(di: DeviceIndex, r: torch.Tensor) -> torch.Tensor:
    """One LF-mapping step: the row of the suffix starting one base
    earlier (sa[lf(r)] == sa[r] - 1; the caller guarantees sa[r] > 0).
    One cp gather per lane gives both the BWT symbol at r and its occ
    count."""
    j = r - (r > di.primary).to(r.dtype)
    off = (j & 63).to(torch.int64)
    row = di.cp[j >> 6]                                # [..., 8]
    counts = row[..., 0:4]
    words = row[..., 4:8].to(torch.int64) & _M32       # [..., 4]
    # BWT symbol at row r: word (off >> 4), 2-bit field (off & 15)
    word = words.gather(-1, (off >> 4)[..., None])[..., 0]
    c = (word >> (2 * (off & 15))) & 3
    # occ(c, r): checkpoint count + symbols equal to c before off
    ids = torch.arange(4, dtype=torch.int64, device=r.device)
    p = (off[..., None] - 16 * ids).clamp(0, 16)
    mask = torch.where(p >= 16, _M32, (torch.ones_like(p) << (2 * p)) - 1)
    x = words ^ (c * 0x55555555)[..., None]
    neq_bits = (x | (x >> 1)) & 0x55555555
    neq = popcount32(neq_bits & mask).sum(-1)
    occ_c = counts.gather(-1, c[..., None])[..., 0] + (off - neq).to(
        counts.dtype)
    return di.L2[c] + occ_c


def _probe(ss: SampledSA, r: torch.Tensor):
    """(is row r sampled, its rank among the sampled rows)."""
    brow = ss.blocks[r >> 6]                           # [..., 4]
    off = (r & 63).to(torch.int64)
    lo = brow[..., 1].to(torch.int64) & _M32           # signed -> uint32
    hi = brow[..., 2].to(torch.int64) & _M32
    in_hi = off >= 32
    bit = ((torch.where(in_hi, hi, lo) >> (off & 31)) & 1).bool()
    one = torch.ones_like(off)
    m_lo = torch.where(in_hi, _M32, (one << (off & 31)) - 1)
    m_hi = torch.where(in_hi, (one << (off - 32).clamp(0, 31)) - 1, 0)
    rank = brow[..., 0] + (popcount32(lo & m_lo)
                           + popcount32(hi & m_hi)).to(brow.dtype)
    return bit, rank


def sa_lookup_sampled(di: DeviceIndex, ss: SampledSA, rows: torch.Tensor,
                      shift: int,
                      n_live: torch.Tensor | None = None) -> torch.Tensor:
    """Suffix positions for rows (in [0, N]) via the sampled SA: the plain
    version, all lanes in lockstep for 2^shift iterations.  Each
    iteration probes first and takes the sample (its position plus the
    steps taken so far) for rows whose bit is set, then LF-steps the rows
    not done.  A row that reaches no sample returns 0.  With ``n_live``
    (an integer tensor of one element, on the rows' device) only the
    first ``n_live`` rows (in flat order) are looked up, and the rest are
    0."""
    n_vals = ss.vals.shape[0]
    r = rows
    res = torch.zeros_like(rows)
    done = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
    for t in range(1 << shift):
        bit, rank = _probe(ss, r)
        v = ss.vals[rank.clamp(0, n_vals - 1)]
        res = torch.where(bit & ~done, (v + t).to(res.dtype), res)
        done = done | bit
        r = torch.where(done, r, lf_step(di, r))
    if n_live is None:
        return res
    flat = torch.arange(rows.numel(), device=rows.device).reshape(rows.shape)
    return torch.where(flat < n_live.reshape(()), res, 0)


# ------------------------------------------- contiguous window fetch ----
#
def fetch_ref_batch(di: DeviceIndex, pos: torch.Tensor) -> torch.Tensor:
    """int32 reference codes at positions `pos` in 2*l_pac space (any
    shape; a gather from the 2-bit packed forward reference).  Positions
    out of range give 4."""
    in_range = (pos >= 0) & (pos < 2 * di.l_pac)
    fwd = pos < di.l_pac
    p = torch.where(fwd, pos, 2 * di.l_pac - 1 - pos).clamp(0, di.l_pac - 1)
    w = di.pac_words[(p >> 4).to(torch.int64)]
    code = ((w >> ((p & 15) * 2)) & 3).to(torch.int32)
    code = torch.where(fwd, code, 3 - code)
    return torch.where(in_range, code, 4)


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
