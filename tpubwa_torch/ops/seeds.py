"""Device seed expansion: SMEMs -> dense (read_id, rbeg, qbeg, len) seed
rows via batched suffix-array gathers (PyTorch port of
``tpubwa.ops.seeds.seed_rows``).

Intervals with more than max_occ hits are subsampled with stride
occ/max_occ (bwa's occurrence sampling); a per-read cap bounds the
output, with overflow reported.  Also computes l_rep (bases covered by
repetitive SMEMs) for the frac_rep MAPQ correction.

With ``sa_shift > 0`` the suffix positions come from a sampled SA
(``ss``) through ``ops.sa_sampled_cuda.sa_lookup_sampled_core`` (K5 on a
CUDA device); the device index then holds only ``sa[:1]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpubwa_torch.ops.fm import DeviceIndex, SampledSA
from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core
from tpubwa_torch.ops.smem import Smems

I32 = torch.int32


class CompactSeeds(NamedTuple):
    packed: torch.Tensor    # [CAP, 4] rows (read_id, rbeg, qbeg, len), in
    #                         (read, slot) order; rows >= n are zero
    n: torch.Tensor         # [] number of valid rows
    l_rep: torch.Tensor     # [B] int32
    overflow: torch.Tensor  # [B] bool per-read seed-cap overflow


def seed_rows(di: DeviceIndex, sm: Smems, *, max_occ: int = 500,
              per_read_cap: int = 128, rows_per_read: int = 32,
              ss: SampledSA | None = None,
              sa_shift: int = 0) -> CompactSeeds:
    """SMEMs -> dense [CAP, 4] seed rows in compacted global layout
    (read-major, SMEM order within read), CAP = B * rows_per_read.

    Per-SMEM hit counts are laid out by a global cumsum; the slot->SMEM
    owner map is one scatter-max + cummax.  Scatters that drop
    out-of-range rows write to one extra dump row that is sliced off."""
    B, M = sm.k.shape
    dev = sm.k.device
    idt = sm.k.dtype
    S = per_read_cap
    CAP = B * rows_per_read
    in_use = torch.arange(M, device=dev)[None, :] < sm.n[:, None]
    occ = torch.where(in_use, sm.s, 0)
    step = torch.where(occ > max_occ, occ // max_occ, 1)
    cnt = torch.clamp(occ, max=max_occ).to(I32)

    # per-read prefix, truncated at the per-read cap S
    off_end_r = torch.cumsum(cnt, dim=1, dtype=I32)
    off_beg_r = off_end_r - cnt
    ob = off_beg_r.clamp(max=S)
    oe = off_end_r.clamp(max=S)
    cnt2 = oe - ob
    read_tot = oe[:, -1]
    read_ovf = off_end_r[:, -1] > S

    # global layout: read b's seeds occupy [base[b], base[b] + read_tot[b])
    base = torch.cumsum(read_tot, dim=0, dtype=I32) - read_tot
    n_total = torch.clamp(base[-1] + read_tot[-1], max=CAP)
    g_beg = (base[:, None] + ob).reshape(-1)                # [B*M]

    # owner map: scatter each live SMEM's flat id at its first slot, cummax
    # (SMEMs starting past the CAP rows are dropped with the rest)
    flat_id = torch.arange(B * M, dtype=I32, device=dev)
    live = (cnt2 > 0).reshape(-1) & (g_beg < CAP)
    dst = torch.where(live, g_beg, CAP).to(torch.int64)
    owner = torch.full((CAP + 1,), -1, dtype=I32, device=dev).scatter_reduce(
        0, dst, flat_id, "amax")[:CAP]
    owner = torch.cummax(owner, dim=0).values.clamp(0, B * M - 1)
    owner = owner.to(torch.int64)

    t = torch.arange(CAP, dtype=I32, device=dev)
    valid = t < n_total
    rd = owner // M
    j = t - g_beg[owner]
    sa_row = sm.k.reshape(-1)[owner] + (j * step.reshape(-1)[owner]).to(idt)
    if sa_shift > 0:
        # rows span [0, N]: clip to the text, never to the stub's sa[:1]
        # only the rows below n_total are seeds: the rest come back 0
        rbeg = sa_lookup_sampled_core(di, ss, sa_row.clamp(0, 2 * di.l_pac),
                                      sa_shift, n_live=n_total)
    else:
        rbeg = di.sa[sa_row.clamp(0, di.sa.shape[0] - 1)]
    qbeg = sm.start.reshape(-1)[owner]
    slen = sm.end.reshape(-1)[owner] - qbeg

    # drop seeds bridging the forward/reverse strand boundary
    bridge = (rbeg < di.l_pac) & (rbeg + slen > di.l_pac)
    keep = valid & ~bridge

    # compact the (rare) bridge-dropped rows out of the dense prefix
    k32 = keep.to(I32)
    pos = torch.cumsum(k32, dim=0, dtype=I32) - k32
    out_dst = torch.where(keep, pos, CAP).to(torch.int64)
    rows = torch.stack([rd.to(idt), rbeg.to(idt), qbeg.to(idt),
                        slen.to(idt)], dim=1)
    packed = torch.zeros((CAP + 1, 4), dtype=idt, device=dev).index_put(
        (out_dst,), rows)[:CAP]

    # l_rep: union length of query intervals of repetitive SMEMs (SMEMs
    # are sorted by start within each read)
    rep = in_use & (sm.s > max_occ)
    end_m = torch.where(rep, sm.end, 0)
    prev = torch.cat([torch.zeros((B, 1), dtype=end_m.dtype, device=dev),
                      torch.cummax(end_m, dim=1).values[:, :-1]], dim=1)
    contrib = torch.where(
        rep, torch.clamp(sm.end - torch.maximum(sm.start, prev), min=0), 0)
    l_rep = contrib.sum(dim=1).to(I32)

    ovf = read_ovf | (base + read_tot > CAP)
    return CompactSeeds(packed=packed, n=k32.sum(), l_rep=l_rep,
                        overflow=ovf)
