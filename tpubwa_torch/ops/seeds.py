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

On a device mesh (``seed_rows_mesh``) each shard expands the SMEMs of its
slice of the batch on its own device; under ``shard_sa`` the positions
come from the SA split over the mesh (``ops.fm.sa_lookup_sharded``).

``smems_to_seeds`` is the padded [B, S] expansion (S slots a read, from
the full SA) and ``compact_seeds`` its compaction into ``seed_rows``'s
row layout; ``parallel.mesh.device_align_step`` runs them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpubwa_torch.ops.fm import (DeviceIndex, SampledSA, ShardedSA,
                                 sa_lookup_sharded)
from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core
from tpubwa_torch.ops.smem import Smems

I32 = torch.int32


class SeedBatch(NamedTuple):
    """Seed hits padded to S slots a read (``smems_to_seeds``)."""

    rbeg: torch.Tensor      # [B, S] position in 2*l_pac space (SA dtype)
    qbeg: torch.Tensor      # [B, S] int32
    len: torch.Tensor       # [B, S] int32
    valid: torch.Tensor     # [B, S] bool
    n: torch.Tensor         # [B] int32
    overflow: torch.Tensor  # [B] bool (seed cap hit)
    l_rep: torch.Tensor     # [B] int32 repetitive-coverage length


class CompactSeeds(NamedTuple):
    packed: torch.Tensor    # [R, 4] rows (read_id, rbeg, qbeg, len), in
    #                         (read, slot) order; rows >= n are zero;
    #                         R = min(CAP, B * per_read_cap)
    n: torch.Tensor         # [] number of valid rows
    l_rep: torch.Tensor     # [B] int32
    overflow: torch.Tensor  # [B] bool per-read seed-cap overflow


def seed_rows(di: DeviceIndex, sm: Smems, *, max_occ: int = 500,
              per_read_cap: int = 128, rows_per_read: int = 32,
              ss: SampledSA | None = None,
              sa_shift: int = 0) -> CompactSeeds:
    """SMEMs -> dense [CAP, 4] seed rows in compacted global layout
    (read-major, SMEM order within read), CAP = B * rows_per_read: the
    one-shard case of ``seed_rows_mesh``."""
    return seed_rows_mesh([di], [sm], max_occ=max_occ,
                          per_read_cap=per_read_cap,
                          rows_per_read=rows_per_read, sss=[ss],
                          sa_shift=sa_shift)[0]


def seed_rows_mesh(dis: list, sms: list, *, max_occ: int = 500,
                   per_read_cap: int = 128, rows_per_read: int = 32,
                   sss: list | None = None, sa_shift: int = 0,
                   ssa: ShardedSA | None = None) -> list:
    """``seed_rows`` over the consecutive read slices of a batch: shard d
    has the SMEMs ``sms[d]`` of its reads on the device of ``dis[d]``.
    Returns one CompactSeeds a shard, read ids local to the shard; the
    shards' rows in shard order are the rows of one device over the whole
    batch.

    CAP = B * rows_per_read holds for the whole batch: the shards first
    exchange their row totals (a tensor a shard, no host sync), so that
    shard d knows its global base and keeps exactly the slots below CAP.
    Per-SMEM hit counts are laid out by a cumsum; the slot->SMEM owner map
    is one scatter-max + cummax.  Scatters that drop out-of-range rows
    write to one extra dump row that is sliced off.

    Suffix positions come from each shard's device index, or with
    ``sa_shift > 0`` from its sampled SA ``sss[d]`` (K5 on a CUDA
    device), or from the sharded SA ``ssa``."""
    S = per_read_cap
    CAP = sum(sm.k.shape[0] for sm in sms) * rows_per_read
    sss = sss or [None] * len(sms)
    cnts = [_counts(sm, max_occ, S) for sm in sms]

    # each shard's global base: the row totals of the shards before it
    bases = []
    for d, sm in enumerate(sms):
        dev = sm.k.device
        bases.append(sum((c["tot"].to(dev, non_blocking=True)
                          for c in cnts[:d]),
                         torch.zeros((), dtype=I32, device=dev)))

    lays = [_layout(sm, c, base, CAP, S)
            for sm, c, base in zip(sms, cnts, bases)]
    if ssa is not None:
        # rows span the padded SA; a pad row answers 0
        rbegs = sa_lookup_sharded(
            ssa, [lay["sa_row"].clamp(0, ssa.n_rows - 1) for lay in lays])
    elif sa_shift > 0:
        # rows span [0, N]: clip to the text, never to the stub's sa[:1];
        # only the live rows are seeds: the rest come back 0
        rbegs = [sa_lookup_sampled_core(di, ss,
                                        lay["sa_row"].clamp(0, 2 * di.l_pac),
                                        sa_shift, n_live=lay["n_live"])
                 for di, ss, lay in zip(dis, sss, lays)]
    else:
        rbegs = [di.sa[lay["sa_row"].clamp(0, di.sa.shape[0] - 1)]
                 for di, lay in zip(dis, lays)]
    return [_compact(di, sm, c, lay, rbeg, max_occ)
            for di, sm, c, lay, rbeg in zip(dis, sms, cnts, lays, rbegs)]


def _counts(sm: Smems, max_occ: int, S: int) -> dict:
    """Per-read slot counts (bwa's occ/max_occ stride sampling, truncated
    at the per-read cap S) and the shard's row total."""
    M = sm.k.shape[1]
    dev = sm.k.device
    in_use = torch.arange(M, device=dev)[None, :] < sm.n[:, None]
    occ = torch.where(in_use, sm.s, 0)
    step = torch.where(occ > max_occ, occ // max_occ, 1)
    cnt = torch.clamp(occ, max=max_occ).to(I32)

    # per-read prefix, truncated at the per-read cap S
    off_end_r = torch.cumsum(cnt, dim=1, dtype=I32)
    off_beg_r = off_end_r - cnt
    ob = off_beg_r.clamp(max=S)
    oe = off_end_r.clamp(max=S)
    read_tot = oe[:, -1]
    return dict(in_use=in_use, step=step, ob=ob, cnt2=oe - ob,
                read_tot=read_tot, read_ovf=off_end_r[:, -1] > S,
                tot=read_tot.sum(dtype=I32))


def _layout(sm: Smems, c: dict, base: torch.Tensor, CAP: int,
            S: int) -> dict:
    """The shard's slots: [R, ...] with R = min(CAP, B * S), slot t
    holding global row base + t; the live ones are those below the
    shard's total and below CAP."""
    B, M = sm.k.shape
    dev = sm.k.device
    idt = sm.k.dtype
    R = min(CAP, B * S)
    # local layout: read b's seeds occupy [lb[b], lb[b] + read_tot[b])
    lb = torch.cumsum(c["read_tot"], dim=0, dtype=I32) - c["read_tot"]
    n_live = torch.clamp(torch.minimum(c["tot"], CAP - base), min=0)
    g_beg = (lb[:, None] + c["ob"]).reshape(-1)              # [B*M]

    # owner map: scatter each live SMEM's flat id at its first slot, cummax
    # (SMEMs starting past the R rows are dropped with the rest)
    flat_id = torch.arange(B * M, dtype=I32, device=dev)
    live = (c["cnt2"] > 0).reshape(-1) & (g_beg < R)
    dst = torch.where(live, g_beg, R).to(torch.int64)
    owner = torch.full((R + 1,), -1, dtype=I32, device=dev).scatter_reduce(
        0, dst, flat_id, "amax")[:R]
    owner = torch.cummax(owner, dim=0).values.clamp(0, B * M - 1)
    owner = owner.to(torch.int64)

    t = torch.arange(R, dtype=I32, device=dev)
    j = t - g_beg[owner]
    sa_row = sm.k.reshape(-1)[owner] + (j * c["step"].reshape(-1)[owner]
                                        ).to(idt)
    return dict(owner=owner, valid=t < n_live, n_live=n_live, lb=lb,
                base=base, sa_row=sa_row, CAP=CAP)


def _compact(di: DeviceIndex, sm: Smems, c: dict, lay: dict,
             rbeg: torch.Tensor, max_occ: int) -> CompactSeeds:
    """Drop the seeds that bridge the strand boundary, compact the rows,
    and compute l_rep and the overflow flags."""
    B, M = sm.k.shape
    dev = sm.k.device
    idt = sm.k.dtype
    owner = lay["owner"]
    R = owner.shape[0]
    rd = owner // M
    qbeg = sm.start.reshape(-1)[owner]
    slen = sm.end.reshape(-1)[owner] - qbeg

    # drop seeds bridging the forward/reverse strand boundary
    bridge = (rbeg < di.l_pac) & (rbeg + slen > di.l_pac)
    keep = lay["valid"] & ~bridge

    # compact the (rare) bridge-dropped rows out of the dense prefix
    k32 = keep.to(I32)
    pos = torch.cumsum(k32, dim=0, dtype=I32) - k32
    out_dst = torch.where(keep, pos, R).to(torch.int64)
    rows = torch.stack([rd.to(idt), rbeg.to(idt), qbeg.to(idt),
                        slen.to(idt)], dim=1)
    packed = torch.zeros((R + 1, 4), dtype=idt, device=dev).index_put(
        (out_dst,), rows)[:R]

    l_rep = _l_rep(sm, c["in_use"], max_occ)
    ovf = c["read_ovf"] | (lay["base"] + lay["lb"] + c["read_tot"]
                           > lay["CAP"])
    return CompactSeeds(packed=packed, n=k32.sum(), l_rep=l_rep,
                        overflow=ovf)


def _l_rep(sm: Smems, in_use: torch.Tensor, max_occ: int) -> torch.Tensor:
    """int32 [B]: the union length of the query intervals of the SMEMs
    with more than max_occ hits (the SMEMs of a read are sorted by start,
    so each adds what lies past the ends before it)."""
    B = sm.k.shape[0]
    rep = in_use & (sm.s > max_occ)
    end_m = torch.where(rep, sm.end, 0)
    prev = torch.cat([torch.zeros((B, 1), dtype=end_m.dtype,
                                  device=end_m.device),
                      torch.cummax(end_m, dim=1).values[:, :-1]], dim=1)
    contrib = torch.where(
        rep, torch.clamp(sm.end - torch.maximum(sm.start, prev), min=0), 0)
    return contrib.sum(dim=1).to(I32)


def smems_to_seeds(di: DeviceIndex, sm: Smems, *, max_occ: int = 500,
                   out_seeds: int = 128) -> SeedBatch:
    """SMEMs -> seed hits in S = out_seeds slots a read, SMEM order (bwa's
    occ/max_occ stride sampling; the slots past S are dropped and flagged
    in ``overflow``), positions from the full SA; seeds that bridge the
    strand boundary are cleared from ``valid``."""
    B, M = sm.k.shape
    S = out_seeds
    dev = sm.k.device
    in_use = torch.arange(M, device=dev)[None, :] < sm.n[:, None]
    occ = torch.where(in_use, sm.s, 0)
    step = torch.where(occ > max_occ, occ // max_occ, 1)
    cnt = torch.clamp(occ, max=max_occ)

    # prefix layout: slot t belongs to SMEM m with off[m] <= t < off[m+1]
    off_end = torch.cumsum(cnt, dim=1, dtype=cnt.dtype)      # inclusive
    off_beg = off_end - cnt
    total = torch.clamp(off_end[:, -1], max=S)
    t = torch.arange(S, device=dev)[None, :]                  # [1, S]
    m_idx = (off_end[:, :, None] <= t[:, None, :]).sum(dim=1).clamp(0, M - 1)
    valid = t < total[:, None]

    j = t - off_beg.gather(1, m_idx)
    sa_row = sm.k.gather(1, m_idx) + j * step.gather(1, m_idx)
    rbeg = di.sa[sa_row.clamp(0, di.sa.shape[0] - 1)]
    qbeg = sm.start.gather(1, m_idx)
    slen = sm.end.gather(1, m_idx) - qbeg

    # drop seeds that bridge the forward/reverse boundary (contig
    # boundaries are the host's: the contig offsets live there)
    bridge = (rbeg < di.l_pac) & (rbeg + slen > di.l_pac)
    valid = valid & ~bridge
    return SeedBatch(rbeg=torch.where(valid, rbeg, 0),
                     qbeg=torch.where(valid, qbeg, 0).to(I32),
                     len=torch.where(valid, slen, 0).to(I32), valid=valid,
                     n=valid.sum(dim=1, dtype=I32),
                     overflow=off_end[:, -1] > S,
                     l_rep=_l_rep(sm, in_use, max_occ))


def compact_seeds(sb: SeedBatch) -> CompactSeeds:
    """The valid slots of a padded seed batch as dense [B*S, 4] rows
    (read_id, rbeg, qbeg, len) in (read, slot) order, ``seed_rows``'s
    layout; rows >= n are zero."""
    B, S = sb.rbeg.shape
    dev = sb.rbeg.device
    idt = sb.rbeg.dtype
    valid = sb.valid.reshape(-1)
    pos = torch.cumsum(valid.to(I32), dim=0, dtype=I32) - 1
    dst = torch.where(valid, pos, B * S).to(torch.int64)   # B*S: dropped
    read_id = torch.arange(B, device=dev).repeat_interleave(S)
    rows = torch.stack([read_id.to(idt), sb.rbeg.reshape(-1),
                        sb.qbeg.reshape(-1).to(idt),
                        sb.len.reshape(-1).to(idt)], dim=1)
    packed = torch.zeros((B * S + 1, 4), dtype=idt, device=dev).index_put(
        (dst,), rows)[:B * S]
    return CompactSeeds(packed=packed, n=pos[-1] + 1, l_rep=sb.l_rep,
                        overflow=sb.overflow)
