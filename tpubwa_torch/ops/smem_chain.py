"""Chain-structured SMEM collection — one lane per read (PyTorch).

Port of ``tpubwa.ops.smem_chain``.  Round-1 chain per lane (state
machine, all lanes step in lockstep):

  FRESH: scan for the next root position (skip Ns / end)
  FWD:   extend [start, i) rightward to maximality -> emit SMEM [start, i)
  BWD:   from the failed append at i, find the longest match ending at
         i+1 (prepend leftward); its start is the next left-maximal root

Round 2 runs the same chain per (read, candidate) lane at occ threshold
t through the candidate's middle; round 3 is a forward-only restart chain
(LAST-like seeding).  Semantics are those of ``tpubwa.ops.fm_ref``.

The three chain functions here are the plain versions: each chain step
is a handful of plain torch ops over all lanes.  The loops check "any
lane not DONE" once per ``UNROLL`` steps (one host sync each): DONE lanes
are no-ops, so the extra steps change nothing.  Writes that JAX expresses
as dropping scatters (an index past the end means "drop") go to one extra
dump column that is sliced off.

``collect_smems_chain`` runs the chains through ``ops.smem_chain_cuda``:
the CUDA kernel (``csrc/smem_chain.cu``) for CUDA tensors, these plain
versions for CPU tensors.  The candidate compaction, the appends and the
sort around them are torch ops on either device.
"""
from __future__ import annotations

import torch

from tpubwa_torch.ops.fm import DeviceIndex, ext_core, set_intv
from tpubwa_torch.ops.smem import Smems, _pick_base, _take_q

I32 = torch.int32
BIG = 1 << 30

FRESH, FWD, BWD, DONE = 0, 1, 2, 3
UNROLL = 8


def _run_chain(step, st: dict) -> dict:
    while bool((st["mode"] != DONE).any()):
        for _ in range(UNROLL):
            st = step(st)
    return st


def _full(n: int, v: int, dtype, device) -> torch.Tensor:
    return torch.full((n,), v, dtype=dtype, device=device)


def _emit(st: dict, emit: torch.Tensor, vals: torch.Tensor, cap: int):
    """Write vals [B, 5] at per-lane slot mn where emit; slot `cap` is the
    dump column for lanes that do not write."""
    mn = st["mn"]
    eok = emit & (mn < cap)
    dest = torch.where(eok, mn, cap).to(torch.int64)
    m5 = st["m5"].scatter_(1, dest[:, None, None].expand(-1, 1, 5),
                           vals[:, None, :])
    return m5, mn + eok.to(I32), st["ovf"] | (emit & (mn >= cap))


def _result(st: dict, cap: int) -> Smems:
    m5 = st["m5"][:, :cap]
    return Smems(k=m5[..., 0], l=m5[..., 1], s=m5[..., 2],
                 start=m5[..., 3], end=m5[..., 4], n=st["mn"],
                 overflow=st["ovf"])


def _mixed_ext(di: DeviceIndex, is_fwd, k, l, s, c):
    """One extension step for every lane: forward-append lanes swap k/l in
    and out; c is the (already complemented where needed) base per lane."""
    kk = torch.where(is_fwd, l, k)
    ll = torch.where(is_fwd, k, l)
    k_b, l_b, s_b = ext_core(di, kk, ll, s)
    nk0 = _pick_base(k_b, c)
    nl0 = _pick_base(l_b, c)
    ns = _pick_base(s_b, c)
    return torch.where(is_fwd, nl0, nk0), torch.where(is_fwd, nk0, nl0), ns


def smem_round1_chain(di: DeviceIndex, q: torch.Tensor, lens: torch.Tensor,
                      min_seed_len: int = 19, cap: int = 64) -> Smems:
    """All round-1 SMEMs (threshold 1) for a [B, L] read batch, in
    ascending-start order per read."""
    B, L = q.shape
    dev = q.device
    idt = di.L2.dtype
    q = q.to(I32)
    lens = lens.to(I32)
    zB = torch.zeros(B, dtype=I32, device=dev)
    zK = torch.zeros(B, dtype=idt, device=dev)
    st = dict(
        mode=torch.where(lens > 0, FRESH, DONE).to(I32),
        i=zB, j=zB, start=zB, e_anchor=zB,
        k=zK, l=zK, s=zK, bk=zK, bl=zK, bs=zK,
        m5=torch.zeros((B, cap + 1, 5), dtype=idt, device=dev),
        mn=zB, ovf=torch.zeros(B, dtype=torch.bool, device=dev),
    )

    def step(st):
        mode, i, j = st["mode"], st["i"], st["j"]
        fresh = mode == FRESH
        fwd = mode == FWD
        bwd = mode == BWD

        # a lane is in exactly one mode: one lookup serves q[i] and q[j]
        qs = _take_q(q, torch.where(bwd, j, i))
        qi = qj = qs

        # one shared extension: FWD lanes append q[i] (complement pick),
        # BWD lanes prepend q[j]
        c = torch.where(fwd, 3 - qi.clamp(0, 3), qj.clamp(0, 3))
        nk, nl, ns = _mixed_ext(di, fwd, torch.where(bwd, st["bk"], st["k"]),
                                torch.where(bwd, st["bl"], st["l"]),
                                torch.where(bwd, st["bs"], st["s"]), c)

        # ---- FRESH ----
        f_end = fresh & (i >= lens)
        f_amb = fresh & ~f_end & (qi > 3)
        f_root = fresh & ~f_end & ~f_amb
        iv0 = set_intv(di, torch.where(f_root, qi, 0))

        # ---- FWD ----
        f_stopx = fwd & ((i >= lens) | (qi > 3))        # end or N
        take = fwd & ~f_stopx & ((ns == st["s"]) | (ns >= 1))
        f_drop = fwd & ~f_stopx & ~take                 # occ-drop at i
        emit = (f_stopx | f_drop) & (i - st["start"] >= min_seed_len)

        # ---- BWD ----
        b_fail = bwd & ((j < 0) | (qj > 3) | (ns < 1))
        b_take = bwd & ~b_fail

        vals = torch.stack([st["k"], st["l"], st["s"], st["start"].to(idt),
                            i.to(idt)], dim=-1)
        m5, mn, ovf = _emit(st, emit, vals, cap)

        # ---- transitions ----
        new_mode = torch.where(f_end, DONE, mode)
        new_mode = torch.where(f_amb, FRESH, new_mode)
        new_mode = torch.where(f_root, FWD, new_mode)
        new_mode = torch.where(f_stopx, FRESH, new_mode)
        new_mode = torch.where(f_drop, BWD, new_mode)
        new_mode = torch.where(b_fail, FWD, new_mode)

        new_i = torch.where(f_amb | f_root | take, i + 1, i)
        new_i = torch.where(b_fail, st["e_anchor"], new_i)
        new_j = torch.where(f_drop, i - 1, torch.where(b_take, j - 1, j))

        new_start = torch.where(f_root, i, st["start"])
        new_start = torch.where(b_fail, j + 1, new_start)

        iv_drop = set_intv(di, torch.where(f_drop, qi, 0))
        new_k = torch.where(f_root, iv0.k, torch.where(take, nk, st["k"]))
        new_l = torch.where(f_root, iv0.l, torch.where(take, nl, st["l"]))
        new_s = torch.where(f_root, iv0.s, torch.where(take, ns, st["s"]))
        new_k = torch.where(b_fail, st["bk"], new_k)
        new_l = torch.where(b_fail, st["bl"], new_l)
        new_s = torch.where(b_fail, st["bs"], new_s)

        return dict(
            mode=new_mode, i=new_i, j=new_j, start=new_start,
            e_anchor=torch.where(f_drop, i + 1, st["e_anchor"]),
            k=new_k, l=new_l, s=new_s,
            bk=torch.where(f_drop, iv_drop.k,
                           torch.where(b_take, nk, st["bk"])),
            bl=torch.where(f_drop, iv_drop.l,
                           torch.where(b_take, nl, st["bl"])),
            bs=torch.where(f_drop, iv_drop.s,
                           torch.where(b_take, ns, st["bs"])),
            m5=m5, mn=mn, ovf=ovf,
        )

    return _result(_run_chain(step, st), cap)


def smem_through_chain(di: DeviceIndex, q: torch.Tensor, lens: torch.Tensor,
                       rd: torch.Tensor, mid: torch.Tensor, thr: torch.Tensor,
                       act: torch.Tensor, min_seed_len: int = 19,
                       cap: int = 32) -> Smems:
    """Round-2 chain: all threshold-`thr` SMEMs through position `mid`,
    one lane per (read, candidate).  rd/mid/thr/act: [G] lane -> read row
    / middle position / occ threshold / active."""
    G = rd.shape[0]
    dev = q.device
    idt = di.L2.dtype
    zG = torch.zeros(G, dtype=I32, device=dev)
    zK = torch.zeros(G, dtype=idt, device=dev)
    qg = q[rd]                       # [G, L] (gather rows once)
    leng = lens[rd]

    qm = _take_q(qg, mid)
    iv0 = set_intv(di, torch.where(act, qm, 0))
    st = dict(
        mode=torch.where(act & (qm < 4), BWD, DONE).to(I32),
        i=zG, j=mid - 1, start=mid, e_anchor=mid + 1,
        k=zK, l=zK, s=zK, bk=iv0.k, bl=iv0.l, bs=iv0.s,
        m5=torch.zeros((G, cap + 1, 5), dtype=idt, device=dev),
        mn=zG, ovf=torch.zeros(G, dtype=torch.bool, device=dev),
    )

    def step(st):
        mode, i, j = st["mode"], st["i"], st["j"]
        fwd = mode == FWD
        bwd = mode == BWD
        qs = _take_q(qg, torch.where(bwd, j, i))
        qi = qj = qs

        c = torch.where(fwd, 3 - qi.clamp(0, 3), qj.clamp(0, 3))
        nk, nl, ns = _mixed_ext(di, fwd, torch.where(bwd, st["bk"], st["k"]),
                                torch.where(bwd, st["bl"], st["l"]),
                                torch.where(bwd, st["bs"], st["s"]), c)

        # ---- FWD ----
        f_stopx = fwd & ((i >= leng) | (qi > 3))
        take = fwd & ~f_stopx & ((ns == st["s"]) | (ns >= thr))
        f_drop = fwd & ~f_stopx & ~take
        emit = (f_stopx | f_drop) & (i - st["start"] >= min_seed_len)

        # ---- BWD ----
        b_fail = bwd & ((j < 0) | (qj > 3) | (ns < thr))
        b_take = bwd & ~b_fail
        b_root = torch.where(b_fail, j + 1, st["start"])
        b_over = b_fail & (b_root > mid)     # next root past mid -> done

        vals = torch.stack([st["k"], st["l"], st["s"], st["start"].to(idt),
                            i.to(idt)], dim=-1)
        m5, mn, ovf = _emit(st, emit, vals, cap)

        new_mode = torch.where(f_stopx, DONE, mode)       # N/end: chain over
        new_mode = torch.where(f_drop, BWD, new_mode)
        new_mode = torch.where(b_fail, torch.where(b_over, DONE, FWD),
                               new_mode)

        new_i = torch.where(take, i + 1, i)
        new_i = torch.where(b_fail & ~b_over, st["e_anchor"], new_i)
        new_j = torch.where(f_drop, i - 1, torch.where(b_take, j - 1, j))
        new_start = torch.where(b_fail & ~b_over, b_root, st["start"])

        iv_drop = set_intv(di, torch.where(f_drop, qi, 0))
        new_k = torch.where(take, nk, st["k"])
        new_l = torch.where(take, nl, st["l"])
        new_s = torch.where(take, ns, st["s"])
        new_k = torch.where(b_fail, st["bk"], new_k)
        new_l = torch.where(b_fail, st["bl"], new_l)
        new_s = torch.where(b_fail, st["bs"], new_s)

        return dict(
            mode=new_mode, i=new_i, j=new_j, start=new_start,
            e_anchor=torch.where(f_drop, i + 1, st["e_anchor"]),
            k=new_k, l=new_l, s=new_s,
            bk=torch.where(f_drop, iv_drop.k,
                           torch.where(b_take, nk, st["bk"])),
            bl=torch.where(f_drop, iv_drop.l,
                           torch.where(b_take, nl, st["bl"])),
            bs=torch.where(f_drop, iv_drop.s,
                           torch.where(b_take, ns, st["bs"])),
            m5=m5, mn=mn, ovf=ovf,
        )

    return _result(_run_chain(step, st), cap)


def smem_round3_chain(di: DeviceIndex, q: torch.Tensor, lens: torch.Tensor,
                      min_seed_len: int = 19, max_mem_intv: int = 20,
                      cap: int = 64) -> Smems:
    """Round-3 chain: LAST-like forward-only restart seeding
    (fm_ref.seed_strategy1 restart loop), one lane per read."""
    B, L = q.shape
    dev = q.device
    idt = di.L2.dtype
    q = q.to(I32)
    lens = lens.to(I32)
    EXT3 = 1
    zB = torch.zeros(B, dtype=I32, device=dev)
    zK = torch.zeros(B, dtype=idt, device=dev)
    all_fwd = torch.ones(B, dtype=torch.bool, device=dev)
    st = dict(
        mode=torch.where(lens > 0, FRESH, DONE).to(I32),
        i=zB, x=zB, k=zK, l=zK, s=zK,
        m5=torch.zeros((B, cap + 1, 5), dtype=idt, device=dev),
        mn=zB, ovf=torch.zeros(B, dtype=torch.bool, device=dev),
    )

    def step(st):
        mode, i = st["mode"], st["i"]
        fresh = mode == FRESH
        ext3 = mode == EXT3
        qi = _take_q(q, i)
        nk, nl, ns = _mixed_ext(di, all_fwd, st["k"], st["l"], st["s"],
                                3 - qi.clamp(0, 3))

        # ---- FRESH ----
        f_end = fresh & (i >= lens)
        f_amb = fresh & ~f_end & (qi > 3)
        f_root = fresh & ~f_end & ~f_amb
        iv0 = set_intv(di, torch.where(f_root, qi, 0))

        # ---- EXT3 ----
        e_end = ext3 & (i >= lens)
        e_amb = ext3 & ~e_end & (qi > 3)
        can = ext3 & ~e_end & ~e_amb
        hit = can & (ns < max_mem_intv) & (i - st["x"] >= min_seed_len)
        found = hit & (ns > 0)
        adv = can & ~hit

        vals = torch.stack([nk, nl, ns, st["x"].to(idt), (i + 1).to(idt)],
                           dim=-1)
        m5, mn, ovf = _emit(st, found, vals, cap)

        new_mode = torch.where(f_end | e_end, DONE, mode)
        new_mode = torch.where(f_root, EXT3, new_mode)
        new_mode = torch.where(e_amb | hit, FRESH, new_mode)

        return dict(
            mode=new_mode,
            i=torch.where(f_amb | f_root | adv | e_amb | hit, i + 1, i),
            x=torch.where(f_root, i, st["x"]),
            k=torch.where(f_root, iv0.k, torch.where(adv, nk, st["k"])),
            l=torch.where(f_root, iv0.l, torch.where(adv, nl, st["l"])),
            s=torch.where(f_root, iv0.s, torch.where(adv, ns, st["s"])),
            m5=m5, mn=mn, ovf=ovf,
        )

    return _result(_run_chain(step, st), cap)


def _cores():
    """The chain entry points (``ops.smem_chain_cuda`` imports this
    module's plain versions, so it is imported at the call)."""
    from tpubwa_torch.ops import smem_chain_cuda

    return smem_chain_cuda


def _bulk_append(mems: Smems, mask: torch.Tensor, src: Smems,
                 out_cap: int) -> Smems:
    """Append masked [B, X] lanes of src (ascending lane order) to the
    [B, out_cap + 1] working buffers (column out_cap is the dump slot);
    overflow drops and sets the flag."""
    m32 = mask.to(I32)
    rank = torch.cumsum(m32, dim=1, dtype=I32) - m32
    dest = torch.where(mask, mems.n[:, None] + rank, out_cap)
    dest = dest.clamp(max=out_cap).to(torch.int64)

    def scat(buf, vals):
        return buf.scatter(1, dest, vals)

    n_added = (dest < out_cap).sum(dim=1, dtype=I32)
    dropped = (mask & (dest >= out_cap)).any(dim=1)
    return Smems(
        scat(mems.k, src.k), scat(mems.l, src.l), scat(mems.s, src.s),
        scat(mems.start, src.start), scat(mems.end, src.end),
        mems.n + n_added, mems.overflow | dropped | src.overflow)


def _smem_r1_prep(di: DeviceIndex, q: torch.Tensor, lens: torch.Tensor, *,
                  min_seed_len: int, split_len: int, split_width: int,
                  out_cap: int):
    """Stage 1: round-1 SMEMs appended into fresh output buffers + the
    round-2 candidate compaction table (read-major order) and the number
    of candidates (a tensor on the device)."""
    B, L = q.shape
    dev = q.device
    idt = di.L2.dtype
    zero_out = torch.zeros((B, out_cap + 1), dtype=idt, device=dev)
    slot_ids = torch.arange(out_cap, dtype=I32, device=dev)[None, :]
    mems = Smems(k=zero_out, l=zero_out, s=zero_out, start=zero_out,
                 end=zero_out, n=torch.zeros(B, dtype=I32, device=dev),
                 overflow=torch.zeros(B, dtype=torch.bool, device=dev))
    r1 = _cores().smem_round1_core(di, q, lens, min_seed_len=min_seed_len,
                                   cap=out_cap)
    m1 = slot_ids < r1.n[:, None]
    mems = _bulk_append(mems, m1, r1, out_cap)

    cand = m1 & ((r1.end - r1.start) >= split_len) & (r1.s <= split_width)
    NC = B * out_cap
    flat_cand = cand.reshape(NC)
    fc = flat_cand.to(I32)
    grank = torch.cumsum(fc, dim=0, dtype=I32) - fc
    src_tab = torch.zeros(NC + 1, dtype=I32, device=dev).scatter(
        0, torch.where(flat_cand, grank, NC).to(torch.int64),
        torch.arange(NC, dtype=I32, device=dev))[:NC]
    return (mems, src_tab, r1.start.reshape(NC), r1.end.reshape(NC),
            r1.s.reshape(NC), fc.sum())


def _r2_lanes(src_tab, r1_start, r1_end, r1_s, total: int, w: int, *,
              out_cap: int, G: int):
    """The G chain lanes of round-2 wave w: (rd, mid, thr, act) = read
    row, middle position, occ threshold (the candidate's occurrences + 1)
    and whether the lane holds a candidate."""
    NC = src_tab.shape[0]
    gidx = w * G + torch.arange(G, dtype=I32, device=src_tab.device)
    act = gidx < total
    sf = src_tab[gidx.clamp(max=NC - 1)]
    rd = sf // out_cap
    mid = torch.where(act, ((r1_start[sf] + r1_end[sf]) >> 1).to(I32), 0)
    thr = torch.where(act, r1_s[sf] + 1, 1)
    return rd, mid, thr, act


def _smem_r2_wave(di: DeviceIndex, q: torch.Tensor, lens: torch.Tensor,
                  mems: Smems, src_tab, r1_start, r1_end, r1_s, total: int,
                  w: int, *, min_seed_len: int, r2_cap: int, out_cap: int,
                  G: int) -> Smems:
    """Stage 2 (one wave of G lanes): round-2 through-chains for candidates
    [w*G, (w+1)*G) with segmented append into the output buffers."""
    B = q.shape[0]
    dev = q.device
    e_ids = torch.arange(r2_cap, dtype=I32, device=dev)[None, :]
    rd, mid, thr, act = _r2_lanes(src_tab, r1_start, r1_end, r1_s, total, w,
                                  out_cap=out_cap, G=G)
    sub = _cores().smem_through_core(di, q, lens, rd, mid, thr, act,
                                     min_seed_len=min_seed_len, cap=r2_cap)
    # segmented append: lanes of one read are consecutive, so each
    # lane's write base is (emissions of earlier same-read lanes)
    en = torch.where(act, sub.n, 0)
    before = torch.cumsum(en, dim=0, dtype=I32) - en
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       rd[1:] != rd[:-1]])
    base = torch.cummax(torch.where(first, before, -1), dim=0).values
    off = before - base
    emask = act[:, None] & (e_ids < sub.n[:, None])
    dest_u = mems.n[rd][:, None] + off[:, None] + e_ids
    ok = emask & (dest_u < out_cap)
    dest = torch.where(ok, dest_u, out_cap).to(torch.int64)
    rows = rd[:, None].expand_as(dest).to(torch.int64)

    def scat(buf, vals):
        return buf.index_put((rows, dest), vals)

    rd64 = rd.to(torch.int64)
    n_add = torch.zeros(B, dtype=I32, device=dev).index_add_(
        0, rd64, ok.sum(dim=1, dtype=I32))
    drop = torch.zeros(B, dtype=I32, device=dev).scatter_reduce(
        0, rd64, ((emask & ~ok).any(dim=1) | sub.overflow).to(I32), "amax")
    return Smems(
        scat(mems.k, sub.k), scat(mems.l, sub.l), scat(mems.s, sub.s),
        scat(mems.start, sub.start), scat(mems.end, sub.end),
        mems.n + n_add, mems.overflow | (drop > 0))


def _smem_r2_loop(di: DeviceIndex, q: torch.Tensor, lens: torch.Tensor,
                  mems: Smems, src_tab, r1_start, r1_end, r1_s, total: int,
                  *, min_seed_len: int, r2_cap: int, out_cap: int,
                  G: int) -> Smems:
    """Stage 2: all round-2 waves of G lanes."""
    w = 0
    while w * G < total:
        mems = _smem_r2_wave(
            di, q, lens, mems, src_tab, r1_start, r1_end, r1_s, total, w,
            min_seed_len=min_seed_len, r2_cap=r2_cap, out_cap=out_cap, G=G)
        w += 1
    return mems


def _r3_append(mems: Smems, r3: Smems, out_cap: int) -> Smems:
    """Append round-3 emissions into the output buffers."""
    slot_ids = torch.arange(out_cap, dtype=I32, device=r3.n.device)
    return _bulk_append(mems, slot_ids[None, :] < r3.n[:, None], r3,
                        out_cap)


def _sort_by_start_end(mems: Smems, L: int, out_cap: int) -> Smems:
    """Per-read (start, end) sort of the used slots (a stable sort: the
    JAX package's bitonic network is not, but tied keys name the same
    SMEM and so carry equal payloads)."""
    slot_ids = torch.arange(out_cap, dtype=I32, device=mems.n.device)
    cut = [a[:, :out_cap] for a in mems[:5]]
    in_use = slot_ids[None, :] < mems.n[:, None]
    key = torch.where(in_use, cut[3] * (L + 2) + cut[4], BIG)
    order = torch.sort(key, dim=1, stable=True).indices
    return Smems(*(a.gather(1, order) for a in cut), mems.n, mems.overflow)


def collect_smems_chain(di: DeviceIndex, q: torch.Tensor, lens: torch.Tensor,
                        min_seed_len: int = 19, split_len: int = 28,
                        split_width: int = 10, max_mem_intv: int = 20,
                        out_cap: int = 64, r2_lanes: int | None = None,
                        r2_cap: int = 32) -> Smems:
    """Full 3-round SMEM collection (fm_ref.collect_smems semantics) built
    from the chain engines.  Output sorted by (start, end) per read.

    Round-2 candidates are compacted globally (read-major order) into waves
    of `r2_lanes` chain lanes, so lane count tracks the actual candidate
    load instead of a per-read worst case."""
    return collect_smems_mesh(
        [di], [q], [lens], min_seed_len=min_seed_len, split_len=split_len,
        split_width=split_width, max_mem_intv=max_mem_intv, out_cap=out_cap,
        r2_lanes=r2_lanes, r2_cap=r2_cap)[0]


def collect_smems_chain_fused(di: DeviceIndex, q: torch.Tensor,
                              lens: torch.Tensor, **kw) -> Smems:
    """``collect_smems_chain`` under the name of the JAX package's one-
    program variant, which ``parallel.mesh.device_align_step`` calls.
    JAX split the collection into staged programs only for the TPU
    compiler's sake and kept this fused one for the small demo step; on
    a torch device both are the same calls, bit for bit."""
    return collect_smems_chain(di, q, lens, **kw)


def collect_smems_mesh(dis: list, qs: list, lenss: list, *,
                       min_seed_len: int = 19, split_len: int = 28,
                       split_width: int = 10, max_mem_intv: int = 20,
                       out_cap: int = 64, r2_lanes: int | None = None,
                       r2_cap: int = 32) -> list:
    """``collect_smems_chain`` for several read slices, slice d on the
    device of ``dis[d]``; returns one Smems a slice.  Each stage is issued
    on every slice before the next: round 1 everywhere, then the round-2
    candidate counts read on the host (the one wait), then rounds 2 and 3
    everywhere, so the devices of a mesh work at once."""
    qs = [q.to(I32) for q in qs]
    lenss = [lens.to(I32) for lens in lenss]
    preps = [_smem_r1_prep(di, q, lens, min_seed_len=min_seed_len,
                           split_len=split_len, split_width=split_width,
                           out_cap=out_cap)
             for di, q, lens in zip(dis, qs, lenss)]
    totals = [int(p[5]) for p in preps]
    out = []
    for di, q, lens, prep, total in zip(dis, qs, lenss, preps, totals):
        B, L = q.shape
        mems = _smem_r2_loop(
            di, q, lens, *prep[:5], total, min_seed_len=min_seed_len,
            r2_cap=r2_cap, out_cap=out_cap,
            G=2 * B if r2_lanes is None else r2_lanes)
        if max_mem_intv > 0:
            r3 = _cores().smem_round3_core(
                di, q, lens, min_seed_len=min_seed_len,
                max_mem_intv=max_mem_intv, cap=out_cap)
            mems = _r3_append(mems, r3, out_cap)
        out.append(_sort_by_start_end(mems, L, out_cap))
    return out
