"""Scalar host reference for FM search + SMEM seeding (NumPy, one read at a
time; port of ``tpubwa.ops.fm_ref``).

This module DEFINES the framework's seeding semantics (the algorithm of
bwa-mem's SMEM generation, re-stated; reference call stack: SURVEY.md §3.1
worker_bwt → mem_collect_intv → getSMEMs/bwt_smem1 → backward-search loop).
The batched collector (``ops.smem_chain.collect_smems_chain``: K2 on a
CUDA device, its plain version on the CPU) is held to this for exact
equality by the tests and by ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from tpubwa_torch.index.fmindex import FMIndex


@dataclasses.dataclass
class Intv:
    k: int
    l: int
    s: int
    start: int  # query start (inclusive)
    end: int    # query end (exclusive)


def set_intv(idx: FMIndex, c: int) -> tuple[int, int, int]:
    L2 = idx.L2
    return int(L2[c]), int(L2[3 - c]), int(L2[c + 1] - L2[c])


def backward_ext_all(idx: FMIndex, k: int, l: int, s: int,
                     is_back: bool) -> list[tuple[int, int, int]]:
    """(k,l,s) for each base 0..3.

    is_back=True: entry [c] is the interval of pattern c·P (prepend c).
    is_back=False: entry [c] is the interval of P·comp(c) — i.e. to APPEND
    base b, read entry [3-b] (same convention as the classic bidirectional
    extension; callers pass the complement)."""
    kk, ll = (k, l) if is_back else (l, k)
    occ_k = [idx.occ_full(c, kk) for c in range(4)]
    occ_ks = [idx.occ_full(c, kk + s) for c in range(4)]
    s_b = [occ_ks[c] - occ_k[c] for c in range(4)]
    k_b = [int(idx.L2[c]) + occ_k[c] for c in range(4)]
    sent = 1 if kk <= idx.primary < kk + s else 0
    l_b = [0, 0, 0, 0]
    l_b[3] = ll + sent
    l_b[2] = l_b[3] + s_b[3]
    l_b[1] = l_b[2] + s_b[2]
    l_b[0] = l_b[1] + s_b[1]
    if is_back:
        return [(k_b[c], l_b[c], s_b[c]) for c in range(4)]
    return [(l_b[c], k_b[c], s_b[c]) for c in range(4)]


def smem1(idx: FMIndex, q: np.ndarray, length: int, x: int,
          min_intv: int, max_intv: int = 0) -> tuple[int, list[Intv]]:
    """All SMEMs through position x.  Returns (next_x, mems sorted by start).

    min_intv: only report matches with >= min_intv occurrences.
    max_intv > 0: stop forward extension once the interval is smaller than
    max_intv and skip backward refinement of such small intervals.
    """
    if q[x] > 3:
        return x + 1, []
    min_intv = max(min_intv, 1)
    k, l, s = set_intv(idx, int(q[x]))
    ik = Intv(k, l, s, x, x + 1)

    curr: list[Intv] = []
    i = x + 1
    while i < length:
        if max_intv > 0 and ik.s < max_intv:
            curr.append(ik)
            break
        if q[i] < 4:
            c = 3 - int(q[i])
            ext = backward_ext_all(idx, ik.k, ik.l, ik.s, is_back=False)
            nk, nl, ns = ext[c]
            if ns != ik.s:
                curr.append(ik)
                if ns < min_intv:
                    break
            ik = Intv(nk, nl, ns, x, i + 1)
        else:
            curr.append(ik)
            break
        i += 1
    else:
        curr.append(ik)
    curr.reverse()  # longest match (smallest interval) first
    ret = curr[0].end

    mems: list[Intv] = []
    prev = curr
    i = x - 1
    while i >= -1:
        c = -1 if i < 0 or q[i] > 3 else int(q[i])
        nxt: list[Intv] = []
        for p in prev:
            ext = None
            if c >= 0 and not (max_intv > 0 and p.s < max_intv):
                ext = backward_ext_all(idx, p.k, p.l, p.s, is_back=True)
            if ext is None or ext[c][2] < min_intv:
                if not nxt:  # no longer match survives at this i
                    if not mems or i + 1 < mems[-1].start:
                        mems.append(Intv(p.k, p.l, p.s, i + 1, p.end))
            elif not nxt or ext[c][2] != nxt[-1].s:
                nk, nl, ns = ext[c]
                nxt.append(Intv(nk, nl, ns, p.start, p.end))
        if not nxt:
            break
        prev = nxt
        i -= 1
    mems.reverse()  # ascending start
    return ret, mems


def seed_strategy1(idx: FMIndex, q: np.ndarray, length: int, x: int,
                   min_len: int, max_intv: int) -> tuple[int, Intv | None]:
    """3rd-round (LAST-like) forward-only seeding: the first interval along
    the forward extension from x that drops below max_intv occurrences, if
    at least min_len long."""
    if q[x] > 3:
        return x + 1, None
    k, l, s = set_intv(idx, int(q[x]))
    ik = Intv(k, l, s, x, x + 1)
    for i in range(x + 1, length):
        if q[i] < 4:
            c = 3 - int(q[i])
            ext = backward_ext_all(idx, ik.k, ik.l, ik.s, is_back=False)
            nk, nl, ns = ext[c]
            if ns < max_intv and i - x >= min_len:
                if ns > 0:
                    return i + 1, Intv(nk, nl, ns, x, i + 1)
                return i + 1, None
            ik = Intv(nk, nl, ns, x, i + 1)
        else:
            return i + 1, None
    return length, None


def collect_smems(idx: FMIndex, q: np.ndarray, length: int,
                  min_seed_len: int = 19, split_len: int = 28,
                  split_width: int = 10, max_mem_intv: int = 20
                  ) -> list[Intv]:
    """Full 3-round SMEM collection for one read (mem_collect_intv
    semantics), sorted by (start, end)."""
    mems: list[Intv] = []
    # round 1: all SMEMs
    x = 0
    while x < length:
        if q[x] < 4:
            x, m1 = smem1(idx, q, length, x, 1)
            mems.extend(p for p in m1 if p.end - p.start >= min_seed_len)
        else:
            x += 1
    # round 2: re-seed long, low-occ SMEMs from their middle
    old = list(mems)
    for p in old:
        if p.end - p.start < split_len or p.s > split_width:
            continue
        _, m1 = smem1(idx, q, length, (p.start + p.end) >> 1, p.s + 1)
        mems.extend(m for m in m1 if m.end - m.start >= min_seed_len)
    # round 3: LAST-like forward-only seeding
    if max_mem_intv > 0:
        x = 0
        while x < length:
            if q[x] < 4:
                x, m = seed_strategy1(idx, q, length, x, min_seed_len,
                                      max_mem_intv)
                if m is not None:
                    mems.append(m)
            else:
                x += 1
    mems.sort(key=lambda p: (p.start, p.end))
    return mems
