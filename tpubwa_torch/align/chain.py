"""Seed chaining + chain filtering (host side; port of
``tpubwa.align.chain``).

Semantics of bwa-mem's mem_chain / mem_chain_flt (reference call stack:
SURVEY.md §3.1 worker_aln → mem_chain_seeds; the reference's O(n²) chain DP
noted in §2.1 "Core algorithm").  Seeds arrive in SMEM-sorted order (sorted
intervals, SA samples ascending within each); each seed is tested for merge
against the single existing chain with the largest anchor position <= its
rbeg, else it opens a new chain.

Per-read Python here is the correctness reference (``chain_read`` +
``filter_chains``); ``chain_filter_batch_native`` runs the same semantics
for a whole batch in the native library (``native/chain.cpp``), which
``Aligner.chain_batch`` calls.  There is no fallback: a native library
that cannot be built raises.
"""
from __future__ import annotations

import bisect
import ctypes
import dataclasses

import numpy as np

from tpubwa_torch.config import MemOptions
from tpubwa_torch.native import load_native


@dataclasses.dataclass
class Seed:
    rbeg: int
    qbeg: int
    len: int
    score: int


@dataclasses.dataclass
class Chain:
    pos: int                      # anchor: rbeg of the founding seed
    rid: int
    seeds: list[Seed]
    w: int = 0                    # weight (set by filter)
    kept: int = 0
    first: int = -1
    frac_rep: float = 0.0

    @property
    def qbeg(self) -> int:
        return self.seeds[0].qbeg

    @property
    def qend(self) -> int:
        return self.seeds[-1].qbeg + self.seeds[-1].len


def _test_and_merge(opt: MemOptions, l_pac: int, c: Chain, s: Seed,
                    seed_rid: int) -> bool:
    """Try to merge seed s into chain c (bwa test_and_merge)."""
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return False
    if (s.qbeg >= c.seeds[0].qbeg and s.qbeg + s.len <= qend
            and s.rbeg >= c.seeds[0].rbeg and s.rbeg + s.len <= rend):
        return True  # contained seed; do nothing
    if ((last.rbeg < l_pac or c.seeds[0].rbeg < l_pac)
            and s.rbeg >= l_pac):
        return False  # don't chain across strands
    x = s.qbeg - last.qbeg  # non-negative (seeds sorted by qbeg)
    y = s.rbeg - last.rbeg
    if (y >= 0 and x - y <= opt.w and y - x <= opt.w
            and x - last.len < opt.max_chain_gap
            and y - last.len < opt.max_chain_gap):
        c.seeds.append(s)
        return True
    return False


def pos_to_rid(contig_offsets: np.ndarray, l_pac: int, pos: int) -> int:
    if pos < 0 or pos >= l_pac:
        return -1
    return int(np.searchsorted(contig_offsets, pos, side="right") - 1)


def intv_to_rid(contig_offsets: np.ndarray, l_pac: int, rb: int,
                re: int) -> int:
    """Contig id of [rb, re) in 2*l_pac space; negative if it bridges the
    strand boundary or spans two contigs (bns_intv2rid semantics)."""
    if rb < l_pac and re > l_pac:
        return -2
    b, e = rb, re - 1
    if rb >= l_pac:  # reverse strand -> forward coords
        b = 2 * l_pac - 1 - (re - 1)
        e = 2 * l_pac - 1 - rb
    rid_b = pos_to_rid(contig_offsets, l_pac, b)
    rid_e = pos_to_rid(contig_offsets, l_pac, e)
    return rid_b if rid_b == rid_e else -1


def chain_read(opt: MemOptions, l_pac: int, contig_offsets: np.ndarray,
               seeds: list[Seed], l_query: int, l_rep: int) -> list[Chain]:
    """Build chains from seeds (in SMEM order).  Returns chains sorted by
    anchor pos ascending (btree traversal order)."""
    chains: list[Chain] = []
    keys: list[int] = []  # chain anchor positions, sorted
    frac_rep = l_rep / l_query if l_query else 0.0
    for s in seeds:
        rid = intv_to_rid(contig_offsets, l_pac, s.rbeg, s.rbeg + s.len)
        if rid < 0:
            continue
        merged = False
        if keys:
            # chain with the largest anchor <= s.rbeg
            j = bisect.bisect_right(keys, s.rbeg) - 1
            if j >= 0:
                merged = _test_and_merge(opt, l_pac, chains[j], s, rid)
        if not merged:
            j = bisect.bisect_right(keys, s.rbeg)
            keys.insert(j, s.rbeg)
            chains.insert(j, Chain(pos=s.rbeg, rid=rid, seeds=[s],
                                   frac_rep=frac_rep))
    return chains


@dataclasses.dataclass
class ChainBatch:
    """Kept chains of a whole read batch, as flat arrays (native fast path
    output).  Chains appear grouped by read, in filter order (weight
    descending) within each read."""

    read: np.ndarray      # int32 [n_chains] read index within the batch
    rid: np.ndarray       # int32 [n_chains]
    w: np.ndarray         # int32 [n_chains] chain weight
    off: np.ndarray       # int64 [n_chains + 1] into `seeds`
    seeds: np.ndarray     # int64 [m, 3] (rbeg, qbeg, len), chain order

    @property
    def n(self) -> int:
        return len(self.read)

    def to_lists(self, n_reads: int, l_rep: np.ndarray,
                 lens: np.ndarray) -> list[list[Chain]]:
        """Expand to the list[list[Chain]] object form (compat/tests)."""
        out: list[list[Chain]] = [[] for _ in range(n_reads)]
        for c in range(self.n):
            b = int(self.read[c])
            seeds = [Seed(int(r[0]), int(r[1]), int(r[2]), int(r[2]))
                     for r in self.seeds[self.off[c]:self.off[c + 1]]]
            fr = float(l_rep[b]) / float(lens[b]) if lens[b] else 0.0
            out[b].append(Chain(pos=seeds[0].rbeg, rid=int(self.rid[c]),
                                seeds=seeds, w=int(self.w[c]), frac_rep=fr))
        return out


def chain_filter_batch_native(opt: MemOptions, l_pac: int,
                              contig_offsets: np.ndarray,
                              seed_rows: np.ndarray, bounds: np.ndarray,
                              skip: np.ndarray) -> ChainBatch:
    """Chain + filter a whole batch in one native call (native/chain.cpp).
    Raises RuntimeError when the native library cannot be built."""
    lib = load_native()
    seed_rows = np.ascontiguousarray(seed_rows, dtype=np.int64)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    skip = np.ascontiguousarray(skip, dtype=np.uint8)
    offs = np.ascontiguousarray(contig_offsets, dtype=np.int64)
    n_seeds = len(seed_rows)
    n_reads = len(bounds) - 1
    cap = max(n_seeds, 1)
    chain_read_a = np.empty(cap, np.int32)
    chain_rid = np.empty(cap, np.int32)
    chain_w = np.empty(cap, np.int32)
    chain_off = np.empty(cap + 1, np.int64)
    seed_idx = np.empty(max(n_seeds, 1), np.int64)
    counts = np.zeros(2, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.chain_filter_batch(
        seed_rows.ctypes.data_as(i64p), n_seeds,
        bounds.ctypes.data_as(i64p), n_reads,
        skip.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(i64p), len(offs), l_pac,
        opt.w, opt.max_chain_gap, opt.min_chain_weight,
        opt.max_chain_extend, opt.mask_level, opt.drop_ratio,
        opt.min_seed_len,
        chain_read_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        chain_rid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        chain_w.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        chain_off.ctypes.data_as(i64p),
        seed_idx.ctypes.data_as(i64p), cap,
        counts.ctypes.data_as(i64p))
    if rc != 0:
        raise RuntimeError("chain_filter_batch capacity exceeded")
    nc, ns = int(counts[0]), int(counts[1])
    return ChainBatch(
        read=chain_read_a[:nc], rid=chain_rid[:nc], w=chain_w[:nc],
        off=chain_off[:nc + 1].copy(),
        seeds=seed_rows[seed_idx[:ns]][:, 1:4])


def chain_weight(c: Chain) -> int:
    """min(query coverage, reference coverage) of the chain's seeds."""
    w_q = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w_q += s.len
        elif s.qbeg + s.len > end:
            w_q += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    w_r = 0
    end = 0
    for s in sorted(c.seeds, key=lambda t: t.rbeg):
        if s.rbeg >= end:
            w_r += s.len
        elif s.rbeg + s.len > end:
            w_r += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    return min(min(w_q, w_r), (1 << 30) - 1)


def filter_chains(opt: MemOptions, chains: list[Chain]) -> list[Chain]:
    """Drop shadowed/weak chains (mem_chain_flt semantics)."""
    if not chains:
        return []
    for c in chains:
        c.first = -1
        c.kept = 0
        c.w = chain_weight(c)
    chains = [c for c in chains if c.w >= opt.min_chain_weight]
    if not chains:
        return []
    # stable sort by weight desc (ties keep pos order)
    chains.sort(key=lambda c: -c.w)
    chains[0].kept = 3
    kept_idx = [0]
    for i in range(1, len(chains)):
        c = chains[i]
        large_ovlp = False
        drop = False
        for j in kept_idx:
            cj = chains[j]
            b_max = max(cj.qbeg, c.qbeg)
            e_min = min(cj.qend, c.qend)
            if e_min > b_max:  # overlap on the query
                li = c.qend - c.qbeg
                lj = cj.qend - cj.qbeg
                min_l = min(li, lj)
                if (e_min - b_max >= min_l * opt.mask_level
                        and min_l < opt.max_chain_gap):
                    large_ovlp = True
                    if cj.first < 0:
                        cj.first = i
                    if (c.w < cj.w * opt.drop_ratio
                            and cj.w - c.w >= opt.min_seed_len * 2):
                        drop = True
                        break
        if not drop:
            kept_idx.append(i)
            c.kept = 2 if large_ovlp else 3
    for j in kept_idx:
        f = chains[j].first
        if f >= 0:
            chains[f].kept = 1
    # cap the number of kept==1/2 chains at max_chain_extend
    k = 0
    stop_i = len(chains)
    for i, c in enumerate(chains):
        if c.kept == 0 or c.kept == 3:
            continue
        k += 1
        if k >= opt.max_chain_extend:
            stop_i = i
            break
    for i in range(stop_i + 1, len(chains)):
        if chains[i].kept < 3:
            chains[i].kept = 0
    return [c for c in chains if c.kept > 0]
