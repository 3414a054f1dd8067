"""Paired-end pipeline: insert-size estimation, pair scoring, mate rescue,
paired SAM emission (port of ``tpubwa.align.pair``).

Semantics of bwa-mem's bwamem_pair.c: mem_pestat percentile insert-size
model per orientation (FF/FR/RF/RR), mem_pair best-pair selection with
the erfc insert-size log-likelihood term, and mem_matesw mate rescue —
batched: ``rescue_batch`` builds a batch's rescue jobs natively and runs
them through ``ops.localsw_cuda.localsw_core`` in two rounds on the
aligner's device (``matesw_gen`` + ``run_matesw_rounds``, one generator
an anchor, are its reference).  On a device mesh both ends'
seeding and extension waves are split over the shards; mate rescue and
the SAM's CIGAR program run on the mesh's first device.

The host helpers are carried over from the JAX package (its module
imports jax through ``tpubwa.align.finalize``), changed only in their
imports; the device calls run on torch tensors.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import operator
import sys

import numpy as np
import torch

from tpubwa_torch.align import finalize, flatsam
from tpubwa_torch.align.region import AlnReg
from tpubwa_torch.config import NARROW, MemOptions, batch_widths
from tpubwa_torch.index.fmindex import FMIndex
from tpubwa_torch.io import sam as samio
from tpubwa_torch.native import as_ptr, load_native
from tpubwa_torch.ops.localsw_cuda import localsw_core
from tpubwa_torch.utils.rounds import drive_rounds
from tpubwa_torch.utils.timers import count

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0
M_SQRT1_2 = 1.0 / math.sqrt(2.0)


@dataclasses.dataclass
class PEStat:
    low: int = 0
    high: int = 0
    avg: float = 0.0
    std: float = 0.0
    failed: bool = True


def infer_dir(l_pac: int, b1: int, b2: int) -> tuple[int, int]:
    """(dist, dir) with dir 0=FF 1=FR 2=RF 3=RR (mem_infer_dir)."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    d = (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3)
    return abs(p2 - b1), d


def cal_sub(opt: MemOptions, regs: list[AlnReg]) -> int:
    for j in range(1, len(regs)):
        b_max = max(regs[j].qb, regs[0].qb)
        e_min = min(regs[j].qe, regs[0].qe)
        if e_min > b_max:
            min_l = min(regs[j].qe - regs[j].qb, regs[0].qe - regs[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return regs[j].score
    return opt.min_seed_len * opt.a


def pestat(opt: MemOptions, l_pac: int,
           reg_pairs: list[tuple[list[AlnReg], list[AlnReg]]]
           ) -> list[PEStat]:
    """mem_pestat: infer the insert-size distribution per orientation from
    confidently, uniquely mapped pairs."""
    isize = [[], [], [], []]
    for r0, r1 in reg_pairs:
        if not r0 or not r1:
            continue
        if cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        dist, d = infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if 0 < dist <= opt.max_ins:
            isize[d].append(dist)
    pes = [PEStat() for _ in range(4)]
    max_cnt = max(len(x) for x in isize)
    for d in range(4):
        q = sorted(isize[d])
        r = pes[d]
        if len(q) < MIN_DIR_CNT or len(q) < MIN_DIR_RATIO * max_cnt:
            continue
        p25 = q[int(0.25 * len(q) + 0.499)]
        p50 = q[int(0.50 * len(q) + 0.499)]
        p75 = q[int(0.75 * len(q) + 0.499)]
        low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499), 1)
        high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        vals = [x for x in q if low <= x <= high]
        if not vals:
            continue
        avg = sum(vals) / len(vals)
        std = math.sqrt(sum((x - avg) ** 2 for x in vals) / len(vals))
        r.avg, r.std = avg, std
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        if r.low > avg - MAX_STDDEV * std:
            r.low = int(avg - MAX_STDDEV * std + 0.499)
        if r.high < avg + MAX_STDDEV * std:
            r.high = int(avg + MAX_STDDEV * std + 0.499)
        r.low = max(r.low, 1)
        r.failed = False
        print(f"[tpu-bwa][PE] dir {'FF FR RF RR'.split()[d]}: n={len(q)} "
              f"p50={p50} avg={avg:.2f} std={std:.2f} "
              f"low={r.low} high={r.high}", file=sys.stderr)
    return pes


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + 0.499)


def mem_pair(opt: MemOptions, idx: FMIndex, pes: list[PEStat],
             regs: tuple[list[AlnReg], list[AlnReg]], pair_id: int
             ) -> tuple[int, int, int, list[int]]:
    """Best proper pair (o, subo, n_sub, z[2]); o == 0 means none."""
    l_pac = idx.l_pac
    v = []
    for r in range(2):
        for i, e in enumerate(regs[r]):
            fwd = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            x = (e.rid << 32) | int(fwd - idx.contigs[e.rid].offset)
            y = (e.score << 32) | (i << 2) | ((e.rb >= l_pac) << 1) | r
            v.append((x, y))
    v.sort()
    y_last = [-1, -1, -1, -1]
    u = []
    for i in range(len(v)):
        for r in range(2):
            d = (r << 1) | ((v[i][1] >> 1) & 1)
            if pes[d].failed:
                continue
            which = (r << 1) | ((v[i][1] & 1) ^ 1)
            if y_last[which] < 0:
                continue
            for k in range(y_last[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[d].high:
                    break
                if dist < pes[d].low:
                    continue
                ns = (dist - pes[d].avg) / pes[d].std
                q = int((v[i][1] >> 32) + (v[k][1] >> 32)
                        + 0.721 * math.log(
                            2.0 * math.erfc(abs(ns) * M_SQRT1_2)) * opt.a
                        + 0.499)
                q = max(q, 0)
                pair_y = (k << 32) | i
                h = finalize.hash_64(
                    (pair_y ^ (pair_id << 8)) & ((1 << 64) - 1)) & 0xFFFFFFFF
                u.append(((q << 32) | h, pair_y))
        y_last[v[i][1] & 3] = i
    if not u:
        return 0, 0, 0, [0, 0]
    u.sort()
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    best_x, best_y = u[-1]
    i = best_y >> 32
    k = best_y & 0xFFFFFFFF
    z = [0, 0]
    z[v[i][1] & 1] = (v[i][1] >> 2) & 0x3FFFFFFF
    z[v[k][1] & 1] = (v[k][1] >> 2) & 0x3FFFFFFF
    o = best_x >> 32
    sub = (u[-2][0] >> 32) if len(u) > 1 else 0
    n_sub = sum(1 for x, _ in u[:-1] if (x >> 32) >= o - tmp)
    return o, sub, n_sub, z


# ---------------------------------------------------------- mate rescue ----

@dataclasses.dataclass
class SWJob:
    query: np.ndarray
    target: np.ndarray
    minsc: int
    endsc: int


def matesw_gen(opt: MemOptions, idx: FMIndex, pes: list[PEStat],
               a: AlnReg, l_ms: int, ms: np.ndarray, ma: list[AlnReg]):
    """Generator for one anchor region: yields SWJob, expects LocalSW result
    tuples (score, te, qe, score2); inserts rescued regions into ma.
    Returns the number of rescue attempts performed."""
    l_pac = idx.l_pac
    skip = [p.failed for p in pes]
    for reg in ma:
        dist, r = infer_dir(l_pac, a.rb, reg.rb)
        if pes[r].low <= dist <= pes[r].high:
            skip[r] = True
    if all(skip):
        return 0
    n = 0
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            seq = np.where(ms < 4, 3 - ms, 4)[::-1].astype(np.uint8)
        else:
            seq = ms
        if not is_rev:
            rb = a.rb + pes[r].low if is_larger else a.rb - pes[r].high
            re = (a.rb + pes[r].high if is_larger
                  else a.rb - pes[r].low) + l_ms
        else:
            rb = (a.rb + pes[r].low if is_larger
                  else a.rb - pes[r].high) - l_ms
            re = a.rb + pes[r].high if is_larger else a.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        if rb >= re:
            continue
        # trim [rb, re) to the contig (and strand half) containing mid
        mid = (rb + re) >> 1
        m_rev = mid >= l_pac
        fwd_mid = (l_pac << 1) - 1 - mid if m_rev else mid
        rid = idx.pos_to_rid(fwd_mid)
        far_beg = idx.contigs[rid].offset
        far_end = far_beg + idx.contigs[rid].length
        if m_rev:
            far_beg, far_end = ((l_pac << 1) - far_end,
                                (l_pac << 1) - idx.contigs[rid].offset)
        rb = max(rb, far_beg)
        re = min(re, far_end)
        if a.rid == rid and re - rb >= opt.min_seed_len:
            ref = idx.fetch_ref(rb, re)
            minsc = opt.min_seed_len * opt.a
            res = yield SWJob(seq, ref, minsc, 1 << 30)
            score, te, qe, score2 = res
            if score >= opt.min_seed_len and qe >= 0:
                res2 = yield SWJob(seq[: qe + 1][::-1].copy(),
                                   ref[: te + 1][::-1].copy(), minsc, score)
                _, te2, qe2, _ = res2
                qb = qe - qe2
                tb = te - te2
                b = AlnReg()
                b.rid = a.rid
                b.qb = l_ms - (qe + 1) if is_rev else qb
                b.qe = l_ms - qb if is_rev else qe + 1
                b.rb = ((l_pac << 1) - (rb + te + 1)) if is_rev else rb + tb
                b.re = ((l_pac << 1) - (rb + tb)) if is_rev else rb + te + 1
                b.score = score
                b.truesc = score
                b.csub = score2
                b.secondary = -1
                b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
                b.w = opt.w
                b.frac_rep = a.frac_rep
                # insert keeping ma sorted by score desc
                pos = len(ma)
                for i2 in range(len(ma)):
                    if ma[i2].score < b.score:
                        pos = i2
                        break
                ma.insert(pos, b)
            n += 1
        # bwa's mem_matesw breaks after the FIRST direction in which a
        # rescue SW was *performed* (its ++n counts attempts, successful or
        # not, and `if (n) break;` follows — "if haven't found any hit, go
        # through other directions").  Directions that never reach the SW
        # (off-contig window, window shorter than min_seed_len) fall through
        # to later orientations.  Pinned by
        # tests/test_matesw.py::test_matesw_falls_through_unattempted_dirs.
        if n:
            break
    return n


def run_matesw_rounds(opt: MemOptions, gens: list, mat: torch.Tensor,
                      q_pad: int = NARROW.rescue_q,
                      t_pad: int = NARROW.rescue_t, timers=None) -> int:
    """Drive rescue generators in lockstep batched rounds on the device
    of `mat` (the [5, 5] scoring matrix as a tensor).  Queries are cut
    to q_pad and targets to t_pad codes (the batch's bucket's
    ``rescue_q``, ``rescue_t``): the truncation is part of the output,
    and each job it cuts counts one ``pair.rescue_truncated`` in
    `timers`.  Each round uploads one buffer and downloads one [4, B]
    result.  Returns the number of rescue SWs performed."""
    n_gen = len(gens)
    pending: list[SWJob | None] = [None] * n_gen
    live = set()
    total = 0
    for i, g in enumerate(gens):
        try:
            pending[i] = next(g)
            live.add(i)
        except StopIteration as e:
            total += e.value or 0
    while live:
        idxs = sorted(live)
        B = len(idxs)
        t_max = max(min(len(pending[i].target), t_pad) for i in idxs)
        t_b = 256 if t_max <= 256 else t_pad
        # one host buffer: query | target | qlen tlen minsc endsc
        buf = np.full((B, q_pad + t_b + 4), 4, np.int32)
        cut = 0
        for r, i in enumerate(idxs):
            job = pending[i]
            nq = min(len(job.query), q_pad)
            nt = min(len(job.target), t_b)
            cut += nq < len(job.query) or nt < len(job.target)
            buf[r, :nq] = job.query[:nq]
            buf[r, q_pad:q_pad + nt] = job.target[:nt]
            buf[r, q_pad + t_b:] = (nq, nt, job.minsc, job.endsc)
        if cut:
            count(timers, "pair.rescue_truncated", cut)
        packed = _rescue_round(opt, buf, q_pad, t_b, mat)
        for r, i in enumerate(idxs):
            tup = (int(packed[0, r]), int(packed[1, r]), int(packed[2, r]),
                   int(packed[3, r]))
            try:
                pending[i] = gens[i].send(tup)
            except StopIteration as e:
                total += e.value or 0
                live.discard(i)
    return total


def _rescue_round(opt: MemOptions, buf: np.ndarray, q_pad: int, t_b: int,
                  mat: torch.Tensor) -> np.ndarray:
    """One rescue round on the device of `mat`: one upload of the rows
    `buf` (query [q_pad] | target [t_b] | qlen tlen minsc endsc) and one
    [4, B] download of (score, te, qe, score2)."""
    dev_buf = torch.as_tensor(buf, device=mat.device)
    cols = dev_buf[:, q_pad + t_b:].T
    res = localsw_core(
        dev_buf[:, :q_pad], cols[0], dev_buf[:, q_pad:q_pad + t_b],
        cols[1], mat, cols[2], cols[3], o_del=opt.o_del,
        e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins)
    return torch.stack(list(res)).cpu().numpy()


def rescue_batch(opt: MemOptions, idx: FMIndex, pes: list[PEStat], pairs,
                 b1, b2, mat: torch.Tensor, *, q_pad: int = NARROW.rescue_q,
                 t_pad: int = NARROW.rescue_t, timers=None) -> int:
    """Mate rescue for a whole batch: what ``matesw_gen`` over every
    anchor of every pair, driven by ``run_matesw_rounds``, does, with the
    same two device rounds.  The region lists of `pairs` are read once
    into columns; one native call (``native/rescue.cpp``) picks the
    anchors, runs their skip tests against the lists as they stand, finds
    each anchor's window and writes the first round's rows; a second
    builds the second round's rows from the first round's results.  Each
    rescued region is inserted into its mate's list in job order, before
    the first region of a lower score.  Counters: ``pair.rescue_jobs``
    (anchors), ``pair.rescue_sw`` (anchors that ran an SW),
    ``pair.rescued`` (regions inserted), ``pair.rescue_truncated``.
    Returns the number of rescue SWs performed."""
    lib = load_native()
    cols = region_columns(pairs, ("rb", "rid", "score"))
    bounds = cols["bounds"]
    cap = int(np.minimum(np.diff(bounds), opt.max_matesw).sum())
    if b1.codes.shape[1] != b2.codes.shape[1]:
        raise ValueError("the two ends of a paired batch differ in width")
    codes = [np.ascontiguousarray(b.codes, np.uint8) for b in (b1, b2)]
    lens = [np.ascontiguousarray(b.lens, np.int64) for b in (b1, b2)]
    if any(c.shape[0] < len(pairs) or n.size < len(pairs)
           or (n > c.shape[1]).any() for c, n in zip(codes, lens)):
        raise ValueError("the read batches do not match the pairs: fewer "
                         "reads, or lengths past their width")
    offs = np.array([ct.offset for ct in idx.contigs], np.int64)
    clen = np.array([ct.length for ct in idx.contigs], np.int64)
    pac = np.ascontiguousarray(idx.pac_words, np.uint32)
    failed = np.array([p.failed for p in pes], np.uint8)
    low = np.array([p.low for p in pes], np.int64)
    high = np.array([p.high for p in pes], np.int64)
    stride = q_pad + max(t_pad, 256) + 4
    buf = np.empty(cap * stride, np.int32)
    job = {k: np.empty(cap, np.int64) for k in ("anchor", "rb", "lms")}
    rev = np.empty(cap, np.uint8)
    out = np.zeros(3, np.int64)
    J = lib.pe_rescue_round1(
        len(pairs), as_ptr(bounds),
        *(as_ptr(cols[f]) for f in ("rb", "rid", "score")),
        as_ptr(failed), as_ptr(low), as_ptr(high), as_ptr(offs),
        as_ptr(clen), offs.size, idx.l_pac, as_ptr(pac),
        as_ptr(codes[0]), as_ptr(lens[0]), as_ptr(codes[1]),
        as_ptr(lens[1]), codes[0].shape[1], opt.pen_unpaired,
        opt.max_matesw, opt.min_seed_len, opt.min_seed_len * opt.a, q_pad,
        t_pad, cap, as_ptr(buf), as_ptr(job["anchor"]), as_ptr(job["rb"]),
        as_ptr(rev), as_ptr(job["lms"]), as_ptr(out))
    if J < 0:
        raise RuntimeError("mate rescue: more jobs than anchors")
    t_b, n_anchors, n_cut = out.tolist()
    count(timers, "pair.rescue_jobs", n_anchors)
    count(timers, "pair.rescue_sw", J)
    if n_cut:
        count(timers, "pair.rescue_truncated", n_cut)
    n_hit = 0
    if J:
        res = np.ascontiguousarray(
            _rescue_round(opt, buf[:J * (q_pad + t_b + 4)].reshape(J, -1),
                          q_pad, t_b, mat), np.int64)
        buf2 = np.empty(J * stride, np.int32)
        hits = np.empty(J, np.int64)
        out2 = np.zeros(1, np.int64)
        n_hit = lib.pe_rescue_round2(
            J, as_ptr(buf), q_pad, t_b, as_ptr(res), opt.min_seed_len,
            t_pad, as_ptr(buf2), as_ptr(hits), as_ptr(out2))
    count(timers, "pair.rescued", n_hit)
    if not n_hit:
        return J
    t_b2 = int(out2[0])
    hits = hits[:n_hit]
    res2 = _rescue_round(opt, buf2[:n_hit * (q_pad + t_b2 + 4)].reshape(
        n_hit, -1), q_pad, t_b2, mat)
    sc, te, qe, sc2 = res[:, hits]
    qb = qe - res2[2]
    tb = te - res2[1]
    is_rev = rev[hits].astype(bool)
    lms, wrb = job["lms"][hits], job["rb"][hits]
    l2 = idx.l_pac << 1
    f = dict(
        qb=np.where(is_rev, lms - (qe + 1), qb),
        qe=np.where(is_rev, lms - qb, qe + 1),
        rb=np.where(is_rev, l2 - (wrb + te + 1), wrb + tb),
        re=np.where(is_rev, l2 - (wrb + tb), wrb + te + 1))
    f["seedcov"] = np.minimum(f["re"] - f["rb"], f["qe"] - f["qb"]) >> 1
    anchors = job["anchor"][hits]
    f.update(rid=cols["rid"][anchors], frac_rep=cols["frac_rep"][anchors],
             score=sc, csub=sc2)
    f = {k: v.tolist() for k, v in f.items()}
    slots = np.searchsorted(bounds, anchors, side="right") - 1
    ends = [end for p in pairs for end in p]
    for h, slot in enumerate(slots.tolist()):
        s = f["score"][h]
        b = AlnReg(rb=f["rb"][h], re=f["re"][h], qb=f["qb"][h],
                   qe=f["qe"][h], rid=f["rid"][h], score=s, truesc=s,
                   csub=f["csub"][h], secondary=-1,
                   seedcov=f["seedcov"][h], w=opt.w,
                   frac_rep=f["frac_rep"][h])
        ma = ends[slot ^ 1]
        pos = next((k for k, r in enumerate(ma) if r.score < s), len(ma))
        ma.insert(pos, b)
    return J


# ------------------------------------------------------------- sam_pe ----

def sam_pe_g(opt: MemOptions, idx: FMIndex, pes: list[PEStat], pair_id: int,
             names: tuple[str, str], seqs: tuple[str, str],
             quals: tuple[str, str], queries: tuple[np.ndarray, np.ndarray],
             regs: tuple[list[AlnReg], list[AlnReg]]):
    """mem_sam_pe minus the rescue step (rescue runs batched beforehand).
    Generator yielding GAJob (CIGAR DP fills run batched by the driver).

    Marks each end's list, which must not have been marked before: bwa
    marks exactly ONCE per end (mem_sam_pe); re-marking an already-sorted
    list re-hashes by the new positions and can flip equal-score
    tie-breaks and sub_n counts."""
    a = [finalize.mark_primary(opt, regs[0], (pair_id << 1) | 0),
         finalize.mark_primary(opt, regs[1], (pair_id << 1) | 1)]
    extra_flag = 1
    o = 0
    if a[0] and a[1]:
        o, subo, n_sub, z = mem_pair(opt, idx, pes, (a[0], a[1]), pair_id)
    if a[0] and a[1] and o > 0:
        # multiple good hits on either end -> fall through to SE-style
        is_multi = [
            any(p.secondary < 0 and p.score >= opt.T for p in end[1:])
            for end in a]
        if not (is_multi[0] or is_multi[1]):
            score_un = a[0][0].score + a[1][0].score - opt.pen_unpaired
            subo = max(subo, score_un)
            q_pe = raw_mapq(o - subo, opt.a)
            if n_sub > 0:
                q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
            q_pe = min(max(q_pe, 0), 60)
            q_pe = int(q_pe * (1.0 - 0.5 * (a[0][0].frac_rep
                                            + a[1][0].frac_rep)) + 0.499)
            if o > score_un:  # paired alignment preferred
                c = [a[0][z[0]], a[1][z[1]]]
                q_se = [0, 0]
                for i in range(2):
                    if c[i].secondary >= 0:
                        c[i].sub = a[i][c[i].secondary].score
                        c[i].secondary = -2
                    q_se[i] = finalize.approx_mapq_se(opt, c[i])
                for i in range(2):
                    if q_se[i] < q_pe:
                        q_se[i] = min(q_pe, q_se[i] + 40)
                    q_se[i] = min(q_se[i],
                                  raw_mapq(c[i].score - c[i].csub, opt.a))
                extra_flag |= 2
            else:
                z = [0, 0]
                c = [a[0][0], a[1][0]]
                q_se = [finalize.approx_mapq_se(opt, c[0]),
                        finalize.approx_mapq_se(opt, c[1])]
            h = []
            for i in range(2):
                aln = yield from finalize.reg2aln_g(
                    opt, idx, len(seqs[i]), queries[i], c[i])
                aln.mapq = q_se[i]
                aln.flag |= (0x40 << i) | extra_flag
                xa = yield from finalize.gen_xa_g(
                    opt, idx, a[i], len(seqs[i]), queries[i])
                aln.XA = xa.get(z[i])
                h.append(aln)
            rec0 = finalize.aln2sam(opt, idx, names[0], seqs[0], quals[0],
                                    1, [h[0]], 0, mate=h[1])
            rec1 = finalize.aln2sam(opt, idx, names[1], seqs[1], quals[1],
                                    1, [h[1]], 0, mate=h[0])
            return [rec0], [rec1]

    # ---- no pairing: output each end SE-style, with mate info ----
    h = []
    for i in range(2):
        src = a[i][0] if (a[i] and a[i][0].score >= opt.T) else None
        h.append((yield from finalize.reg2aln_g(
            opt, idx, len(seqs[i]), queries[i], src)))
    if a[0] and a[1] and h[0].rid == h[1].rid and h[0].rid >= 0:
        dist, d = infer_dir(idx.l_pac, a[0][0].rb, a[1][0].rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    out = ([], [])
    for i in range(2):
        recs = yield from pe_end_records_g(
            opt, idx, names[i], seqs[i], quals[i], queries[i], a[i],
            (0x40 << i) | extra_flag, h[1 - i])
        out[i].extend(recs)
    return out


def pe_end_records_g(opt: MemOptions, idx: FMIndex, name: str, seq: str,
                     qual: str, query: np.ndarray, regs: list[AlnReg],
                     extra_flag: int, mate: finalize.Aln):
    """mem_reg2sam for one end of an unpaired pair (regs already marked).
    Generator."""
    xa = yield from finalize.gen_xa_g(opt, idx, regs, len(seq), query)
    alns = []
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0:
            continue
        q = yield from finalize.reg2aln_g(opt, idx, len(seq), query, p)
        q.XA = xa.get(k)
        if alns:
            q.flag |= samio.FLAG_SUPPLEMENTARY
            if q.mapq > alns[0].mapq:
                q.mapq = alns[0].mapq
        q.flag |= extra_flag
        alns.append(q)
    if not alns:
        t = yield from finalize.reg2aln_g(opt, idx, len(seq), query, None)
        t.flag |= extra_flag
        return [finalize.aln2sam(opt, idx, name, seq, qual, 1, [t], 0,
                                 mate=mate)]
    return [finalize.aln2sam(opt, idx, name, seq, qual, len(alns), alns, k,
                             mate=mate)
            for k in range(len(alns))]


# --------------------------------------------------------- PE driver ----

FLAT_PE = True  # tests toggle to force the generator path


def align_pe_batch(aligner, b1, b2, pair_id0: int, handles=None) -> str:
    """Align one paired batch; returns the SAM text.  Insert-size stats are
    estimated per chunk exactly as bwa's pestat runs per pipeline chunk.

    ``handles``: optionally pre-dispatched seeding handles for (b1, b2)
    (the pipelined PE driver dispatches batch N+1's seeding before batch
    N's host phases run, mirroring the SE dispatch-ahead driver).  The
    two ends run at one width bucket, the wider end's (``same_width``;
    the driver pads them before dispatch)."""
    opt = aligner.opt
    idx = aligner.idx
    if b1.codes.shape[1] != b2.codes.shape[1]:
        if handles is not None:
            raise ValueError("the two ends of a paired batch differ in "
                             "width: pad them with same_width before "
                             "dispatching their seeding")
        b1, b2 = same_width(b1, b2)
    wd = batch_widths(opt, b1.codes.shape[1])
    # dispatch BOTH ends' device seeding before finishing either: end 2's
    # SMEM/expand compute and async seed-row downloads overlap end 1's
    # blocking d2h + host chaining + extension waves (measured: PE SAL was
    # ~4x SE's per batch when end 2 seeded only after end 1's regions)
    if handles is not None:
        h1, h2 = handles
    else:
        h1 = aligner.seed_batch_dispatch(b1.codes, b1.lens)
        h2 = aligner.seed_batch_dispatch(b2.codes, b2.lens)
    regs1, codes_dev1 = aligner.regions_batch(b1, seed_handle=h1), h1[2]
    regs2, codes_dev2 = aligner.regions_batch(b2, seed_handle=h2), h2[2]
    # dedup/sort before pairing (mem_align1_core does this)
    with aligner.timers.phase("DEDUP"):
        regs1 = drive_rounds(
            [finalize.sort_dedup_patch_g(opt, idx, b1.codes[i, : b1.lens[i]],
                                         r) for i, r in enumerate(regs1)],
            aligner.ga_exec)
        regs2 = drive_rounds(
            [finalize.sort_dedup_patch_g(opt, idx, b2.codes[i, : b2.lens[i]],
                                         r) for i, r in enumerate(regs2)],
            aligner.ga_exec)
    pairs = list(zip(regs1, regs2))
    with aligner.timers.phase("PAIR"):
        pes = pestat(opt, idx.l_pac, pairs)
        rescue_batch(opt, idx, pes, pairs, b1, b2, aligner.mat_dev,
                     q_pad=wd.rescue_q, t_pad=wd.rescue_t,
                     timers=aligner.timers)
    with aligner.timers.phase("SAM"):
        return pe_sam_text(aligner, b1, b2, pair_id0, pairs, pes,
                           codes_dev1, codes_dev2)


def _pe_generator_text(aligner, b1, b2, pair_id0, pairs, pes, rows,
                       other: list) -> None:
    """Render pairs `rows` via the sam_pe_g generator path into the
    interleaved `other` row-text list (rows 2i / 2i+1); each pair's two
    lists are marked there, once."""
    opt, idx = aligner.opt, aligner.idx
    gens = [
        sam_pe_g(opt, idx, pes, pair_id0 + int(i),
                 (b1.names[i], b2.names[i]),
                 (b1.seqs[i], b2.seqs[i]),
                 (b1.quals[i], b2.quals[i]),
                 (b1.codes[i, : b1.lens[i]],
                  b2.codes[i, : b2.lens[i]]),
                 pairs[i])
        for i in rows
    ]
    for i, (recs0, recs1) in zip(rows, drive_rounds(gens, aligner.ga_exec)):
        other[2 * i] = "".join(r.line() + "\n" for r in recs0)
        other[2 * i + 1] = "".join(r.line() + "\n" for r in recs1)


# ------------------------------------------- flat-tier pair selection ----

REG_INT_FIELDS = ("rb", "re", "qb", "qe", "rid", "score", "truesc", "w",
                  "csub", "sub_n")


def region_columns(pairs, fields=REG_INT_FIELDS) -> dict:
    """A batch's region lists read once into CSR columns: ``bounds``
    [2B + 1] (end e of pair i is 2i + e, its regions in list order), an
    int64 column for each of `fields` (two or more) and ``frac_rep``."""
    ends = [end for p in pairs for end in p]
    regs = [r for end in ends for r in end]
    n, nf = len(regs), len(fields)
    bounds = np.zeros(len(ends) + 1, np.int64)
    np.cumsum([len(end) for end in ends], out=bounds[1:])
    ints = np.fromiter(
        itertools.chain.from_iterable(map(operator.attrgetter(*fields),
                                          regs)),
        np.int64, count=n * nf).reshape(n, nf).T.copy()
    cols = dict(zip(fields, ints))
    cols["frac_rep"] = np.fromiter((r.frac_rep for r in regs), np.float64,
                                   count=n)
    cols["bounds"] = bounds
    return cols


def pair_term(opt: MemOptions, pe: PEStat, dist: int) -> float:
    """mem_pair's insert-size term for two ends `dist` apart."""
    ns = (dist - pe.avg) / pe.std
    return 0.721 * math.log(2.0 * math.erfc(abs(ns) * M_SQRT1_2)) * opt.a


def pair_terms(opt: MemOptions, pes: list[PEStat]):
    """``pair_term`` over [low, high] of each direction that has not
    failed: (offsets [4] into the table, the table; NaN where Python
    raises)."""
    offs, tab = [], []
    for pe in pes:
        offs.append(len(tab))
        if pe.failed:
            continue
        for dist in range(pe.low, pe.high + 1):
            try:
                tab.append(pair_term(opt, pe, dist))
            except (ZeroDivisionError, ValueError):
                tab.append(math.nan)
    return np.array(offs, np.int64), np.array(tab or [0.0], np.float64)


def select_flat(opt: MemOptions, idx: FMIndex, cols: dict,
                pes: list[PEStat], pair_id0: int, widths) -> dict:
    """The flat tier's pair selection for a batch's ``region_columns``,
    in one native call (``native/flatsel.cpp``): mark_primary on each end,
    mem_pair, and the test that keeps a pair flat (no second primary,
    both primaries >= T, every emitted lane in the flat windows of
    `widths`, XA groups after the ratio filter and the max_XA_hits cap).
    The regions are not touched.  Returns the native outputs: by sorted
    position ``order`` (CSR rows), ``sec``, ``sub``, ``sub_n``; by pair
    ``flat``, ``o``, ``subo``, ``n_sub``, ``proper``; by end (2i + e)
    ``z``, ``pick`` (the emitted region's row), ``sub_eff``,
    ``subn_eff``, ``alt_cnt``; ``alt_rows``, the XA alternates' rows."""
    lib = load_native()
    fields = ("rb", "re", "qb", "qe", "rid", "score", "sub_n")
    bounds = np.ascontiguousarray(cols["bounds"], np.int64)
    B = (bounds.size - 1) // 2
    n = int(bounds[-1])
    ins = {f: np.ascontiguousarray(cols[f], np.int64) for f in fields}
    if bounds.size != 2 * B + 1 or any(a.size != n for a in ins.values()):
        raise ValueError("region columns do not match their bounds")
    i64 = lambda k: np.zeros(k, np.int64)  # noqa: E731
    out = dict(order=i64(n), sec=np.zeros(n, np.int32), sub=i64(n),
               sub_n=i64(n), flat=np.zeros(B, np.uint8), o=i64(B),
               subo=i64(B), n_sub=i64(B), proper=np.zeros(B, np.uint8),
               z=i64(2 * B), pick=i64(2 * B), sub_eff=i64(2 * B),
               subn_eff=i64(2 * B), alt_cnt=i64(2 * B),
               alt_rows=i64(max(n, 1)))
    offs = np.array([ct.offset for ct in idx.contigs], np.int64)
    tab_off, tab = pair_terms(opt, pes)
    failed = np.array([p.failed for p in pes], np.uint8)
    low = np.array([p.low for p in pes], np.int64)
    high = np.array([p.high for p in pes], np.int64)
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    rc = lib.pe_select_flat(
        B, as_ptr(bounds), *(as_ptr(ins[f]) for f in fields),
        as_ptr(offs), offs.size, idx.l_pac, opt.mask_level, tmp, opt.T,
        opt.pen_unpaired, opt.XA_drop_ratio, opt.max_XA_hits,
        widths.sam_q, widths.sam_t, as_ptr(failed), as_ptr(low),
        as_ptr(high), as_ptr(tab_off), as_ptr(tab), pair_id0,
        *(as_ptr(out[k]) for k in ("order", "sec", "sub", "sub_n", "flat",
                                   "o", "subo", "n_sub", "proper", "z",
                                   "pick", "sub_eff", "subn_eff",
                                   "alt_cnt", "alt_rows")))
    if rc == -1:
        raise ValueError("mem_pair: an insert-size term is not finite "
                         "(a direction's model has std 0)")
    if rc < 0:
        raise IndexError("a region's contig index is out of range")
    out["alt_rows"] = out["alt_rows"][:rc]
    out["flat"] = out["flat"].astype(bool)
    out["proper"] = out["proper"].astype(bool)
    return out


def pe_sam_text(aligner, b1, b2, pair_id0: int, pairs, pes,
                codes_dev1=None, codes_dev2=None) -> str:
    """Batched PE SAM assembly (the reference's mem_sam_pe_batch move,
    docs-archive/ARM-BATCHED-SAM-PLAN.md:27-111 — SAM was 76% of wall in
    the scalar path).

    Flat-eligible pairs — each end in the single-primary fast case (no
    second primary, primary score >= T, every emitted lane flat-eligible
    geometry) — run columnar: mem_pair picks the emitted region per end
    (z-indices, possibly a shadowed region), XS is max(sub, csub) of the
    CHOSEN region, XA alternates render as extra flat_core lanes exactly
    like the SE multi-region path.  The selection is one pass over the
    region lists (``region_columns``) and one native call
    (``select_flat``); ``sam.flat_pairs`` counts the pairs it keeps.
    Everything else (second primaries/supplementary, sub-T primaries,
    non-flat geometry, cigar-pack overflow) renders via the sam_pe_g
    generator path.  Byte-identical by construction
    (tests/test_torch_pe.py, tests/test_torch_pe_select.py).
    """
    opt, idx = aligner.opt, aligner.idx
    l_pac = idx.l_pac
    B = b1.n
    wd = batch_widths(opt, b1.codes.shape[1])   # both ends' (same_width)
    other: list = [""] * (2 * B)
    keep = np.zeros(B, bool)
    flat = np.array([], np.int64)
    if FLAT_PE:
        cols = region_columns(pairs)
        sel = select_flat(opt, idx, cols, pes, pair_id0, wd)
        flat = np.flatnonzero(sel["flat"])
        count(aligner.timers, "sam.flat_pairs", flat.size)

    N = flat.size
    if N:
        def end_cols(end):
            """The end's emitted regions' columns, and the rows of its
            lanes: the emitted regions, then their XA alternates."""
            e = 2 * flat + end
            pick = sel["pick"][e]
            acnt = sel["alt_cnt"][e]
            on_end = np.repeat(np.arange(2 * B) % 2 == end, sel["alt_cnt"])
            c = {f: cols[f][pick] for f in ("rb", "score", "csub")}
            c.update(frac=cols["frac_rep"][pick], sub=sel["sub_eff"][e],
                     sub_n=sel["subn_eff"][e], acnt=acnt,
                     off=np.cumsum(acnt) - acnt)
            return c, np.concatenate([pick, sel["alt_rows"][on_end]])

        c0, rows0 = end_cols(0)
        c1, rows1 = end_cols(1)
        A0 = rows0.size - N
        if codes_dev1 is None:
            codes_dev1 = aligner._put(np.asarray(b1.codes, np.int32))
        if codes_dev2 is None:
            codes_dev2 = aligner._put(np.asarray(b2.codes, np.int32))

        def run_core(codes_dev, lens_b, cc, rows):
            rd = np.concatenate([flat, np.repeat(flat, cc["acnt"])])
            L = np.asarray(lens_b, np.int64)[rd]
            return flatsam.flat_core(
                aligner, codes_dev, rd, L,
                *(cols[f][rows] for f in ("rb", "re", "qb", "qe", "truesc",
                                          "w")), wd)

        core0 = run_core(codes_dev1, b1.lens, c0, rows0)
        core1 = run_core(codes_dev2, b2.lens, c1, rows1)

        # pair ok = every lane (both primaries + all alternates) packed
        okp = (flatsam.records_ok(core0["ok"], N, c0["off"], c0["acnt"])
               & flatsam.records_ok(core1["ok"], N, c1["off"], c1["acnt"]))
        keep[flat[okp]] = True

    rest = np.flatnonzero(~keep).tolist()
    count(aligner.timers, "sam.generator_reads", 2 * len(rest))
    if rest:
        _pe_generator_text(aligner, b1, b2, pair_id0, pairs, pes, rest,
                           other)

    if not keep.any():
        return "".join(other)
    names = [x for p in zip(b1.names[:B], b2.names[:B]) for x in p]
    seqs = [x for p in zip(b1.seqs[:B], b2.seqs[:B]) for x in p]
    quals = [x for p in zip(b1.quals[:B], b2.quals[:B]) for x in p]

    # ---- pair scores (from the selection) ----
    o = sel["o"][flat]
    subo = sel["subo"][flat]
    n_sub = sel["n_sub"][flat]
    proper = sel["proper"][flat]
    prim0 = sel["order"][cols["bounds"][2 * flat]]
    prim1 = sel["order"][cols["bounds"][2 * flat + 1]]
    score_un = (cols["score"][prim0] + cols["score"][prim1]
                - opt.pen_unpaired)
    pfrac = cols["frac_rep"][prim0] + cols["frac_rep"][prim1]
    o0 = o == 0

    s0, s1 = c0["score"], c1["score"]

    # ---- mapq (sam_pe_g's q_pe / q_se dance, vectorized) ----
    subo2 = np.maximum(subo, score_un)
    q_pe = flatsam._trunci(6.02 * (o - subo2) / opt.a + 0.499)
    q_pe = q_pe - flatsam._trunci(
        4.343 * flatsam._log_exact(n_sub + 1) + 0.499)
    q_pe = np.maximum(np.minimum(q_pe, 60), 0)
    # q_pe's repeat correction uses the PRIMARY ends' frac_rep
    q_pe = flatsam._trunci(q_pe * (1.0 - 0.5 * pfrac) + 0.499)

    def end_mapq(core, cc):
        qse = flatsam.mapq_se_vec(opt, core["lq"][:N], core["rlen"][:N],
                                  cc["score"], cc["frac"],
                                  cc["sub"], cc["csub"], cc["sub_n"])
        cap = flatsam._trunci(
            6.02 * (cc["score"] - cc["csub"]) / opt.a + 0.499)
        adj = np.where(qse < q_pe, np.minimum(q_pe, qse + 40), qse)
        adj = np.minimum(adj, cap)
        return np.where(proper, adj, qse)

    mapq0 = end_mapq(core0, c0)
    mapq1 = end_mapq(core1, c1)

    # ---- flags ----
    rev0, rev1 = core0["rev"][:N], core1["rev"][:N]
    # the unpaired-emission path still sets the proper-pair bit when the
    # two primary hits land on one contig at a sane insert (sam_pe_g's
    # infer_dir check; in the unpaired branch chosen == primary)
    rb0, rb1 = c0["rb"], c1["rb"]
    sr0, sr1 = rb0 >= l_pac, rb1 >= l_pac
    p2 = np.where(sr0 == sr1, rb1, 2 * l_pac - 1 - rb1)
    d_arr = np.where(sr0 == sr1, 0, 1) ^ np.where(p2 > rb0, 0, 3)
    dist = np.abs(p2 - rb0)
    p_low = np.array([p.low for p in pes], np.int64)
    p_high = np.array([p.high for p in pes], np.int64)
    p_fail = np.array([p.failed for p in pes], bool)
    dir_ok = (~p_fail[d_arr] & (p_low[d_arr] <= dist)
              & (dist <= p_high[d_arr]))
    same_rid = core0["rid"][:N] == core1["rid"][:N]
    extra2 = proper | (o0 & dir_ok & same_rid)
    flag0 = (1 | 0x40 | np.where(extra2, 2, 0) | np.where(rev0, 16, 0)
             | np.where(rev1, 32, 0)).astype(np.int32)
    flag1 = (1 | 0x80 | np.where(extra2, 2, 0) | np.where(rev1, 16, 0)
             | np.where(rev0, 32, 0)).astype(np.int32)

    # ---- mate fields (aln2sam's RNEXT/PNEXT/TLEN rules) ----
    rnext0 = np.where(same_rid, -2, core1["rid"][:N]).astype(np.int32)
    rnext1 = np.where(same_rid, -2, core0["rid"][:N]).astype(np.int32)
    e0 = (core0["p1"][:N] - 1) + np.where(rev0, core0["reflen"][:N] - 1,
                                          0)
    e1 = (core1["p1"][:N] - 1) + np.where(rev1, core1["reflen"][:N] - 1,
                                          0)
    tl0 = np.where(e0 > e1, e1 - e0 - 1, e1 - e0 + 1)
    tlen0 = np.where(same_rid, tl0, 0).astype(np.int64)
    tlen1 = np.where(same_rid, -tl0 + np.where(e1 == e0, 2, 0),
                     0).astype(np.int64)

    # ---- merge lane blocks: [2N interleaved primaries][alts0][alts1] --
    def ilv(a0_, a1_):
        out = np.empty((2 * N,) + a0_.shape[1:], a0_.dtype)
        out[0::2] = a0_
        out[1::2] = a1_
        return out

    core = {}
    for k in flatsam._CORE_LANE_KEYS:
        if k == "win_row":
            continue
        core[k] = np.concatenate([ilv(core0[k][:N], core1[k][:N]),
                                  core0[k][N:], core1[k][N:]])
    # window blocks: stack end-1's rows after end-0's
    qh0, th0 = core0["qh"], core0["th"]
    qh1, th1 = core1["qh"], core1["th"]
    n0 = 0 if qh0 is None else qh0.shape[0]
    wr1 = np.where(core1["win_row"] >= 0, core1["win_row"] + n0, -1
                   ).astype(np.int32)
    core["win_row"] = np.concatenate(
        [ilv(core0["win_row"][:N], wr1[:N]), core0["win_row"][N:],
         wr1[N:]])
    blocks_q = [x for x in (qh0, qh1) if x is not None]
    blocks_t = [x for x in (th0, th1) if x is not None]
    core["qh"] = np.vstack(blocks_q) if blocks_q else None
    core["th"] = np.vstack(blocks_t) if blocks_t else None
    core["ok"] = np.ones(core["p1"].shape[0], bool)

    lane_b = np.empty(2 * N, np.int64)
    lane_b[0::2] = 2 * flat
    lane_b[1::2] = 2 * flat + 1
    # XS of the chosen region: max(mark/pair sub, csub) — real values now
    # (the r4 XS:i:0 shortcut only held while rescue-touched ends were
    # excluded from the flat path)
    xs0 = np.maximum(c0["sub"], c0["csub"])
    xs1 = np.maximum(c1["sub"], c1["csub"])
    # alt lane ranges in merged lane space
    alt_lo0 = 2 * N + c0["off"]
    alt_lo1 = 2 * N + A0 + c1["off"]
    rec = dict(
        b=lane_b, lane=ilv(np.arange(0, 2 * N, 2), np.arange(1, 2 * N, 2)),
        flag=ilv(flag0, flag1), mapq=ilv(mapq0, mapq1),
        score=ilv(s0, s1), xs=ilv(xs0, xs1),
        rnext=ilv(rnext0, rnext1),
        pnext=ilv(core1["p1"][:N], core0["p1"][:N]),
        tlen=ilv(tlen0, tlen1),
        alt_lo=ilv(alt_lo0, alt_lo1).astype(np.int32),
        alt_hi=ilv(alt_lo0 + c0["acnt"], alt_lo1 + c1["acnt"]
                   ).astype(np.int32))
    if not okp.all():  # drop failed pairs' records (lanes stay, unused)
        keep2 = np.repeat(okp, 2)
        rec = {k: v[keep2] for k, v in rec.items()}
    return flatsam.emit_flat(aligner, names, seqs, quals, other, core,
                             rec)


def same_width(b1, b2) -> tuple:
    """The two ends of a paired batch padded to one width, the wider
    end's: a pair runs at one bucket."""
    w = max(b1.codes.shape[1], b2.codes.shape[1])
    return b1.padded_to(w), b2.padded_to(w)


class PairedCountMismatch(Exception):
    """The two FASTQ files of a pair differ in read count."""


def align_pe_fastq(aligner, fq1: str, fq2: str, out, workers: int = 1,
                   chunk_dir: str | None = None,
                   manifest: dict | None = None,
                   shard: tuple[int, int] | None = None) -> int:
    """Streaming PE driver: paired batches stream off both FASTQs through
    the drivers SE uses (``pipeline.run_dispatch_ahead`` when ``workers``
    is 1: batch N+1's seeding of both ends is dispatched before batch N's
    host pairing, rescue and SAM run; ``pipeline.run_ordered_pool``
    otherwise), with their ``chunk_dir`` resume and ``shard`` filter.
    A pair of batches either of which holds a read of 161-256 bp runs in
    the wide bucket, both ends padded to it (``fastq.wide_batches``
    counts the pair once).  FASTQs of unequal length write every complete
    batch, then return 1."""
    from tpubwa_torch.io.fastq import stream_batches
    from tpubwa_torch.align.pipeline import (count_wide, run_dispatch_ahead,
                                             run_ordered_pool)

    opt = aligner.opt

    def items():
        it1 = stream_batches(fq1, opt.batch_reads, opt.max_read_len,
                             timers=aligner.timers)
        it2 = stream_batches(fq2, opt.batch_reads, opt.max_read_len,
                             timers=aligner.timers)
        pair_id0 = 0
        while True:
            b1 = next(it1, None)
            b2 = next(it2, None)
            if b1 is None and b2 is None:
                return
            if b1 is None or b2 is None or b1.n != b2.n:
                raise PairedCountMismatch(
                    "paired FASTQ files differ in read count")
            b1, b2 = same_width(b1, b2)
            count_wide(aligner, b1)
            yield (b1, b2, pair_id0), 2 * b1.n
            pair_id0 += b1.n

    def dispatch(payload):
        b1, b2, _ = payload
        return (aligner.seed_batch_dispatch(b1.codes, b1.lens),
                aligner.seed_batch_dispatch(b2.codes, b2.lens))

    def work(payload, handles=None) -> str:
        b1, b2, pair_id0 = payload
        return align_pe_batch(aligner, b1, b2, pair_id0, handles=handles)

    kw = dict(chunk_dir=chunk_dir, manifest=manifest, shard=shard,
              timers=aligner.timers)
    try:
        if workers <= 1:
            run_dispatch_ahead(items(), dispatch, work, out, **kw)
        else:
            run_ordered_pool(items(), work, out, workers, **kw)
    except PairedCountMismatch as e:
        # only the read-count check gets the clean one-line exit; any other
        # error propagates with its traceback
        print(f"tpu-bwa-torch mem: {e}", file=sys.stderr)
        return 1
    print(aligner.timers.report(), file=sys.stderr)
    return 0
