"""Chain -> alignment regions by per-read extension generators (port of
``tpubwa.align.region``).

Semantics of bwa-mem's mem_chain2aln (reference call stack SURVEY.md
§3.1 worker_aln -> mem_chain2aln_across_reads_V2 -> BandedPairWiseSW).
Each read is a generator that walks its chains and seeds (score
descending, with bwa's containment skip tests) and yields one whole-seed
job a seed; ``run_extension_rounds`` batches one pending job a read a
round into one ``extend_seed_batch`` call (left + right extension +
band-doubling retries) on the device.

This is the per-read path of ``Aligner.chain_batch`` +
``extend_batch_rounds``: the reference the flat native engine
(``align/flatext.py``, the production route) is held to.  The flat engine
produces regions as columns; the per-read generator tier of
``align/finalize.py`` and ``align/pair.py`` works on ``AlnReg`` objects.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from tpubwa_torch.align.chain import Chain
from tpubwa_torch.config import MemOptions
from tpubwa_torch.ops.extend_flat import Q_PAD, T_PAD
from tpubwa_torch.ops.extend_ref import ExtendResult


@dataclasses.dataclass
class AlnReg:
    """Alignment region (bwa mem_alnreg_t)."""

    rb: int = 0           # [rb, re): reference in 2*l_pac coords
    re: int = 0
    qb: int = 0           # [qb, qe): query
    qe: int = 0
    rid: int = -1
    score: int = -1
    truesc: int = -1
    sub: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 1
    frac_rep: float = 0.0
    hash: int = 0


def read_regions(fields: dict, bounds: np.ndarray, b: int) -> list[AlnReg]:
    """Read b's regions as ``AlnReg`` objects, from the region columns of
    ``flatext.finalize_fields`` (its regions are rows
    [bounds[b], bounds[b + 1]))."""
    return [AlnReg(rb=int(fields["rb"][i]), re=int(fields["re"][i]),
                   qb=int(fields["qb"][i]), qe=int(fields["qe"][i]),
                   rid=int(fields["rid"][i]), score=int(fields["score"][i]),
                   truesc=int(fields["truesc"][i]), w=int(fields["w"][i]),
                   seedcov=int(fields["seedcov"][i]),
                   seedlen0=int(fields["seedlen0"][i]),
                   frac_rep=float(fields["frac_rep"][i]))
            for i in range(int(bounds[b]), int(bounds[b + 1]))]


@dataclasses.dataclass
class SeedExtJob:
    """One whole-seed extension: left (reversed) + right halves, fused into
    a single device call (ops.extend.extend_seed_batch)."""

    q_l: np.ndarray     # left query, already reversed; may be empty
    t_l: np.ndarray
    q_r: np.ndarray     # right query; may be empty
    t_r: np.ndarray
    h0: int             # seed_len * match score


def cal_max_gap(opt: MemOptions, qlen: int) -> int:
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = max(max(l_del, l_ins), 1)
    return min(l, opt.w * 2)


def extend_read(opt: MemOptions, l_pac: int,
                fetch_ref: Callable[[int, int], np.ndarray],
                l_query: int, query: np.ndarray,
                chains: list[Chain]) -> Iterator[SeedExtJob]:
    """Generator: yields one SeedExtJob a seed it extends, expects (left
    ExtendResult, right ExtendResult, aw0, aw1) sent back; its return
    value (StopIteration.value) is the list[AlnReg] for the read.  The
    windows may be longer than the round loop's pads, which truncate
    them (part of the output)."""
    regs: list[AlnReg] = []
    for c in chains:
        if not c.seeds:
            continue
        # reference window for the whole chain
        rmax0, rmax1 = l_pac * 2, 0
        for t in c.seeds:
            b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
            e = t.rbeg + t.len + (l_query - t.qbeg - t.len) \
                + cal_max_gap(opt, l_query - t.qbeg - t.len)
            rmax0 = min(rmax0, b)
            rmax1 = max(rmax1, e)
        rmax0 = max(rmax0, 0)
        rmax1 = min(rmax1, l_pac * 2)
        if rmax0 < l_pac < rmax1:  # crossing the strand boundary: pick a side
            if c.seeds[0].rbeg < l_pac:
                rmax1 = l_pac
            else:
                rmax0 = l_pac
        rseq = fetch_ref(rmax0, rmax1)

        # seeds by (score, index) ascending, visited in descending order
        srt = sorted(range(len(c.seeds)),
                     key=lambda i: (c.seeds[i].score, i))
        dropped = [False] * len(c.seeds)
        for k in reversed(range(len(srt))):
            s = c.seeds[srt[k]]
            # --- containment skip test (vs regions computed so far) ---
            contained = False
            for p in regs:
                if (s.rbeg < p.rb or s.rbeg + s.len > p.re
                        or s.qbeg < p.qb or s.qbeg + s.len > p.qe):
                    continue
                if s.len - p.seedlen0 > 0.1 * l_query:
                    continue
                qd = s.qbeg - p.qb
                rd = s.rbeg - p.rb
                max_gap = cal_max_gap(opt, min(qd, rd))
                ww = min(max_gap, p.w)
                if qd - rd < ww and rd - qd < ww:
                    contained = True
                    break
                qd = p.qe - (s.qbeg + s.len)
                rd = p.re - (s.rbeg + s.len)
                max_gap = cal_max_gap(opt, min(qd, rd))
                ww = min(max_gap, p.w)
                if qd - rd < ww and rd - qd < ww:
                    contained = True
                    break
            if contained:
                # confirm no overlapping major seed suggests a different aln
                diff = False
                for i2 in range(k + 1, len(srt)):
                    if dropped[srt[i2]]:
                        continue
                    t = c.seeds[srt[i2]]
                    if t.len < s.len * 0.95:
                        continue
                    if (s.qbeg <= t.qbeg
                            and s.qbeg + s.len - t.qbeg >= s.len >> 2
                            and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                        diff = True
                        break
                    if (t.qbeg <= s.qbeg
                            and t.qbeg + t.len - s.qbeg >= s.len >> 2
                            and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                        diff = True
                        break
                if not diff:
                    dropped[srt[k]] = True
                    continue

            a = AlnReg(w=opt.w, score=-1, truesc=-1, rid=c.rid,
                       frac_rep=c.frac_rep, seedlen0=s.len)

            has_left = s.qbeg > 0
            has_right = s.qbeg + s.len != l_query
            qe = s.qbeg + s.len
            re0 = s.rbeg + s.len - rmax0
            empty = query[:0]
            res = yield SeedExtJob(
                q_l=(query[: s.qbeg][::-1].copy() if has_left else empty),
                t_l=(rseq[: s.rbeg - rmax0][::-1].copy() if has_left
                     else empty),
                q_r=(query[qe:l_query] if has_right else empty),
                t_r=(rseq[re0:] if has_right else empty),
                h0=s.len * opt.a)
            left, right, aw0, aw1 = res

            if has_left:
                a.score = left.score
                if (left.gscore <= 0
                        or left.gscore <= a.score - opt.pen_clip5):
                    a.qb = s.qbeg - left.qle
                    a.rb = s.rbeg - left.tle
                    a.truesc = a.score
                else:
                    a.qb = 0
                    a.rb = s.rbeg - left.gtle
                    a.truesc = left.gscore
            else:
                a.score = a.truesc = s.len * opt.a
                a.qb = 0
                a.rb = s.rbeg
                aw0 = opt.w

            if has_right:
                sc0 = a.score
                a.score = right.score
                if (right.gscore <= 0
                        or right.gscore <= a.score - opt.pen_clip3):
                    a.qe = qe + right.qle
                    a.re = rmax0 + re0 + right.tle
                    a.truesc += a.score - sc0
                else:
                    a.qe = l_query
                    a.re = rmax0 + re0 + right.gtle
                    a.truesc += right.gscore - sc0
            else:
                a.qe = l_query
                a.re = s.rbeg + s.len
                aw1 = opt.w

            a.seedcov = 0
            for t in c.seeds:
                if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                        and t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
                    a.seedcov += t.len
            a.w = max(aw0, aw1)
            regs.append(a)
    return regs


def run_extension_rounds(gens: list[Iterator[SeedExtJob]], opt: MemOptions,
                         extend_round: Callable[[dict], np.ndarray],
                         q_pad: int = Q_PAD, t_pad: int = T_PAD
                         ) -> list[list[AlnReg]]:
    """Drive per-read extension generators in lockstep rounds: one pending
    whole-seed job a read a round, all of a round's jobs in one
    ``extend_round`` call.  Returns each read's regions.

    A round has as many lanes as reads still live (no padding to a bucket
    size: it pads only, so nothing depends on it).  Windows are cut to
    ``q_pad`` query (the batch's bucket's ``ext_q``, which holds its
    reads) and ``t_pad`` target bases (the truncation is part of the
    output); a round whose targets all fit 256 is 256 wide, else
    ``t_pad``.  ``extend_round`` receives the round's host arrays (``q_l,
    qlen_l, t_l, tlen_l, q_r, qlen_r, t_r, tlen_r, w0, h0, pen5, pen3``,
    int32, one row a lane) and returns int32 [14, lanes] on the host (one
    stacked download): left (score, qle, tle, gtle, gscore, max_off),
    right (the same), aw0, aw1."""
    n = len(gens)
    results: list[list[AlnReg] | None] = [None] * n
    pending: list[SeedExtJob | None] = [None] * n
    live = set()
    for i, g in enumerate(gens):
        try:
            pending[i] = next(g)
            live.add(i)
        except StopIteration as e:
            results[i] = e.value or []

    while live:
        idxs = sorted(live)
        B = len(idxs)
        t_max = max(max(min(len(pending[i].t_l), t_pad),
                        min(len(pending[i].t_r), t_pad)) for i in idxs)
        t_b = 256 if t_max <= 256 else t_pad
        lanes = {k: np.full((B, w), 4, np.int32) for k, w in
                 (("q_l", q_pad), ("t_l", t_b), ("q_r", q_pad),
                  ("t_r", t_b))}
        for k in ("qlen_l", "tlen_l", "qlen_r", "tlen_r"):
            lanes[k] = np.zeros(B, np.int32)
        lanes["h0"] = np.ones(B, np.int32)
        for r, i in enumerate(idxs):
            job = pending[i]
            for side in ("l", "r"):
                q, t = getattr(job, f"q_{side}"), getattr(job, f"t_{side}")
                nq, nt = min(len(q), q_pad), min(len(t), t_b)
                lanes[f"q_{side}"][r, :nq] = q[:nq]
                lanes[f"t_{side}"][r, :nt] = t[:nt]
                lanes[f"qlen_{side}"][r] = nq
                lanes[f"tlen_{side}"][r] = nt
            lanes["h0"][r] = max(job.h0, 1)
        lanes["w0"] = np.full(B, opt.w, np.int32)
        lanes["pen5"] = np.full(B, opt.pen_clip5, np.int32)
        lanes["pen3"] = np.full(B, opt.pen_clip3, np.int32)
        packed = extend_round(lanes).T.tolist()
        for r, i in enumerate(idxs):
            p = packed[r]
            res = (ExtendResult(*p[0:6]), ExtendResult(*p[6:12]), p[12],
                   p[13])
            try:
                pending[i] = gens[i].send(res)
            except StopIteration as e:
                results[i] = e.value or []
                live.discard(i)
    return results
