"""Region post-processing + SAM record construction (host side).

Carried over from ``tpubwa.align.finalize`` (which imports jax through
``tpubwa.ops.global_align``); only its imports of jax-importing modules
changed.  Semantics of bwa-mem's mem_sort_dedup_patch /
mem_mark_primary_se / mem_approx_mapq_se / mem_reg2aln / mem_aln2sam.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from tpubwa_torch.align.cigar_batch import GAJob
from tpubwa_torch.align.region import AlnReg
from tpubwa_torch.config import MemOptions
from tpubwa_torch.index.fmindex import FMIndex
from tpubwa_torch.io import sam as samio
from tpubwa_torch.ops.global_align import cigar_nm_md

PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90


def hash_64(key: int) -> int:
    """Wang's 64-bit integer hash (bwa hash_64) — deterministic tie-break."""
    mask = (1 << 64) - 1
    key = (key + (~(key << 32))) & mask
    key ^= key >> 22
    key = (key + (~(key << 13))) & mask
    key ^= key >> 8
    key = (key + (key << 3)) & mask
    key ^= key >> 15
    key = (key + (~(key << 27))) & mask
    key ^= key >> 31
    return key


@dataclasses.dataclass
class Aln:
    """Finalized alignment (bwa mem_aln_t)."""

    rid: int = -1
    pos: int = -1          # 0-based contig coordinate
    is_rev: bool = False
    flag: int = 0
    mapq: int = 0
    cigar: list = dataclasses.field(default_factory=list)  # [(op, len)]
    NM: int = -1
    MD: str = ""
    score: int = -1
    sub: int = -1
    XA: str | None = None


# ---------------------------------------------------------------- cigar ----

def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    if l1 == l2 and l1 * a - score < (q + r - a) * 2:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def gen_cigar_g(opt: MemOptions, idx: FMIndex, query_seg: np.ndarray,
                rb: int, re: int, w: int):
    """bwa_gen_cigar2: global alignment of query_seg vs ref[rb:re) (2*l_pac
    coords).  For reverse-strand regions both sequences are reversed first,
    so the returned CIGAR/MD are in SAM (genome-forward) order.

    Generator: yields one GAJob when a DP fill is needed (exact-length
    w==0 windows are scored inline), receives (score, cigar); returns
    (score, cigar, NM, MD)."""
    l_query = len(query_seg)
    if l_query <= 0 or rb >= re or (rb < idx.l_pac < re):
        return 0, [], -1, ""
    rseq = idx.fetch_ref(rb, re)
    query = np.asarray(query_seg, dtype=np.uint8)
    if rb >= idx.l_pac:
        # reverse-COMPLEMENT both (bwa bwa_gen_cigar2): scores/cigar are
        # complement-invariant, but the MD tag letters must be the
        # genome-FORWARD reference bases (2*l_pac-space codes are the
        # revcomp strand); N (code 4) stays N
        query = query[::-1].copy()
        query = np.where(query < 4, 3 - query, query).astype(np.uint8)
        rseq = (3 - rseq[::-1]).astype(np.uint8)  # fetch never returns N
    rlen = re - rb
    if l_query == rlen and w == 0:
        mat = opt.score_matrix()
        score = int(mat[rseq, np.minimum(query, 4)].sum())
        cigar = [(0, l_query)]
    else:
        max_ins = int((((l_query + 1) >> 1) * opt.a - opt.o_ins)
                      / opt.e_ins + 1.0)
        max_del = int((((l_query + 1) >> 1) * opt.a - opt.o_del)
                      / opt.e_del + 1.0)
        max_gap = max(max(max_ins, max_del), 1)
        ww = (max_gap + abs(rlen - l_query) + 1) >> 1
        ww = min(ww, w)
        min_w = abs(rlen - l_query) + 3
        ww = max(ww, min_w)
        score, cigar = yield GAJob(query, rseq, ww)
    nm, md = cigar_nm_md(query, rseq, cigar)
    return score, cigar, nm, md


def _drive_one(gen, opt: MemOptions):
    """Run a single finalize generator to completion with the scalar DP."""
    from tpubwa_torch.align.cigar_batch import GAScalarExecutor
    from tpubwa_torch.utils.rounds import drive_rounds

    return drive_rounds([gen], GAScalarExecutor(opt))[0]


def gen_cigar(opt: MemOptions, idx: FMIndex, query_seg: np.ndarray,
              rb: int, re: int, w: int
              ) -> tuple[int, list[tuple[int, int]], int, str]:
    """Synchronous gen_cigar_g (scalar DP) — correctness reference."""
    return _drive_one(gen_cigar_g(opt, idx, query_seg, rb, re, w), opt)


# ------------------------------------------------------- dedup + patch ----

def mem_patch_reg_g(opt: MemOptions, idx: FMIndex, query: np.ndarray,
                    a: AlnReg, b: AlnReg):
    """Try to bridge two colinear split regions with one global alignment.
    Generator; returns (score, w) — score 0 means no patch."""
    if a.rb < idx.l_pac <= b.rb:
        return 0, 0
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return 0, 0
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if a.re < b.rb or a.qe < b.qb:  # no overlap
        if w > opt.w * 2 or r >= PATCH_MAX_R_BW:
            return 0, 0
    elif w > opt.w * 4 or r >= PATCH_MAX_R_BW * 2:
        return 0, 0
    w += a.w + b.w
    w = min(w, opt.w * 4)
    score, _, _, _ = yield from gen_cigar_g(
        opt, idx, query[a.qb:b.qe], a.rb, b.re, w)
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb))
              * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb))
              * (b.score + a.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return 0, 0
    return score, w


def sort_dedup_patch_g(opt: MemOptions, idx: FMIndex, query: np.ndarray,
                       regs: list[AlnReg]):
    """mem_sort_dedup_patch: drop redundant overlapping regions, merge
    colinear split regions, remove exact duplicates.  Generator."""
    n = len(regs)
    if n <= 1:
        return regs
    regs = sorted(regs, key=lambda p: p.re)  # by END position
    for p in regs:
        p.n_comp = 1
    for i in range(1, n):
        p = regs[i]
        if (p.rid != regs[i - 1].rid
                or p.rb >= regs[i - 1].re + opt.max_chain_gap):
            continue
        j = i - 1
        while (j >= 0 and p.rid == regs[j].rid
               and p.rb < regs[j].re + opt.max_chain_gap):
            q = regs[j]
            j -= 1
            if q.qe == q.qb:
                continue  # excluded
            o_r = q.re - p.rb
            o_q = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            m_r = min(q.re - q.rb, p.re - p.rb)
            m_q = min(q.qe - q.qb, p.qe - p.qb)
            if (o_r > opt.mask_level_redun * m_r
                    and o_q > opt.mask_level_redun * m_q):
                if p.score < q.score:
                    p.qe = p.qb  # exclude p
                    break
                q.qe = q.qb  # exclude q
            elif q.rb < p.rb:
                score, w = yield from mem_patch_reg_g(opt, idx, query, q, p)
                if score > 0:  # merge q into p
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.qb = q.qb
                    p.rb = q.rb
                    p.truesc = p.score = score
                    p.w = w
                    q.qe = q.qb  # exclude q
    regs = [p for p in regs if p.qe > p.qb]
    # sort by (score desc, rb asc, qb asc); drop identical hits
    regs.sort(key=lambda p: (-p.score, p.rb, p.qb))
    for i in range(1, len(regs)):
        p, q = regs[i], regs[i - 1]
        if p.score == q.score and p.rb == q.rb and p.qb == q.qb:
            p.qe = p.qb
    return [p for i, p in enumerate(regs) if i == 0 or p.qe > p.qb]


def sort_dedup_patch(opt: MemOptions, idx: FMIndex, query: np.ndarray,
                     regs: list[AlnReg]) -> list[AlnReg]:
    """Synchronous sort_dedup_patch_g (scalar DP)."""
    return _drive_one(sort_dedup_patch_g(opt, idx, query, regs), opt)


# ------------------------------------------------------ primary marking ----

def mark_primary(opt: MemOptions, regs: list[AlnReg],
                 read_id: int) -> list[AlnReg]:
    """mem_mark_primary_se: sort by (score, hash), mark shadowed regions
    secondary and accumulate sub/sub_n for MAPQ."""
    if not regs:
        return regs
    for i, p in enumerate(regs):
        p.sub = 0
        p.secondary = -1
        p.secondary_all = -1
        p.hash = hash_64((read_id + i) & ((1 << 64) - 1))
    regs.sort(key=lambda p: (-p.score, p.hash))
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z: list[int] = [0]
    for i in range(1, len(regs)):
        pi = regs[i]
        found = -1
        for k in z:
            pj = regs[k]
            b_max = max(pj.qb, pi.qb)
            e_min = min(pj.qe, pi.qe)
            if e_min > b_max:
                min_l = min(pi.qe - pi.qb, pj.qe - pj.qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if pj.sub == 0:
                        pj.sub = pi.score
                    if pj.score - pi.score <= tmp:
                        pj.sub_n += 1
                    found = k
                    break
        if found < 0:
            z.append(i)
        else:
            pi.secondary = found
    for i, p in enumerate(regs):
        p.secondary_all = p.secondary
    return regs


def approx_mapq_se(opt: MemOptions, a: AlnReg) -> int:
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(sub, a.csub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (l * opt.a - a.score) / (opt.a + opt.b) / l
    if a.score == 0:
        mapq = 0
    else:
        tmp = 1.0 if l < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    mapq = int(mapq * (1.0 - a.frac_rep) + 0.499)
    return mapq


# --------------------------------------------------------------- reg2aln ----

def reg2aln_g(opt: MemOptions, idx: FMIndex, l_query: int,
              query: np.ndarray, ar: AlnReg | None):
    """mem_reg2aln as a generator (yields GAJob via gen_cigar_g)."""
    a = Aln()
    if ar is None or ar.rb < 0 or ar.re < 0:
        a.rid = -1
        a.pos = -1
        a.flag |= samio.FLAG_UNMAP
        return a
    qb, qe = ar.qb, ar.qe
    rb, re = ar.rb, ar.re
    a.mapq = approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= samio.FLAG_SECONDARY
    w2 = max(
        infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del),
        infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins))
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    last_sc = -(1 << 30)
    i = 0
    while True:
        w2 = min(w2, opt.w * 4)
        score, cigar, NM, MD = yield from gen_cigar_g(
            opt, idx, query[qb:qe], rb, re, w2)
        if score == last_sc or w2 == opt.w * 4:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if not (i < 3 and score < ar.truesc - opt.a):
            break
    a.NM = NM
    a.MD = MD
    is_rev = rb >= idx.l_pac
    pos = (rb if rb < idx.l_pac
           else 2 * idx.l_pac - 1 - (re - 1))
    a.is_rev = is_rev
    if cigar:
        # squeeze out leading/trailing deletions
        if cigar[0][0] == 2:
            pos += cigar[0][1]
            cigar = cigar[1:]
        if cigar and cigar[-1][0] == 2:
            cigar = cigar[:-1]
    if qb != 0 or qe != l_query:  # soft clips
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar = [(3, clip5)] + cigar
        if clip3:
            cigar = cigar + [(3, clip3)]
    a.cigar = cigar
    a.rid = idx.pos_to_rid(pos)
    a.pos = pos - idx.contigs[a.rid].offset
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    return a


def reg2aln(opt: MemOptions, idx: FMIndex, l_query: int, query: np.ndarray,
            ar: AlnReg | None) -> Aln:
    """Synchronous reg2aln_g (scalar DP)."""
    return _drive_one(reg2aln_g(opt, idx, l_query, query, ar), opt)


# --------------------------------------------------------------- aln2sam ----

def _cigar_str(cigar, which, softclip_all: bool) -> str:
    if not cigar:
        return "*"
    out = []
    for op, ln in cigar:
        c = op
        if not softclip_all and c in (3, 4):
            c = 4 if which else 3
        out.append(f"{ln}{samio.CIGAR_OPS[c]}")
    return "".join(out)


def _ref_len(cigar) -> int:
    return sum(ln for op, ln in cigar if op in (0, 2))


REVCOMP_TRANS = str.maketrans("ACGTURYSWKMBDHVNacgturyswkmbdhvn",
                              "TGCAAYRSWMKVHDBNtgcaayrswmkvhdbn")


def aln2sam(opt: MemOptions, idx: FMIndex, name: str, seq: str, qual: str,
            n_aln: int, alns: list[Aln], which: int,
            mate: Aln | None = None, extra_flag: int = 0,
            tlen_override: int | None = None) -> samio.SamRecord:
    """mem_aln2sam: build one SAM record."""
    p = dataclasses.replace(alns[which])
    p.cigar = list(alns[which].cigar)
    m = dataclasses.replace(mate) if mate is not None else None
    p.flag |= extra_flag
    if m is not None:
        p.flag |= samio.FLAG_PAIRED
    p.flag |= samio.FLAG_UNMAP if p.rid < 0 else 0
    if m is not None and m.rid < 0:
        p.flag |= samio.FLAG_MUNMAP
    if p.rid < 0 and m is not None and m.rid >= 0:  # copy mate position
        p.rid, p.pos, p.is_rev = m.rid, m.pos, m.is_rev
        p.cigar = []
    if m is not None and m.rid < 0 and p.rid >= 0:
        m.rid, m.pos, m.is_rev = p.rid, p.pos, p.is_rev
        m.cigar = []
    p.flag |= samio.FLAG_REVERSE if p.is_rev else 0
    if m is not None and m.is_rev:
        p.flag |= samio.FLAG_MREVERSE

    rname = idx.contigs[p.rid].name if p.rid >= 0 else "*"
    pos = p.pos + 1 if p.rid >= 0 else 0
    cigar_s = _cigar_str(p.cigar, which, False) if p.rid >= 0 else "*"

    if m is not None and m.rid >= 0:
        rnext = "=" if (p.rid == m.rid) else idx.contigs[m.rid].name
        pnext = m.pos + 1
        if p.rid == m.rid and p.cigar and m.cigar:
            p0 = p.pos + (_ref_len(p.cigar) - 1 if p.is_rev else 0)
            p1 = m.pos + (_ref_len(m.cigar) - 1 if m.is_rev else 0)
            tlen = 0 if not p.cigar or not m.cigar else (
                p1 - p0 - 1 if p0 > p1 else p1 - p0 + 1)
        else:
            tlen = 0
    elif m is not None and p.rid >= 0:
        rnext, pnext, tlen = "=", pos, 0
    else:
        rnext, pnext, tlen = "*", 0, 0
    if tlen_override is not None:
        tlen = tlen_override

    # SEQ/QUAL: secondary -> *; supplementary -> hard-clipped slice
    if p.flag & samio.FLAG_SECONDARY:
        oseq, oqual = "*", "*"
    else:
        qb, qe = 0, len(seq)
        if p.cigar and which and p.rid >= 0:
            if p.cigar[0][0] in (3, 4):
                qb += p.cigar[0][1]
            if p.cigar[-1][0] in (3, 4):
                qe -= p.cigar[-1][1]
        if not p.is_rev:
            oseq = seq[qb:qe]
            oqual = qual[qb:qe] if qual else "*"
        else:
            sub = seq[len(seq) - qe: len(seq) - qb]
            oseq = sub.translate(REVCOMP_TRANS)[::-1]
            oqual = qual[len(seq) - qe: len(seq) - qb][::-1] if qual else "*"

    tags = []
    if p.rid >= 0:
        if p.NM >= 0:
            tags.append(f"NM:i:{p.NM}")
            tags.append(f"MD:Z:{p.MD}")
        if p.score >= 0:
            tags.append(f"AS:i:{p.score}")
            if p.sub >= 0:
                tags.append(f"XS:i:{p.sub}")
    # SA tag: other primary (non-secondary) alignments of this read
    if not (p.flag & samio.FLAG_SECONDARY) and p.rid >= 0:
        others = [r for i2, r in enumerate(alns)
                  if i2 != which and not (r.flag & samio.FLAG_SECONDARY)
                  and r.rid >= 0]
        if others:
            sa = []
            for r in others:
                cig = "".join(f"{ln}{samio.CIGAR_OPS[op]}" for op, ln in r.cigar)
                sa.append(f"{idx.contigs[r.rid].name},{r.pos + 1},"
                          f"{'-' if r.is_rev else '+'},{cig},{r.mapq},{r.NM}")
            tags.append("SA:Z:" + ";".join(sa) + ";")
    if p.XA:
        tags.append(f"XA:Z:{p.XA}")

    return samio.SamRecord(
        qname=name, flag=p.flag, rname=rname, pos=pos, mapq=p.mapq,
        cigar=cigar_s, rnext=rnext, pnext=pnext, tlen=tlen,
        seq=oseq if oseq else "*", qual=oqual, tags=tags)


# ----------------------------------------------------------------- XA ----

def gen_xa_g(opt: MemOptions, idx: FMIndex, regs: list[AlnReg],
             l_query: int, query: np.ndarray):
    """XA strings keyed by primary region index (mem_gen_alt for non-ALT
    references: secondary hits within XA_drop_ratio of their primary).
    Generator."""
    cnt: dict[int, int] = {}
    for i, p in enumerate(regs):
        k = p.secondary_all
        if k >= 0 and p.score >= regs[k].score * opt.XA_drop_ratio:
            cnt[k] = cnt.get(k, 0) + 1
    out: dict[int, list[str]] = {}
    for i, p in enumerate(regs):
        k = p.secondary_all
        if k < 0 or p.score < regs[k].score * opt.XA_drop_ratio:
            continue
        if cnt.get(k, 0) > opt.max_XA_hits:
            continue
        t = yield from reg2aln_g(opt, idx, l_query, query, p)
        cig = "".join(f"{ln}{samio.CIGAR_OPS[op]}" for op, ln in t.cigar)
        s = (f"{idx.contigs[t.rid].name},"
             f"{'-' if t.is_rev else '+'}{t.pos + 1},{cig},{t.NM};")
        out.setdefault(k, []).append(s)
    return {k: "".join(v) for k, v in out.items()}


def gen_xa(opt: MemOptions, idx: FMIndex, regs: list[AlnReg],
           l_query: int, query: np.ndarray) -> dict[int, str]:
    """Synchronous gen_xa_g (scalar DP)."""
    return _drive_one(gen_xa_g(opt, idx, regs, l_query, query), opt)


def se_records_g(opt: MemOptions, idx: FMIndex, name: str, seq: str,
                 qual: str, query: np.ndarray, regs: list[AlnReg],
                 read_id: int):
    """mem_reg2sam for a single-end read.  Generator yielding GAJob."""
    regs = yield from sort_dedup_patch_g(opt, idx, query, regs)
    regs = mark_primary(opt, regs, read_id)
    xa = yield from gen_xa_g(opt, idx, regs, len(seq), query)
    alns: list[Aln] = []
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0:
            continue
        q = yield from reg2aln_g(opt, idx, len(seq), query, p)
        q.XA = xa.get(k)
        if p.secondary >= 0:
            q.sub = -1
        if alns and p.secondary < 0:
            q.flag |= samio.FLAG_SUPPLEMENTARY
        if alns and q.mapq > alns[0].mapq:
            q.mapq = alns[0].mapq
        alns.append(q)
    if not alns:
        t = yield from reg2aln_g(opt, idx, len(seq), query, None)
        return [aln2sam(opt, idx, name, seq, qual, 1, [t], 0)]
    return [aln2sam(opt, idx, name, seq, qual, len(alns), alns, k)
            for k in range(len(alns))]


def se_records(opt: MemOptions, idx: FMIndex, name: str, seq: str,
               qual: str, query: np.ndarray, regs: list[AlnReg],
               read_id: int) -> list[samio.SamRecord]:
    """Synchronous se_records_g (scalar DP)."""
    return _drive_one(
        se_records_g(opt, idx, name, seq, qual, query, regs, read_id), opt)
