"""Flat columnar SAM finalization (port of ``tpubwa.align.flatsam``).

Reads are processed as columnar numpy + a few device calls + one native
emit:

  * `select_se` — the flat tier's selection of a whole batch in one
    native call (native/flatsel.cpp, shared with the PE selection):
    sort_dedup + mark_primary in the single-primary fast case, the XA
    group, and the test that every emitted lane fits the flat windows
  * `flat_core` — the shared per-lane pipeline (records AND their XA
    alternates are "lanes"): device window gathers, vectorized
    band-width/retry control (replicas of infer_bw and reg2aln_g's
    band-doubling loop), device-RLE'd cigars, vectorized edge-deletion
    squeeze, NM/MD inputs from a device mismatch pack
  * SAM text: ONE native call (native/samemit.cpp) renders every record

Two tiers: the flat tier above, and the per-read generator tier for
everything else (patch-triggering region geometry, multiple primaries /
supplementary alignments, lanes outside the windows, cigar-pack
overflow), whose output is identical by construction.

The device halves (`_flat_windows`, `_gather_rows`) are torch ops and
`_ga_rows` is one kernel launch on a CUDA device; the host functions are
carried over from the JAX package (its module imports jax), changed only
where they called into jax.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tpubwa_torch.align import finalize
from tpubwa_torch.align.region import read_regions
from tpubwa_torch.config import NARROW, MemOptions, Widths, batch_widths
from tpubwa_torch.native import as_ptr, load_native
from tpubwa_torch.ops import global_align_cuda
from tpubwa_torch.ops.fm import DeviceIndex, ref_window_right
from tpubwa_torch.ops.global_align import global_align_cigar_batch
from tpubwa_torch.utils.rounds import drive_rounds
from tpubwa_torch.utils.timers import count

# the narrow bucket's window pads; a batch runs at its bucket's
# (``config.Widths`` sam_q, sam_t)
QPAD = NARROW.sam_q     # query window pad (== GA bucket Q)
TWIN = NARROW.sam_t     # reference window pad (== GA bucket T)


def _trunci(x) -> np.ndarray:
    """float -> int with Python int() semantics (truncate toward zero)."""
    return np.trunc(x).astype(np.int64)


def _log_exact(l: np.ndarray) -> np.ndarray:
    """math.log per distinct integer value (bit-exact vs the scalar path;
    numpy's SIMD log may differ by an ulp)."""
    ul, inv = np.unique(l, return_inverse=True)
    logs = np.array([math.log(float(v)) for v in ul], dtype=np.float64)
    return logs[inv]


def _infer_bw_vec(l1, l2, score, a: int, q: int, r: int) -> np.ndarray:
    """finalize.infer_bw, vectorized."""
    w = _trunci((np.minimum(l1, l2) * a - score - q) / r + 2.0)
    w = np.maximum(w, np.abs(l1 - l2))
    zero = (l1 == l2) & (l1 * a - score < (q + r - a) * 2)
    return np.where(zero, 0, w)


MM_K = 24   # per-lane mismatch pack capacity (150bp @ a few % error)


def _flat_windows(di: DeviceIndex, codes, rd, qb, lq, rb, rlen, rev, *,
                  q_pad: int, t_win: int, a: int, b: int, mm_k: int = MM_K):
    """Device half of the flat finalize: build the SAM/DP-oriented query
    and reference window buffers (genome-forward; revcomp'd rows for rev
    hits), plus the exact-match score, mismatch count, and a compacted
    mismatch pack (positions + reference letters).

    Returns (qD int8 [N, q_pad], tD int8 [N, t_win], pack int16
    [N, 2+mm_k] = score, nm, (letter<<8 | pos))."""
    I32 = torch.int32
    I16 = torch.int16
    dev = codes.device
    L = codes.shape[1]
    qg = codes[rd].to(I32)                                   # [N, L]
    jq = torch.arange(q_pad, dtype=I32, device=dev)[None, :]
    qF = qg.gather(1, (qb[:, None] + jq).clamp(max=L - 1).to(torch.int64))
    qmask = jq < lq[:, None]
    qF = torch.where(qmask, qF, 4)

    def revrows(arr, ln, P):
        j = torch.arange(P, dtype=I32, device=dev)[None, :]
        idx = (ln[:, None] - 1 - j).clamp(0, P - 1).to(torch.int64)
        return arr.gather(1, idx)

    def comp(x):
        return torch.where(x < 4, 3 - x, x)

    rev_c = rev[:, None]
    qD = torch.where(rev_c, comp(revrows(qF, lq, q_pad)), qF)
    qD = torch.where(qmask, qD, 4)

    W = ref_window_right(di, rb, t_win)                 # [N, t_win] 2l-asc
    jt = torch.arange(t_win, dtype=I32, device=dev)[None, :]
    tmask = jt < rlen[:, None]
    W = torch.where(tmask, W, 4)
    tD = torch.where(rev_c, comp(revrows(W, rlen, t_win)), W)
    tD = torch.where(tmask, tD, 4)

    # exact-match pairing (orientation-invariant): bwa_fill_scmat values
    # are {match: a, mismatch: -b, N: -1}
    tq = W[:, :q_pad]
    pair = torch.where(qF >= 4, -1, torch.where(tq == qF, a, -b))
    exact_score = torch.where(qmask, pair, 0).sum(dim=1)
    mm = qmask & ((qD != tD[:, :q_pad]) | (qD >= 4))
    nm = mm.sum(dim=1)
    # compacted mismatch pack: first mm_k mismatch columns, ascending
    key = torch.where(mm, jq, q_pad + 1)
    pos = torch.sort(key, dim=1).values[:, :mm_k]
    let = tD[:, :q_pad].gather(1, pos.clamp(max=q_pad - 1).to(torch.int64))
    packed = torch.cat(
        [exact_score.to(I16)[:, None], nm.to(I16)[:, None],
         (let.to(I16) << 8) | pos.to(I16)], dim=1)
    return qD.to(torch.int8), tD.to(torch.int8), packed


GA_K = 24   # per-lane cigar-segment pack capacity


def _ga_rows(qD, tD, rows, qlen, tlen, w, mat, *, o_del: int, e_del: int,
             o_ins: int, e_ins: int, ga_k: int = GA_K):
    """Global alignment over device-resident window buffers for the
    requested lanes: DP fill, traceback and run-length encoding into a
    compact int16 [M, 2+ga_k] pack (col0 score, col1 nseg, then
    (len<<2 | op) per cigar segment in CIGAR order; all segments zero
    when nseg > ga_k).  Lanes with nseg > ga_k are re-rendered by the
    caller via the generator path.  One launch of the CUDA kernel
    (``csrc/global_align.cu``) for CUDA tensors, ``_ga_rows_plain`` for CPU
    tensors."""
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins, ga_k=ga_k)
    if qD.device.type == "cpu":
        return _ga_rows_plain(qD, tD, rows, qlen, tlen, w, mat, **kw)
    return global_align_cuda.ga_pack(qD, tD, rows, qlen, tlen, w, mat, **kw)


def _ga_rows_plain(qD, tD, rows, qlen, tlen, w, mat, *, o_del: int,
                   e_del: int, o_ins: int, e_ins: int, ga_k: int = GA_K):
    """The plain version of ``_ga_rows``: gather the lanes, run the
    batched DP + traceback as torch ops, and run-length-encode the step
    rows on the device."""
    I32 = torch.int32
    I16 = torch.int16
    dev = qD.device
    res = global_align_cigar_batch(
        qD[rows].to(I32), qlen, tD[rows].to(I32), tlen, mat, w,
        o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins)
    s = res.steps.to(I32)                               # [M, S] ops, 3 = end
    M = s.shape[0]
    valid = s != 3
    prev = torch.cat([torch.full((M, 1), -1, dtype=I32, device=dev),
                      s[:, :-1]], dim=1)
    newseg = valid & (s != prev)
    segid = torch.where(valid, torch.cumsum(newseg.to(I32), dim=1), 0)
    nseg = newseg.sum(dim=1, dtype=I32)                 # [M]
    dst = segid.clamp(max=ga_k + 1).to(torch.int64)     # slot 0 unused
    lens = torch.zeros((M, ga_k + 2), dtype=I32, device=dev).scatter_add(
        1, dst, valid.to(I32))
    ops = torch.zeros((M, ga_k + 2), dtype=I32, device=dev).scatter_reduce(
        1, dst, torch.where(valid, s, 0), "amax")
    # steps come out in traceback (reverse) order; cigar segment c is
    # steps-segment (nseg - c)
    c = torch.arange(ga_k, dtype=I32, device=dev)[None, :]
    src = (nseg[:, None] - c).clamp(0, ga_k + 1).to(torch.int64)
    in_rng = (c < nseg[:, None]) & (nseg[:, None] <= ga_k)
    seg = torch.where(in_rng,
                      (lens.gather(1, src) << 2) | ops.gather(1, src), 0)
    return torch.cat([res.score.to(I16)[:, None], nseg.to(I16)[:, None],
                      seg.to(I16)], dim=1)


def _gather_rows(qD, tD, rows):
    """Row-gather of the device window buffers (for gapped cigars' NM/MD
    and for mismatch packs that overflowed MM_K)."""
    return qD[rows], tD[rows]


def mapq_se_vec(opt: MemOptions, lq, rlen, score, frac, sub, csub,
                sub_n=None) -> np.ndarray:
    """finalize.approx_mapq_se vectorized (exact integer/float ordering
    preserved, including the sub_n penalty's pre-clamp position)."""
    a_, b_ = opt.a, opt.b
    sub_e = np.where(sub == 0, opt.min_seed_len * a_, sub)
    sub_e = np.maximum(sub_e, csub)
    lmax = np.maximum(lq, rlen)
    identity = 1.0 - (lmax * a_ - score) / (a_ + b_) / lmax
    tmp = np.where(lmax < opt.mapQ_coef_len, 1.0,
                   opt.mapQ_coef_fac / _log_exact(lmax))
    tmp = tmp * identity * identity
    mapq = _trunci(6.02 * (score - sub_e) / a_ * tmp * tmp + 0.499)
    mapq = np.where(score == 0, 0, mapq)
    if sub_n is not None:
        pen = _trunci(4.343 * _log_exact(sub_n + 1) + 0.499)
        mapq = mapq - np.where(sub_n > 0, pen, 0)
    mapq = np.maximum(np.minimum(mapq, 60), 0)
    mapq = _trunci(mapq * (1.0 - frac) + 0.499)
    return np.where(sub_e >= score, 0, mapq)


def flat_core(aligner, codes_dev, rd, L, rb, re, qb, qe, truesc, aw,
              widths: Widths):
    """The shared flat-record pipeline for N selected single regions:
    device windows -> band-doubling GA retry -> columnar cigars ->
    edge-deletion squeeze -> NM/MD inputs.

    rd indexes rows of codes_dev; all other inputs are int64 [N] columns.
    The windows are the batch's bucket's (`widths`: ``sam_q`` x
    ``sam_t``), which every lane's geometry fits (``select_se`` /
    ``pair.select_flat``).
    Returns a dict of emission columns; ``ok`` is False for lanes whose
    cigar overflowed the GA_K pack (callers re-render those via the
    generator path)."""
    opt: MemOptions = aligner.opt
    put = aligner._put
    l_pac = aligner.idx.l_pac
    offs = aligner.contig_offsets
    a_ = opt.a
    N = rd.size
    lq = qe - qb
    rlen = re - rb
    rev = rb >= l_pac
    pos0 = np.where(rev, 2 * l_pac - re, rb)      # genome-forward, 0-based
    rid = np.searchsorted(offs, pos0, side="right") - 1

    # band for the final global alignment (reg2aln_g)
    w2 = np.maximum(
        _infer_bw_vec(lq, rlen, truesc, a_, opt.o_del, opt.e_del),
        _infer_bw_vec(lq, rlen, truesc, a_, opt.o_ins, opt.e_ins))
    w2 = np.where(w2 > opt.w, np.minimum(w2, aw), w2)

    # device half: oriented query/ref window buffers + exact score + NM
    qDj, tDj, pkj = _flat_windows(
        aligner.di, codes_dev, put(rd.astype(np.int64)),
        put(qb.astype(np.int32)), put(lq.astype(np.int32)),
        put(rb.astype(np.int64)), put(rlen.astype(np.int32)), put(rev),
        q_pad=widths.sam_q, t_win=widths.sam_t, a=opt.a, b=opt.b)

    def run_ga(rows, w_cap):
        """One _ga_rows round for lanes `rows` (band cap w_cap)."""
        lqr, rlr = lq[rows], rlen[rows]
        max_ins = _trunci((((lqr + 1) >> 1) * a_ - opt.o_ins)
                          / opt.e_ins + 1.0)
        max_del = _trunci((((lqr + 1) >> 1) * a_ - opt.o_del)
                          / opt.e_del + 1.0)
        max_gap = np.maximum(np.maximum(max_ins, max_del), 1)
        ww = (max_gap + np.abs(rlr - lqr) + 1) >> 1
        ww = np.minimum(ww, w_cap)
        ww = np.maximum(ww, np.abs(rlr - lqr) + 3)
        pk = _ga_rows(
            qDj, tDj, put(rows.astype(np.int64)), put(lqr.astype(np.int32)),
            put(rlr.astype(np.int32)), put(ww.astype(np.int32)),
            aligner.mat_dev, o_del=opt.o_del, e_del=opt.e_del,
            o_ins=opt.o_ins, e_ins=opt.e_ins)
        return pk.cpu().numpy().astype(np.int64)

    maxw = opt.w * 4
    pk = pkj.cpu().numpy().astype(np.int64)
    exact_score = pk[:, 0]
    nm_dev = pk[:, 1]
    mm_pos = pk[:, 2:] & 0xFF
    mm_let = (pk[:, 2:] >> 8) & 0x7

    # reg2aln_g's band-doubling retry loop, on shrinking subsets.  Cigars
    # stay COLUMNAR: segs [N, GA_K] of (len<<2 | op) in cigar order +
    # nseg [N] (-1 = pack overflow -> generator re-render).
    segs = np.zeros((N, GA_K), np.int32)
    segs[:, 0] = (lq << 2).astype(np.int32)
    nseg = np.ones(N, np.int32)
    last_sc = np.full(N, -(1 << 30), np.int64)
    active = np.arange(N)
    it = 0
    while active.size:
        w_eff = np.minimum(w2[active], maxw)
        sc_it = np.empty(active.size, np.int64)
        exact = (lq[active] == rlen[active]) & (w_eff == 0)
        eidx = np.flatnonzero(exact)
        if eidx.size:
            rows = active[eidx]
            sc_it[eidx] = exact_score[rows]
            segs[rows] = 0
            segs[rows, 0] = (lq[rows] << 2).astype(np.int32)
            nseg[rows] = 1
        didx = np.flatnonzero(~exact)
        if didx.size:
            rows = active[didx]
            gp = run_ga(rows, w_eff[didx])
            sc_it[didx] = gp[:, 0]
            gn = gp[:, 1].astype(np.int32)
            fit = gn <= GA_K
            rf = rows[fit]
            segs[rf] = gp[fit, 2:2 + GA_K].astype(np.int32)
            nseg[rf] = gn[fit]
            nseg[rows[~fit]] = -1
        done = (sc_it == last_sc[active]) | (w_eff == maxw)
        last_sc[active] = sc_it
        w2[active] = w_eff << 1
        it += 1
        cont = (~done) & (it < 3) & (sc_it < truesc[active] - a_)
        active = active[cont]

    ok = nseg >= 0
    nseg = np.maximum(nseg, 0)

    # NM/MD classification uses the PRE-squeeze cigar (the generator path
    # computes NM/MD before squeezing edge deletions)
    pure_m = (nseg == 1) & ((segs[:, 0] & 3) == 0) & ok
    need = ~pure_m | (nm_dev > MM_K)
    win_row = np.full(N, -1, np.int32)
    qh = th = None
    nr = np.flatnonzero(need)
    if nr.size:
        qhj, thj = _gather_rows(qDj, tDj, put(nr.astype(np.int64)))
        qh = qhj.cpu().numpy()
        th = thj.cpu().numpy()
        win_row[nr] = np.arange(nr.size, dtype=np.int32)
    nm_in = np.where(pure_m & (nm_dev <= MM_K), nm_dev,
                     -1).astype(np.int32)

    # edge-deletion squeeze + pos/rid re-resolution, vectorized; the
    # squeezed deletion lengths still count for NM/MD (generator parity),
    # so they're carried separately (lead_d/trail_d)
    pos = pos0.copy()
    lead_d = np.zeros(N, np.int32)
    trail_d = np.zeros(N, np.int32)
    lead = (nseg > 0) & ((segs[:, 0] & 3) == 2)
    if lead.any():
        lr = np.flatnonzero(lead)
        lead_d[lr] = segs[lr, 0] >> 2
        pos[lr] += segs[lr, 0] >> 2
        segs[lr, :-1] = segs[lr, 1:]
        segs[lr, -1] = 0
        nseg[lr] -= 1
        # the squeeze can move pos past a contig boundary: re-resolve rid
        # from the adjusted position (finalize.reg2aln_g resolves rid
        # after the squeeze)
        rid[lr] = np.searchsorted(offs, pos[lr], side="right") - 1
    last_i = np.maximum(nseg - 1, 0)
    tl = (nseg > 0) & ((segs[np.arange(N), last_i] & 3) == 2)
    if tl.any():
        tr = np.flatnonzero(tl)
        trail_d[tr] = segs[tr, last_i[tr]] >> 2
        nseg[tr] -= 1
    p1 = pos - offs[rid] + 1

    clip5 = np.where(rev, L - qe, qb).astype(np.int32)
    clip3 = np.where(rev, qb, L - qe).astype(np.int32)
    # reference span of the POST-squeeze cigar (aln2sam's _ref_len; TLEN)
    reflen = rlen - lead_d - trail_d
    return dict(ok=ok, segs=segs, nseg=nseg, lead_d=lead_d,
                trail_d=trail_d, p1=p1, rid=rid, rev=rev, clip5=clip5,
                clip3=clip3, nm_in=nm_in, mm_pos=mm_pos, mm_let=mm_let,
                lq=lq, rlen=rlen, win_row=win_row, qh=qh, th=th,
                reflen=reflen)


# flat_core's per-lane columns (the PE path merges two cores by these)
_CORE_LANE_KEYS = ("segs", "nseg", "lead_d", "trail_d", "p1", "rid",
                   "rev", "clip5", "clip3", "nm_in", "mm_pos", "mm_let",
                   "lq", "rlen", "win_row", "reflen")


def _concat_strs(strs):
    """Concatenate strings into (bytes, int64 offsets[len+1])."""
    enc = [s.encode() for s in strs]
    off = np.zeros(len(enc) + 1, np.int64)
    if enc:
        off[1:] = np.cumsum([len(e) for e in enc])
    return b"".join(enc), off


def emit_flat(aligner, names, seqs, quals, other, core: dict,
              rec: dict) -> str:
    """Render the full output text: flat records (per-record columns in
    `rec`: b/lane/flag/mapq/score/xs/rnext/pnext/tlen/alt_lo/alt_hi,
    ascending rec b; per-lane cigar/NM columns in `core` cover records
    AND their XA alternate lanes) interleaved with pre-rendered `other`
    row text.  One native call assembles every flat record's line
    (NM/MD, cigar strings, XA alternates, revcomp, field formatting) and
    splices the non-flat rows in row order (native/samemit.cpp).  Raises
    RuntimeError when a record's MD string overflows the emitter's
    buffer, which no lane in the flat windows can reach."""
    import ctypes

    lib = load_native()
    B = len(other)
    NL = core["rid"].size
    NR = rec["b"].size
    c = ctypes
    u8p = c.POINTER(c.c_uint8)

    def bptr(buf: bytes):
        return c.cast(c.c_char_p(buf), u8p)

    i32p = c.POINTER(c.c_int32)
    i64p = c.POINTER(c.c_int64)
    i8p = c.POINTER(c.c_int8)

    name_buf, name_off = _concat_strs(names)
    seq_buf, seq_off = _concat_strs(seqs)
    qual_buf, qual_off = _concat_strs([q or "" for q in quals])
    other_buf, other_off = _concat_strs([t or "" for t in other])
    cname_buf, cname_off = _concat_strs(
        [ct.name for ct in aligner.idx.contigs])

    holds = []  # keep converted arrays alive through the call

    def A(arr, dtype, pt):
        a = np.ascontiguousarray(arr, dtype=dtype)
        holds.append(a)
        return a.ctypes.data_as(pt)

    qh, th = core["qh"], core["th"]
    if qh is None:   # no lane reads a window row
        qh = th = np.zeros((1, 1), np.int8)
    cap = (len(other_buf) + len(name_buf) + 2 * len(seq_buf)
           + len(qual_buf) + NR * 160 + NL * 48 + 4096)
    outb = np.empty(cap, np.uint8)
    args = [
        c.c_int64(B),
        bptr(other_buf), A(other_off, np.int64, i64p),
        bptr(name_buf), A(name_off, np.int64, i64p),
        bptr(seq_buf), A(seq_off, np.int64, i64p),
        bptr(qual_buf), A(qual_off, np.int64, i64p),
        bptr(cname_buf), A(cname_off, np.int64, i64p),
        c.c_int64(NL),
        A(core["rev"], np.uint8, u8p), A(core["rid"], np.int32, i32p),
        A(core["p1"], np.int64, i64p),
        A(core["clip5"], np.int32, i32p), A(core["clip3"], np.int32, i32p),
        A(core["nseg"], np.int32, i32p), A(core["segs"], np.int32, i32p),
        c.c_int64(GA_K),
        A(core["lead_d"], np.int32, i32p),
        A(core["trail_d"], np.int32, i32p),
        A(core["nm_in"], np.int32, i32p),
        A(core["mm_pos"], np.uint8, u8p), A(core["mm_let"], np.uint8, u8p),
        c.c_int64(MM_K),
        A(core["lq"], np.int32, i32p), A(core["rlen"], np.int32, i32p),
        A(core["win_row"], np.int32, i32p),
        A(qh, np.int8, i8p), A(th, np.int8, i8p),
        c.c_int64(qh.shape[1]), c.c_int64(th.shape[1]),
        c.c_int64(NR),
        A(rec["b"], np.int32, i32p), A(rec["lane"], np.int32, i32p),
        A(rec["flag"], np.int32, i32p), A(rec["mapq"], np.int32, i32p),
        A(rec["score"], np.int32, i32p), A(rec["xs"], np.int32, i32p),
        A(rec["rnext"], np.int32, i32p), A(rec["pnext"], np.int64, i64p),
        A(rec["tlen"], np.int64, i64p),
        A(rec["alt_lo"], np.int32, i32p), A(rec["alt_hi"], np.int32, i32p),
        outb.ctypes.data_as(u8p), c.c_int64(cap),
    ]
    ret = lib.sam_emit_se(*args)
    if ret < 0:   # -1 - r: record r's MD string overflowed
        r = -1 - ret
        raise RuntimeError(
            f"sam_emit_se: the MD string of record {r} (read "
            f"{names[int(rec['b'][r])]}) overflowed its buffer")
    if ret > cap:
        outb = np.empty(ret, np.uint8)
        args[-2] = outb.ctypes.data_as(u8p)
        args[-1] = c.c_int64(ret)
        ret = lib.sam_emit_se(*args)
    return outb[:ret].tobytes().decode()


# select_se's tiers (native/flatsel.cpp)
UNMAPPED, FLAT, GENERATOR = 0, 1, 2


def select_se(opt: MemOptions, fields: dict, bounds: np.ndarray,
              read_id0: int, l_pac: int, widths: Widths) -> dict:
    """The flat tier's selection for an SE batch's region columns
    (``flatext.finalize_fields``' fields and bounds [B + 1]), in one
    native call (``native/flatsel.cpp::se_select_flat``).  By read:
    ``tier`` (``UNMAPPED``, ``FLAT`` or ``GENERATOR``); where flat, the
    primary's row ``prim`` (-1 elsewhere), its mark_primary ``sub`` and
    ``sub_n`` and its XA alternates ``alt_cnt``, whose rows fill
    ``alt_rows`` in read order.  The rules are those of the native
    entry's header; the regions are not touched."""
    cols = ("rb", "re", "qb", "qe", "rid", "score")
    bounds = np.ascontiguousarray(bounds, np.int64)
    B = bounds.size - 1
    n = int(bounds[-1]) if B >= 0 else 0
    if (B < 0 or bounds[0] != 0 or (np.diff(bounds) < 0).any()
            or any(len(fields[f]) < n for f in cols)):
        raise ValueError("region columns do not match their bounds")
    ins = [np.ascontiguousarray(fields[f][:n], np.int64) for f in cols]
    i64 = lambda k: np.zeros(k, np.int64)  # noqa: E731
    out = dict(tier=np.zeros(B, np.uint8), prim=i64(B), sub=i64(B),
               sub_n=i64(B), alt_cnt=i64(B), alt_rows=i64(max(n, 1)))
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    n_alt = load_native().se_select_flat(
        B, as_ptr(bounds), *map(as_ptr, ins), l_pac, opt.mask_level, tmp,
        opt.T, opt.XA_drop_ratio, opt.max_XA_hits, opt.max_chain_gap,
        widths.sam_q, widths.sam_t, read_id0,
        *(as_ptr(out[k]) for k in ("tier", "prim", "sub", "sub_n",
                                   "alt_cnt", "alt_rows")))
    out["alt_rows"] = out["alt_rows"][:n_alt]
    return out


def records_ok(ok: np.ndarray, n_rec: int, alt_off: np.ndarray,
               alt_cnt: np.ndarray) -> np.ndarray:
    """By record: its lane (``ok[:n_rec]``) and every one of its XA
    lanes (``ok[n_rec + alt_off : n_rec + alt_off + alt_cnt]``) packed
    their cigars."""
    n_bad = np.concatenate([[0], np.cumsum(~ok[n_rec:])])
    return ok[:n_rec] & (n_bad[alt_off + alt_cnt] == n_bad[alt_off])


def se_text_batch(aligner, batch, read_id0: int, fields: dict,
                  bounds: np.ndarray, codes_dev=None) -> str:
    """SAM text for a ReadBatch from flat region arrays (fields/bounds as
    returned by flatext.finalize_fields).  codes_dev: the device-resident
    read batch from seeding (re-uploaded if absent).  The flat tier runs
    at the batch's bucket (``config.batch_widths`` of its width).

    Two tiers, chosen by ``select_se``: the flat tier (columnar, with
    XS/XA from the same flat_core lanes) and the generator tier for
    everything else; both byte-identical to the generator pipeline."""
    opt: MemOptions = aligner.opt
    idx = aligner.idx
    B = batch.n
    widths = batch_widths(opt, batch.codes.shape[1])
    lens = np.asarray(batch.lens[:B], dtype=np.int64)
    sel = select_se(opt, fields, bounds, read_id0, idx.l_pac, widths)
    tier = sel["tier"]

    out: list[str] = [""] * B
    for b in np.flatnonzero(tier == UNMAPPED).tolist():
        q = batch.quals[b] or "*"
        out[b] = (f"{batch.names[b]}\t4\t*\t0\t0\t*\t*\t0\t0\t"
                  f"{batch.seqs[b]}\t{q}\n")

    # ---- flat lanes: every flat read's primary in read order, then the
    # XA alternates ----
    flat = np.flatnonzero(tier == FLAT)
    gen = tier == GENERATOR
    N = flat.size
    rec = None
    if N:
        if codes_dev is None:
            codes_dev = aligner._put(np.asarray(batch.codes, np.int32))
        pj = sel["prim"][flat]
        acnt = sel["alt_cnt"][flat]
        alt_off = np.cumsum(acnt) - acnt
        j_lanes = np.concatenate([pj, sel["alt_rows"]])
        b_lanes = np.concatenate([flat, np.repeat(flat, acnt)])
        core = flat_core(aligner, codes_dev, b_lanes, lens[b_lanes],
                         *(fields[f][j_lanes].astype(np.int64)
                           for f in ("rb", "re", "qb", "qe", "truesc", "w")),
                         widths)
        # GA cigar-pack overflow: fail the whole READ to the generators
        ok = records_ok(core["ok"], N, alt_off, acnt)
        gen[flat[~ok]] = True
        score = fields["score"][pj].astype(np.int64)
        sub = sel["sub"][flat]
        mapq = mapq_se_vec(opt, core["lq"][:N], core["rlen"][:N], score,
                           fields["frac_rep"][pj], sub,
                           np.zeros(N, np.int64), sel["sub_n"][flat])
        n_ok = int(ok.sum())
        rec = dict(
            b=flat[ok], lane=np.flatnonzero(ok),
            flag=np.where(core["rev"][:N][ok], 16, 0).astype(np.int32),
            mapq=mapq[ok], score=score[ok], xs=sub[ok],
            rnext=np.full(n_ok, -1, np.int32),
            pnext=np.zeros(n_ok, np.int64), tlen=np.zeros(n_ok, np.int64),
            alt_lo=(N + alt_off)[ok], alt_hi=(N + alt_off + acnt)[ok])

    # ---- generator tier ----
    gen_rows = np.flatnonzero(gen).tolist()
    count(aligner.timers, "sam.generator_reads", len(gen_rows))
    if gen_rows:
        gens = [
            finalize.se_records_g(
                opt, idx, batch.names[b], batch.seqs[b], batch.quals[b],
                batch.codes[b, : batch.lens[b]],
                read_regions(fields, bounds, b), read_id0 + b)
            for b in gen_rows
        ]
        for b, recs in zip(gen_rows,
                           drive_rounds(gens, aligner.ga_exec)):
            out[b] = "".join(r.line() + "\n" for r in recs)

    if rec is None or rec["b"].size == 0:
        return "".join(out)
    return emit_flat(aligner, batch.names[:B], batch.seqs[:B],
                     batch.quals[:B], out, core, rec)
