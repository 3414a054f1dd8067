"""The SE flat tier's selection in one native call (``flatsam.select_se``,
``native/flatsel.cpp::se_select_flat``) against the numpy code it
replaced: ``classify_multi`` for reads of two or more regions and
``se_text_batch``'s rule for reads of one (both kept here, verbatim, as
the reference), with exact equality of every output: each read's tier,
and for each flat read its primary's row, its ``sub`` and ``sub_n`` and
its XA rows.  At the narrow widths the multi-region reads are also held
to the JAX package's ``tpubwa.align.flatsam.classify_multi``.

The batches are seeded synthetic region columns in the layout of
``flatext.finalize_fields`` (capacity past the last bound), one case a
parameter: narrow and wide widths, score ties, second primaries,
primaries under ``T``, lanes straddling ``l_pac``, XA groups at and over
``max_XA_hits``, regions within ``max_chain_gap`` (sort_dedup's patch
loop), exact duplicates, single-region reads, empty reads and read ids
past 2^31.
"""
import numpy as np
import pytest

from tpubwa_torch.align import flatsam
from tpubwa_torch.config import NARROW, WIDE, MemOptions, Widths

L_PAC = 3_000_000
OFFS = np.array([0, 1_000_000, 2_000_000])
MCG = MemOptions().max_chain_gap

BASE = dict(B=400, read_len=150, widths=NARROW, n_max=5, p_empty=0.05,
            p_single=0.3, p_second=0.08, p_subT=0.04, p_straddle=0.0,
            p_long=0.1, score_set=None, n_xa=0, p_near=0.0, p_dup=0.0,
            p_triple=0.0, read_id0=0, max_xa=5)
CASES = {
    "narrow": {},
    "wide": dict(read_len=250, widths=WIDE, p_long=0.15),
    "ties": dict(score_set=(60, 60, 61, 58)),
    "second_primaries": dict(p_second=0.4),
    "sub_T_primaries": dict(p_subT=0.4),
    "straddle_l_pac": dict(p_straddle=0.3),
    "xa_at_and_over_cap": dict(n_xa=4, max_xa=5),
    "patch_within_chain_gap": dict(p_near=0.3, p_triple=0.3),
    "exact_duplicates": dict(p_dup=0.5),
    "single_region": dict(p_single=0.9, p_long=0.2, p_subT=0.2,
                          p_straddle=0.1),
    "empty_reads": dict(p_empty=0.5),
    "large_read_ids": dict(read_id0=(1 << 31) + 12_345,
                           score_set=(90, 90)),
}
NARROW_CASES = [k for k in CASES if CASES[k].get("widths", NARROW) is NARROW]


# ---- the reference: flatsam's numpy selection as it was ----

def hash64_vec(key: np.ndarray) -> np.ndarray:
    """finalize.hash_64 (Wang 64-bit mix), vectorized on uint64."""
    u = np.uint64
    k = key.astype(np.uint64)
    k = k + ~(k << u(32))
    k ^= k >> u(22)
    k = k + ~(k << u(13))
    k ^= k >> u(8)
    k = k + (k << u(3))
    k ^= k >> u(15)
    k = k + ~(k << u(27))
    k ^= k >> u(31)
    return k


def flat_geom(lq, rlen, rb, re, l_pac: int, widths: Widths):
    """Lanes whose region fits the flat tier's windows (``widths``) and
    does not straddle the forward/reverse boundary."""
    return ((lq > 0) & (rlen > 0) & (lq <= widths.sam_q)
            & (rlen <= widths.sam_t) & ~((rb < l_pac) & (l_pac < re)))


def classify_multi(opt: MemOptions, fields: dict, bounds: np.ndarray,
                   rows: np.ndarray, read_id0: int, l_pac: int,
                   widths: Widths):
    """Columnar sort_dedup + mark_primary for reads with >= 2 regions —
    the single-primary fast case (every non-primary region shadowed by
    the primary: bwa's z-list stays [0]).

    Exact-semantics subset: reads whose region geometry could trigger
    sort_dedup's redundancy/patch inner loop, or that produce a second
    primary (supplementary alignments), or whose primary/XA lanes are not
    flat-eligible, are returned as fallback for the generator path.

    Returns a dict of per-read columns over `rows`:
      good   : handled here (record or unmapped)
      unmap  : good reads whose primary score < T
      prim_j : primary's region row in `fields` (valid where good)
      sub, sub_n : mark_primary outputs for the MAPQ formula
      alt_j  : flattened XA alternate region rows (reads in `rows` order,
               gen_xa order within read), alt_cnt per read
    """
    mcg = opt.max_chain_gap
    cnts = (bounds[rows + 1] - bounds[rows]).astype(np.int64)
    tot = int(cnts.sum())
    starts = bounds[rows].astype(np.int64)
    base = np.cumsum(cnts) - cnts
    offs_in = np.arange(tot, dtype=np.int64) - np.repeat(base, cnts)
    reg_j = np.repeat(starts, cnts) + offs_in
    grp = np.repeat(np.arange(rows.size, dtype=np.int64), cnts)
    sc = fields["score"][reg_j].astype(np.int64)
    rb = fields["rb"][reg_j].astype(np.int64)
    re_ = fields["re"][reg_j].astype(np.int64)
    qb = fields["qb"][reg_j].astype(np.int64)
    qe = fields["qe"][reg_j].astype(np.int64)
    rid = fields["rid"][reg_j].astype(np.int64)

    bad = np.zeros(rows.size, bool)

    # --- 1. would sort_dedup's redundancy/patch loop run? (regions
    # adjacent in (read, re) order closer than max_chain_gap) ---
    o1 = np.lexsort((re_, grp))
    adj = grp[o1][1:] == grp[o1][:-1]
    trig = adj & (rid[o1][1:] == rid[o1][:-1]) & (
        rb[o1][1:] < re_[o1][:-1] + mcg)
    bad[grp[o1][1:][trig]] = True

    # --- 2. final sort (-score, rb, qb) + exact-duplicate drop ---
    o2 = np.lexsort((qb, rb, -sc, grp))
    g2, s2 = grp[o2], sc[o2]
    r2, q2 = rb[o2], qb[o2]
    dup = np.zeros(tot, bool)
    dup[1:] = ((g2[1:] == g2[:-1]) & (s2[1:] == s2[:-1])
               & (r2[1:] == r2[:-1]) & (q2[1:] == q2[:-1]))
    keep = ~dup
    k2 = keep.astype(np.int64)
    csum = np.cumsum(k2)
    first = np.zeros(tot, bool)
    first[0] = True
    first[1:] = g2[1:] != g2[:-1]
    seg_base = np.maximum.accumulate(np.where(first, csum - k2, -1))
    rank = csum - k2 - seg_base           # dedup-compacted index i

    # --- 3. mark_primary order: (-score, hash_64(read_id + i)) ---
    h = hash64_vec(read_id0 + rows[g2] + rank)
    kidx = np.flatnonzero(keep)
    g3s, s3s, h3s = g2[kidx], s2[kidx], h[kidx]
    o3 = np.lexsort((h3s, -s3s, g3s))
    gk = g3s[o3]
    pick = kidx[o3]                        # rows of o2 order
    j3 = reg_j[o2][pick]
    sc3 = s2[pick]
    qb3 = qb[o2][pick]
    qe3 = qe[o2][pick]
    rb3 = rb[o2][pick]
    re3 = re_[o2][pick]

    firstk = np.zeros(gk.size, bool)
    firstk[0] = True
    firstk[1:] = gk[1:] != gk[:-1]
    seg_id = np.cumsum(firstk) - 1
    prim_pos = np.flatnonzero(firstk)
    P_sc = sc3[prim_pos][seg_id]
    P_qb = qb3[prim_pos][seg_id]
    P_qe = qe3[prim_pos][seg_id]

    ov = np.minimum(qe3, P_qe) - np.maximum(qb3, P_qb)
    min_l = np.minimum(qe3 - qb3, P_qe - P_qb)
    shadowed = (~firstk) & (ov > 0) & (ov >= min_l * opt.mask_level)
    unshadowed = (~firstk) & ~shadowed
    bad[gk[unshadowed]] = True             # second primary -> generators

    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del,
              opt.o_ins + opt.e_ins)
    sub = np.maximum.reduceat(np.where(shadowed, sc3, 0), prim_pos)
    sub_n = np.add.reduceat(
        (shadowed & (P_sc - sc3 <= tmp)).astype(np.int64), prim_pos)

    # --- XA eligibility (gen_xa_g: ratio filter, then count cap) ---
    xa_flag = shadowed & (sc3 >= P_sc * opt.XA_drop_ratio)
    cnt_xa = np.add.reduceat(xa_flag.astype(np.int64), prim_pos)
    xa_ok = cnt_xa <= opt.max_XA_hits
    xa_use = xa_flag & xa_ok[seg_id]

    # --- flat geometry for every lane this path would emit ---
    lq3 = qe3 - qb3
    rl3 = re3 - rb3
    geom = flat_geom(lq3, rl3, rb3, re3, l_pac, widths)
    need = firstk | xa_use
    badgeom = need & ~geom
    bad[gk[badgeom]] = True

    good = ~bad
    # gen_xa runs DP for alternates even when the read ends up unmapped;
    # results are discarded, so the unmapped-fast case needs no lanes
    unmap = good & (sc3[prim_pos] < opt.T)
    alt_rows = np.flatnonzero(xa_use & good[gk] & ~unmap[gk])
    alt_j = j3[alt_rows]
    alt_cnt = np.zeros(rows.size, np.int64)
    if alt_rows.size:
        ids, cc = np.unique(gk[alt_rows], return_counts=True)
        alt_cnt[ids] = cc
    return dict(good=good, unmap=unmap, prim_j=j3[prim_pos],
                sub=sub, sub_n=sub_n, alt_j=alt_j, alt_cnt=alt_cnt)


def reference_selection(opt: MemOptions, fields: dict, bounds: np.ndarray,
                        read_id0: int, l_pac: int, widths: Widths) -> dict:
    """se_text_batch's tiering as it was: its single-region rule and
    ``classify_multi``, in ``select_se``'s outputs."""
    cnt = np.diff(bounds)
    j0 = bounds[:-1]
    j0s = np.minimum(j0, max(len(fields["score"]) - 1, 0))
    first_score = np.where(cnt > 0, fields["score"][j0s], -1)

    simple = cnt == 1
    unmapped = (cnt == 0) | (simple & (first_score < opt.T))

    # geometric eligibility of the flat path for simple reads
    s_rows = np.flatnonzero(simple & (first_score >= opt.T))
    if s_rows.size:
        j = j0[s_rows]
        rb_, re_, qb_, qe_ = (fields["rb"][j], fields["re"][j],
                              fields["qb"][j], fields["qe"][j])
        ok = flat_geom(qe_ - qb_, re_ - rb_, rb_, re_, l_pac, widths)
        flat_rows = s_rows[ok]
    else:
        flat_rows = s_rows

    B = cnt.size
    tier = np.full(B, flatsam.GENERATOR)
    tier[unmapped] = flatsam.UNMAPPED
    tier[flat_rows] = flatsam.FLAT
    prim = np.full(B, -1)
    prim[flat_rows] = j0[flat_rows]
    sub = np.zeros(B, np.int64)
    sub_n = np.zeros(B, np.int64)
    alt_cnt = np.zeros(B, np.int64)
    alt_rows = np.array([], np.int64)
    multi_rows = np.flatnonzero(cnt >= 2)
    if multi_rows.size:
        m = classify_multi(opt, fields, bounds, multi_rows, read_id0, l_pac,
                           widths)
        rec = m["good"] & ~m["unmap"]
        tier[multi_rows[m["good"] & m["unmap"]]] = flatsam.UNMAPPED
        tier[multi_rows[rec]] = flatsam.FLAT
        prim[multi_rows[rec]] = m["prim_j"][rec]
        sub[multi_rows[rec]] = m["sub"][rec]
        sub_n[multi_rows[rec]] = m["sub_n"][rec]
        alt_cnt[multi_rows] = m["alt_cnt"]
        alt_rows = m["alt_j"]
    return dict(tier=tier, prim=prim, sub=sub, sub_n=sub_n, alt_cnt=alt_cnt,
                alt_rows=alt_rows)


# ---- seeded synthetic batches ----

def _read(rng, c):
    """One read's regions: the true hit and copies elsewhere (far apart:
    more than max_chain_gap), some near the one before (the patch
    trigger), duplicates, maybe a second primary."""
    if rng.random() < c["p_empty"]:
        return []
    L = c["read_len"]
    n = 1 if rng.random() < c["p_single"] else \
        int(rng.integers(2, c["n_max"] + 1)) + c["n_xa"]
    top = int(rng.integers(80, L + 1))
    if rng.random() < c["p_subT"]:
        top = int(rng.integers(10, 40))
    split = rng.random() < c["p_second"]
    slots = rng.permutation(L_PAC // 25_000 - 2)
    regs = []
    for j in range(n):
        if c["score_set"]:
            score = int(rng.choice(c["score_set"]))
        elif j == 0:
            score = top
        else:
            score = max(top - int(rng.integers(0, 5 if c["n_xa"] else 12)),
                        1)
        qb = int(rng.integers(0, 8))
        qe = L - int(rng.integers(0, 8))
        if split:       # halves that do not shadow each other, and one
            # that overlaps the first by exactly mask_level of the shorter
            qb, qe = [(0, 2 * L // 3), (2 * L // 3 - 4, L),
                      (L // 3, L)][int(rng.integers(0, 3))]
        rl = max(qe - qb + int(rng.integers(-3, 4)), 1)
        if rng.random() < c["p_long"]:
            rl = int(rng.choice([c["widths"].sam_t, c["widths"].sam_t + 1,
                                 c["widths"].sam_q + 1]))
            qe = min(qb + rl, L + 8) if rng.random() < 0.5 else qe
        rev = bool(rng.random() < 0.5)
        if regs and rng.random() < c["p_near"]:
            f = regs[-1]["f"] + int(rng.integers(-300, 8_000))
            rev = regs[-1]["rev"]
        else:
            f = int(slots[j]) * 25_000 + int(rng.integers(0, 5_000))
        f = min(max(f, 0), L_PAC - rl - 1)
        rb = 2 * L_PAC - (f + rl) if rev else f
        if c["p_straddle"] and rng.random() < c["p_straddle"]:
            rb = L_PAC - int(rng.integers(1, rl + 1))
        r = dict(f=f, rev=rev, rb=rb, re=rb + rl, qb=qb, qe=qe,
                 rid=int(np.searchsorted(OFFS, f, side="right") - 1),
                 score=score, truesc=score + int(rng.integers(0, 3)),
                 w=int(rng.integers(0, 30)), seedcov=int(rng.integers(19, L)),
                 seedlen0=int(rng.integers(19, L)),
                 frac_rep=float(rng.choice([0.0, 0.0, 0.25, 0.5])))
        regs.append(r)
        if c["p_dup"] and rng.random() < c["p_dup"]:
            # the same (score, rb, qb) with another end; on the same
            # contig index it trips the patch test, on another it
            # reaches the exact-duplicate drop.  Before it, maybe the
            # same (score, rb) with another qb, which is no duplicate
            # but sorts after both by qb
            if rng.random() < 0.5:
                regs.append(dict(r, qb=r["qb"] + int(rng.integers(1, 4)),
                                 rid=(r["rid"] + 2) % len(OFFS)))
            d = dict(r, re=r["re"] + int(rng.integers(0, 3)),
                     qe=r["qe"] - int(rng.integers(0, 3)),
                     truesc=r["truesc"] + 1)
            if rng.random() < 0.6:
                d["rid"] = (r["rid"] + 1) % len(OFFS)
            regs.append(d)
    if len(regs) >= 2 and rng.random() < c["p_triple"]:
        # a region nested in the first on another contig index, and one
        # max_chain_gap (or one less) past the first's end: neighbours
        # in re order, not in rb order
        a = regs[0]
        rl = a["re"] - a["rb"]
        rb = a["re"] + MCG - int(rng.integers(0, 2))
        regs += [dict(a, rb=a["rb"] + 5, re=a["re"] - 5, score=a["score"] - 1,
                      rid=(a["rid"] + 1) % len(OFFS)),
                 dict(a, rb=rb, re=rb + rl, score=a["score"] - 2)]
    return regs


def make_batch(case: str, seed: int):
    """A batch's region columns in ``finalize_fields``' layout (int64
    rb / re, int32 the rest, capacity past the last bound)."""
    c = dict(BASE, **CASES[case])
    rng = np.random.default_rng(seed)
    reads = [_read(rng, c) for _ in range(c["B"])]
    bounds = np.zeros(c["B"] + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=bounds[1:])
    regs = [r for rr in reads for r in rr]
    cap = len(regs) + 7
    fields = {}
    for k in ("rb", "re", "qb", "qe", "rid", "score", "truesc", "w",
              "seedcov", "seedlen0", "frac_rep"):
        dt = {"rb": np.int64, "re": np.int64,
              "frac_rep": np.float64}.get(k, np.int32)
        col = rng.integers(-50, 50, cap).astype(dt)   # past the bounds
        col[:len(regs)] = [r[k] for r in regs]
        fields[k] = col
    opt = MemOptions(max_XA_hits=c["max_xa"])
    return opt, fields, bounds, c["read_id0"], c["widths"]


def _patch_reads(fields, bounds, mcg):
    """Reads on which sort_dedup's patch loop would run."""
    out = set()
    for b in range(bounds.size - 1):
        rows = sorted(range(int(bounds[b]), int(bounds[b + 1])),
                      key=lambda j: fields["re"][j])
        for a, j in zip(rows, rows[1:]):
            if (fields["rid"][a] == fields["rid"][j]
                    and fields["rb"][j] < fields["re"][a] + mcg):
                out.add(b)
    return out


def _seed(case):
    return 7_300 + sum(map(ord, case))


@pytest.mark.parametrize("case", list(CASES))
def test_native_selection_equals_numpy(case):
    opt, fields, bounds, rid0, wd = make_batch(case, _seed(case))
    got = flatsam.select_se(opt, fields, bounds, rid0, L_PAC, wd)
    want = reference_selection(opt, fields, bounds, rid0, L_PAC, wd)
    for k in ("tier", "prim", "sub", "sub_n", "alt_cnt", "alt_rows"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # what each case is for happens in it
    tier, cnt = got["tier"], np.diff(bounds)
    flat = tier == flatsam.FLAT
    gen = tier == flatsam.GENERATOR
    unm = tier == flatsam.UNMAPPED
    multi = cnt >= 2
    assert flat.sum() >= 20 and (flat & multi).any()
    assert got["alt_rows"].size > 0 and (got["sub_n"] > 0).any()
    assert (unm == ((cnt == 0) | (unm & (cnt > 0)))).all()
    patch = _patch_reads(fields, bounds, opt.max_chain_gap)
    assert all(gen[b] for b in patch)
    in_patch = np.isin(np.arange(cnt.size), list(patch))
    need = {"second_primaries": gen & multi, "sub_T_primaries": unm & multi,
            "empty_reads": cnt == 0, "straddle_l_pac": gen & ~in_patch,
            "narrow": gen & ~in_patch, "wide": gen & ~in_patch}.get(case)
    if need is not None:
        assert need.sum() >= 5, case
    if case in ("narrow", "wide"):      # lanes at the windows' edge
        lanes = np.concatenate([got["prim"][flat], got["alt_rows"]])
        assert (fields["re"][lanes] - fields["rb"][lanes] == wd.sam_t).any()
    if case == "single_region":
        for t in (flatsam.UNMAPPED, flatsam.FLAT, flatsam.GENERATOR):
            assert ((tier == t) & (cnt == 1)).sum() >= 5, t
    if case == "patch_within_chain_gap":
        assert len(patch) >= 20
    if case == "xa_at_and_over_cap":
        assert (got["alt_cnt"] == opt.max_XA_hits).any()
        assert (flat & (got["alt_cnt"] == 0) & (cnt > opt.max_XA_hits + 1)
                ).any()
    if case == "exact_duplicates":
        dup = [b for b in np.flatnonzero(flat & multi)
               if len({(fields["score"][j], fields["rb"][j], fields["qb"][j])
                       for j in range(bounds[b], bounds[b + 1])})
               < cnt[b]]
        assert len(dup) >= 5
    if case in ("ties", "large_read_ids"):
        top2 = [b for b in np.flatnonzero(flat & multi)
                if sorted(fields["score"][bounds[b]:bounds[b + 1]])[-2:]
                [0] == fields["score"][got["prim"][b]]]
        assert len(top2) >= 5


@pytest.mark.parametrize("case", NARROW_CASES)
def test_multi_region_reads_equal_jax(case):
    import tpubwa.config
    from tpubwa.align import flatsam as jfs

    opt, fields, bounds, rid0, wd = make_batch(case, _seed(case))
    got = flatsam.select_se(opt, fields, bounds, rid0, L_PAC, wd)
    rows = np.flatnonzero(np.diff(bounds) >= 2)
    j = jfs.classify_multi(
        tpubwa.config.MemOptions(max_XA_hits=opt.max_XA_hits), fields,
        bounds, rows, rid0, L_PAC)
    rec = j["good"] & ~j["unmap"]
    tier = np.where(~j["good"], flatsam.GENERATOR,
                    np.where(j["unmap"], flatsam.UNMAPPED, flatsam.FLAT))
    np.testing.assert_array_equal(got["tier"][rows], tier)
    assert rec.sum() >= 5
    for k, jk in (("prim", "prim_j"), ("sub", "sub"), ("sub_n", "sub_n")):
        np.testing.assert_array_equal(got[k][rows][rec], j[jk][rec],
                                      err_msg=k)
    np.testing.assert_array_equal(got["alt_cnt"][rows], j["alt_cnt"])
    # single-region reads have no XA lanes: every alternate is a
    # multi-region read's
    np.testing.assert_array_equal(got["alt_rows"], j["alt_j"])


@pytest.mark.parametrize("fault", ["short_column", "falling_bounds",
                                   "bounds_not_from_zero"])
def test_columns_that_do_not_match_their_bounds_raise(fault):
    opt, fields, bounds, rid0, wd = make_batch("narrow", 5)
    n = int(bounds[-1])
    if fault == "short_column":
        fields = dict(fields, score=fields["score"][:n - 1])
    elif fault == "falling_bounds":
        bounds = bounds.copy()
        bounds[3] = bounds[4] + 1
    else:
        bounds = bounds + 1
    with pytest.raises(ValueError, match="do not match their bounds"):
        flatsam.select_se(opt, fields, bounds, rid0, L_PAC, wd)
