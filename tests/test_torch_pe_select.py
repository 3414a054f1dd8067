"""The PE flat tier's pair selection in one native call
(``pair.select_flat``, ``native/flatsel.cpp``) against the Python it
replaced: ``finalize.mark_primary`` on each end, ``pair.mem_pair`` and
the flat-eligibility loop that ``pe_sam_text`` ran pair by pair (kept
here as ``python_selection``), with exact equality of every output: each
end's sorted order, ``secondary``, ``secondary_all``, ``sub``, ``sub_n``;
each pair's ``o``, ``subo``, ``n_sub``, ``z``, ``proper`` and flat flag;
each flat end's chosen region, its XS sub and sub_n, and its XA rows.

The batches are seeded synthetic region lists, one case a parameter:
score ties, second primaries, primaries under ``T``, lanes straddling
``l_pac``, XA groups at and over ``max_XA_hits``, each insert-size
direction failed or not, empty ends, negative contig indexes (Python
indexes from the end) and contig indexes past the region's position,
and the narrow and wide widths.
"""
import types

import numpy as np
import pytest
import torch

from tpubwa_torch.align import finalize, pair
from tpubwa_torch.align.region import AlnReg
from tpubwa_torch.config import NARROW, WIDE, MemOptions
from tpubwa_torch.io.fasta import Contig

torch.set_num_threads(1)

L_PAC = 200_000
CONTIGS = [Contig("c0", 80_000, 0), Contig("c1", 70_000, 80_000),
           Contig("c2", 50_000, 150_000)]
OFFS = np.array([c.offset for c in CONTIGS])

BASE = dict(B=300, read_len=150, widths=NARROW, n_max=5, p_empty=0.03,
            p_second=0.08, p_subT=0.03, p_straddle=0.0, p_long=0.05,
            score_set=None, n_xa=0, p_neg_rid=0.0, failed=(1, 0, 1, 1),
            pair_id0=0, max_xa=5)
CASES = {
    "narrow": {},
    "wide": dict(read_len=250, widths=WIDE, p_long=0.08),
    "ties": dict(score_set=(60, 60, 61, 58)),
    "second_primaries": dict(p_second=0.4),
    "sub_T_primaries": dict(p_subT=0.4),
    "straddle_l_pac": dict(p_straddle=0.3),
    "xa_at_and_over_cap": dict(n_xa=4, max_xa=5),
    "pes_all_failed": dict(failed=(1, 1, 1, 1)),
    "pes_none_failed": dict(failed=(0, 0, 0, 0)),
    "pes_ff_rr_only": dict(failed=(0, 1, 1, 0)),
    "pes_fr_rf": dict(failed=(1, 0, 0, 1), n_xa=4),
    "empty_ends": dict(p_empty=0.35),
    "negative_rid": dict(p_neg_rid=0.15),
    "large_pair_ids": dict(pair_id0=(1 << 31) + 12_345, score_set=(90, 90)),
}


def _pes(failed):
    models = [(150, 900, 520.0, 110.5), (250, 560, 401.25, 49.75),
              (120, 950, 480.5, 140.0), (200, 800, 500.0, 95.25)]
    return [pair.PEStat(low=lo, high=hi, avg=av, std=sd, failed=bool(f))
            for (lo, hi, av, sd), f in zip(models, failed)]


def _region(rng, fwd, rev, qb, qe, rl, score, c, row):
    if c["p_straddle"] and rng.random() < c["p_straddle"]:
        rb = L_PAC - int(rng.integers(1, rl))
    elif rev:
        rb = 2 * L_PAC - (fwd + rl)
    else:
        rb = fwd
    rid = int(np.searchsorted(OFFS, fwd, side="right") - 1)
    if rng.random() < c["p_neg_rid"]:
        # a contig index from the end; some name the next contig, so the
        # position's offset from it is negative
        rid = min(rid + int(rng.random() < 0.3), len(CONTIGS) - 1)
        rid -= len(CONTIGS)
    return AlnReg(
        rb=rb, re=rb + rl, qb=qb, qe=qe, rid=rid, score=score,
        truesc=score + int(rng.integers(0, 3)), csub=int(rng.integers(0, 40)),
        sub_n=int(rng.choice([0, 0, 0, 1, 2])), w=int(rng.integers(0, 30)),
        frac_rep=float(rng.choice([0.0, 0.0, 0.25, 0.5])), seedlen0=row)


def _end(rng, c, fwd, rev, row0):
    """One end's region list: the true hit, shadowed copies (some near the
    mate's hits, some elsewhere), maybe a second primary."""
    if rng.random() < c["p_empty"]:
        return []
    L = c["read_len"]
    n = int(rng.integers(1, c["n_max"] + 1)) + c["n_xa"]
    top = int(rng.integers(80, L + 1))
    if rng.random() < c["p_subT"]:
        top = int(rng.integers(10, 40))
    split = rng.random() < c["p_second"]
    regs = []
    for j in range(n):
        if c["score_set"]:
            score = int(rng.choice(c["score_set"]))
        elif j == 0:
            score = top
        else:
            score = max(top - int(rng.integers(0, 12)), 1)
        qb = int(rng.integers(0, 8))
        qe = L - int(rng.integers(0, 8))
        if split:       # halves that do not shadow each other, and one
            # that overlaps the first by exactly mask_level of the shorter
            qb, qe = [(0, 2 * L // 3), (2 * L // 3 - 4, L),
                      (L // 3, L)][int(rng.integers(0, 3))]
        rl = qe - qb + int(rng.integers(-3, 4))
        if rng.random() < c["p_long"]:
            rl = int(rng.choice([c["widths"].sam_t, c["widths"].sam_t + 1,
                                 c["widths"].sam_q + 1]))
            qe = min(qb + rl, L + 8) if rng.random() < 0.5 else qe
        rl = max(rl, 1)
        if j == 0:
            f = fwd
        elif rng.random() < 0.5:
            f = fwd + int(rng.integers(-40, 41))
        else:
            f = int(rng.integers(0, L_PAC - 600))
        f = min(max(f, 0), L_PAC - rl - 1)
        r = rev if j == 0 or rng.random() < 0.7 else not rev
        regs.append(_region(rng, f, r, qb, qe, rl, score, c,
                            row0 + len(regs)))
    return regs


def make_batch(case: str, seed: int):
    c = dict(BASE, **CASES[case])
    rng = np.random.default_rng(seed)
    pairs, row = [], 0
    for _ in range(c["B"]):
        p = int(rng.integers(0, L_PAC - 2_000))
        ins = int(rng.normal(420, 120))
        s = bool(rng.random() < 0.5)
        e0 = _end(rng, c, p, s, row)
        row += len(e0)
        e1 = _end(rng, c, p + max(ins - c["read_len"], 0), not s, row)
        row += len(e1)
        pairs.append((e0, e1))
    if c["p_neg_rid"]:
        # mates 400 bp apart whose contig indexes (-2, -1) both lie past
        # their positions: Python's (rid << 32) | (pos - offset) makes
        # them a pair only with the offsets Python's indexing gives
        for s in (False, True):
            e0 = [_region(rng, 50_000, s, 0, 150, 150, 140, c, row)]
            e1 = [_region(rng, 120_250, not s, 0, 150, 150, 140, c,
                          row + 1)]
            e0[0].rid, e1[0].rid = -2, -1
            pairs.append((e0, e1))
            row += 2
    opt = MemOptions(max_XA_hits=c["max_xa"])
    idx = types.SimpleNamespace(l_pac=L_PAC, contigs=CONTIGS)
    return opt, idx, pairs, _pes(c["failed"]), c["pair_id0"], c["widths"]


def python_selection(opt, idx, pairs, pes, pair_id0, wd):
    """pe_sam_text's selection as it was, pair by pair in Python: marks
    every end (in place) and returns one dict a pair."""
    l_pac = idx.l_pac

    def geom(e):
        lq, rl = e.qe - e.qb, e.re - e.rb
        return (0 < lq <= wd.sam_q and 0 < rl <= wd.sam_t
                and not (e.rb < l_pac < e.re))

    out = []
    for i, (r0, r1) in enumerate(pairs):
        pid = pair_id0 + i
        a0 = finalize.mark_primary(opt, r0, (pid << 1) | 0)
        a1 = finalize.mark_primary(opt, r1, (pid << 1) | 1)
        res = dict(flat=False, paired=None, why="empty", xa=[])
        out.append(res)
        if not a0 or not a1:
            continue
        res["why"] = "second primary"
        if (any(p.secondary < 0 for p in a0[1:])
                or any(p.secondary < 0 for p in a1[1:])):
            continue
        res["why"] = "under T"
        if a0[0].score < opt.T or a1[0].score < opt.T:
            continue
        res["why"] = "geometry"
        o, subo, n_sub, z = pair.mem_pair(opt, idx, pes, (a0, a1), pid)
        score_un = a0[0].score + a1[0].score - opt.pen_unpaired
        proper = o > 0 and o > score_un
        res.update(paired=(o, subo, n_sub, list(z)), proper=proper)
        ends = []
        for end, a in ((0, a0), (1, a1)):
            k = z[end] if proper else 0
            c = a[k]
            if not geom(c):
                break
            thr = a[k].score * opt.XA_drop_ratio
            alt_j = [j for j, p in enumerate(a)
                     if p.secondary_all == k and p.score >= thr]
            res["xa"].append(len(alt_j))
            if len(alt_j) > opt.max_XA_hits:
                alt_j = []
            if any(not geom(a[j]) for j in alt_j):
                break
            sub_eff = a[c.secondary].score if c.secondary >= 0 else c.sub
            ends.append((c.seedlen0, [a[j].seedlen0 for j in alt_j],
                         sub_eff, c.sub_n))
        if len(ends) == 2:
            res.update(flat=True, ends=ends, why="flat")
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_native_selection_equals_python(case):
    opt, idx, pairs, pes, pid0, wd = make_batch(case, 9_100 + len(case))
    cols = pair.region_columns(pairs)
    got = pair.select_flat(opt, idx, cols, pes, pid0, wd)
    want = python_selection(opt, idx, pairs, pes, pid0, wd)

    bounds = cols["bounds"]
    for e, regs in enumerate(r for p in pairs for r in p):
        seg = slice(int(bounds[e]), int(bounds[e + 1]))
        assert got["order"][seg].tolist() == [r.seedlen0 for r in regs]
        assert got["sec"][seg].tolist() == [r.secondary for r in regs]
        assert got["sec"][seg].tolist() == [r.secondary_all for r in regs]
        assert got["sub"][seg].tolist() == [r.sub for r in regs]
        assert got["sub_n"][seg].tolist() == [r.sub_n for r in regs]

    alt_end = np.repeat(np.arange(bounds.size - 1), got["alt_cnt"])
    for i, w in enumerate(want):
        assert bool(got["flat"][i]) == w["flat"], i
        if w["paired"] is None:
            assert (got["o"][i], got["subo"][i], got["n_sub"][i]) == (0, 0, 0)
            continue
        o, subo, n_sub, z = w["paired"]
        assert (got["o"][i], got["subo"][i], got["n_sub"][i]) == \
            (o, subo, n_sub), i
        assert got["z"][2 * i: 2 * i + 2].tolist() == z, i
        assert bool(got["proper"][i]) == w["proper"], i
        if not w["flat"]:
            assert got["pick"][2 * i: 2 * i + 2].tolist() == [-1, -1]
            assert got["alt_cnt"][2 * i: 2 * i + 2].tolist() == [0, 0]
            continue
        for end, (row, alts, sub_eff, sub_n) in enumerate(w["ends"]):
            e = 2 * i + end
            assert got["pick"][e] == row
            assert got["sub_eff"][e] == sub_eff
            assert got["subn_eff"][e] == sub_n
            assert got["alt_rows"][alt_end == e].tolist() == alts

    # what each case is for happens in it
    why = [w["why"] for w in want]
    paired = [w for w in want if w["paired"] is not None]
    assert why.count("flat") >= 5 and len(paired) >= 20
    if all(p.failed for p in pes):          # no pair can be proper
        assert not any(w["paired"][0] for w in paired)
    else:
        assert {w["proper"] for w in paired} == {True, False}
        assert any(w["paired"][2] > 0 for w in paired)      # n_sub
    need = {"second_primaries": "second primary", "sub_T_primaries":
            "under T", "straddle_l_pac": "geometry", "wide": "geometry",
            "narrow": "geometry", "empty_ends": "empty"}.get(case)
    if need:
        assert why.count(need) >= 5, why
    xa = [n for w in want for n in w["xa"]]
    if case == "xa_at_and_over_cap":
        assert opt.max_XA_hits in xa and max(xa) > opt.max_XA_hits
        assert got["alt_rows"].size > 0
    if case == "ties":
        assert any(len(e) > 1 and e[0].score == e[1].score
                   for p in pairs for e in p)


def test_columns_that_do_not_match_their_bounds_raise():
    opt, idx, pairs, pes, pid0, wd = make_batch("narrow", 5)
    cols = pair.region_columns(pairs)
    cols["score"] = cols["score"][:-1]
    with pytest.raises(ValueError, match="do not match their bounds"):
        pair.select_flat(opt, idx, cols, pes, pid0, wd)
