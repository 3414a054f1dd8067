"""Mate rescue for a whole batch (``pair.rescue_batch``,
``native/rescue.cpp``) against the generator path it replaced on the main
path: ``pair.matesw_gen`` for every anchor, built by the loop that
``align_pe_batch`` ran (kept here as ``reference``) and driven by
``pair.run_matesw_rounds``.  Both run the plain K4 on the CPU.

Equal, on every case: the region lists after the rescue, field by field;
the rescue SWs performed; every call of the local SW (the rows of each
round, byte for byte, so the same lanes and widths); the counters
``pair.rescue_jobs`` and ``pair.rescue_truncated``.

The batches are seeded pairs on a two-contig genome that holds three
copies of one segment, one case a parameter: both strands and insert
orientations, fragments at position 0, at the end of the forward strand
(windows clamped at 0 and at 2 l_pac) and across the contig boundary
(windows off the anchor's contig, or trimmed below min_seed_len, falling
through to later directions), every direction's model in use, anchors in
the three copies rescuing one mate into one list at equal scores,
unsorted lists and a small ``max_matesw``, short reads whose windows all
fit 256 codes, windows cut to the narrow and to the wide pads, queries
cut to a pad shorter than the reads, and a K4
stand-in that puts first-round scores at min_seed_len - 1 and at
min_seed_len, and a first-round hit's qe at -1.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from tpubwa_torch.align import pair
from tpubwa_torch.align.region import AlnReg
from tpubwa_torch.config import NARROW, WIDE, MemOptions
from tpubwa_torch.index.fmindex import FMIndex
from tpubwa_torch.io.fasta import Contig
from tpubwa_torch.io.fastq import ReadBatch
from tpubwa_torch.utils.timers import PhaseTimers, count

torch.set_num_threads(1)

LA, LB = 7_000, 5_000                 # the two contigs
REP, REP_LEN = (1_000, 3_500, 8_000), 1_100   # the segment's copies
MAT = torch.as_tensor(MemOptions().score_matrix())


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, LA + LB).astype(np.uint8)
    for s in REP[1:]:
        codes[s:s + REP_LEN] = codes[REP[0]:REP[0] + REP_LEN]
    idx = FMIndex.build([Contig("a", LA, 0), Contig("b", LB, LA)], codes)
    return idx, codes


def _pes(models):
    """PEStats from a (low, high) or None (failed) a direction."""
    return [pair.PEStat(failed=True) if m is None else
            pair.PEStat(low=m[0], high=m[1], avg=(m[0] + m[1]) / 2,
                        std=(m[1] - m[0]) / 6 + 1, failed=False)
            for m in models]


FR = [None, (200, 650), None, None]
BASE = dict(B=40, lens=(100, 150), ins=(250, 600), where="any",
            orient=("FR", "RF"), err=(0.0, 0.1), p_lost=0.3, decoys=2,
            p_unsorted=0.0, pes=FR, widths=NARROW, pads=None,
            max_matesw=None, stub=False)
CASES = {
    "strands": {},
    "clamped_at_0_and_2l_pac": dict(where="ends", pes=[
        (200, 700), (200, 900), (20, 800), None]),
    "contig_boundary_falls_through": dict(
        where="boundary", lens=(20, 60), ins=(60, 300), orient=(
            "FR", "RF", "FF", "RR"),
        pes=[(40, 40), (30, 350), (60, 61), (100, 300)]),
    "orientations": dict(orient=("FR", "RF", "FF", "RR"), pes=[
        (150, 700), (200, 650), (100, 900), (250, 600)], decoys=3),
    "equal_scores": dict(where="repeat", ins=(300, 500), p_lost=0.6,
                         pes=[None, (200, 700), (200, 700), None]),
    "unsorted_lists_few_anchors": dict(p_unsorted=0.5, decoys=5,
                                       max_matesw=2),
    "targets_fit_256": dict(lens=(40, 80), ins=(80, 150),
                            pes=[None, (60, 160), None, None]),
    "narrow_cut": dict(ins=(300, 1_400), pes=[None, (200, 1_500), None,
                                              None]),
    "wide_cut": dict(lens=(200, 250), ins=(300, 2_600), widths=WIDE,
                     pes=[None, (250, 2_700), (300, 900), None]),
    "query_cut": dict(pads=(128, NARROW.rescue_t)),
    "exact_limits": dict(B=0, pes=[(0, 500), (100, 296), (30, 330), None]),
    "stub_scores_at_the_limit_and_qe_minus_one": dict(stub=True),
}


def _read(codes, p, L, rev, err, rng):
    s = codes[p:p + L].copy()
    mut = rng.random(L) < err
    s[mut] = (s[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    s[rng.random(L) < 0.01] = 4
    if rev:
        s = np.where(s < 4, 3 - s, 4)[::-1]
    return s.astype(np.uint8)


def _reg(idx, p, L, rev, score, rng):
    l2 = 2 * idx.l_pac
    rb, re = (l2 - (p + L), l2 - p) if rev else (p, p + L)
    return AlnReg(rb=rb, re=re, qb=0, qe=L, rid=idx.pos_to_rid(p),
                  score=score, truesc=score, w=100, seedcov=L >> 1,
                  frac_rep=float(rng.choice([0.0, 0.25, 0.5])),
                  hash=1)         # a rescued region has hash 0


def _start(c, rng, frag):
    """A fragment's forward start for placement `c["where"]`."""
    lim = LA + LB - frag
    if c["where"] == "ends":
        return int(rng.choice([rng.integers(0, 40),
                               rng.integers(lim - 40, lim + 1)]))
    if c["where"] == "boundary":
        return int(np.clip(LA - frag // 2 + rng.integers(-80, 81), 0, lim))
    if c["where"] == "repeat":
        return REP[0] + int(rng.integers(0, REP_LEN - frag))
    return int(rng.integers(0, lim + 1))


def _random_pairs(c, idx, codes, rng):
    """c["B"] pairs of (end 0's regions, end 1's, read 1, read 2)."""
    out = []
    for _ in range(c["B"]):
        L = [int(rng.integers(c["lens"][0], c["lens"][1] + 1))
             for _ in range(2)]
        frag = max(int(rng.integers(*c["ins"])), *L)
        p = _start(c, rng, frag)
        o = str(rng.choice(c["orient"]))
        first = int(rng.integers(2))        # the end at the fragment start
        rev = [o[0] == "R", o[1] == "R"]
        pos = [0, 0]
        pos[first], pos[1 - first] = p, p + frag - L[1 - first]
        ends, reads = [], []
        for e in range(2):
            err = float(rng.uniform(*c["err"]))
            reads.append(_read(codes, pos[e], L[e], rev[e], err, rng))
            score = max(L[e] - int(5 * err * L[e]), 20)
            regs = []
            if rng.random() >= c["p_lost"] * (e + 0.5):
                regs.append(_reg(idx, pos[e], L[e], rev[e], score, rng))
            for _ in range(int(rng.integers(0, c["decoys"] + 1))):
                if c["where"] == "repeat":
                    cp = REP[int(rng.integers(1, 3))] + pos[e] - REP[0]
                    regs.append(_reg(idx, cp, L[e], rev[e], score, rng))
                else:
                    q = int(rng.integers(0, LA + LB - L[e]))
                    drop = int(rng.choice([0, 5, 16, 17, 18, 30]))
                    regs.append(_reg(idx, q, L[e], bool(rng.integers(2)),
                                     score - drop, rng))
            if rng.random() < c["p_unsorted"]:
                rng.shuffle(regs)
            else:
                regs.sort(key=lambda x: -x.score)
            ends.append(regs)
        out.append((*ends, *reads))
    return out


def _at(idx, rb, L, score, rng):
    """A region of length L at rb of [0, 2 l_pac)."""
    rev = rb >= idx.l_pac
    p = 2 * idx.l_pac - rb - L if rev else rb
    return _reg(idx, p, L, rev, score, rng)


def _mate_rb(l_pac, b1, d, dist):
    """The rb that pair.infer_dir puts at (dist, d) from b1."""
    s = 0 if d in (0, 3) else 1
    p2 = b1 + dist if d ^ s == 0 else b1 - dist
    b2 = p2 if s == 0 else 2 * l_pac - 1 - p2
    assert pair.infer_dir(l_pac, b1, b2) == (dist, d)
    return b2


def _exact_pairs(idx, codes, rng):
    """Pairs built at the limits, under EXACT's models: FF (0, 500), FR
    (100, 296), RF (30, 330), RR failed.  End 0 holds the anchors, end 1
    the mate's list; each anchor's first SW direction is named."""
    l2 = 2 * idx.l_pac
    rd = lambda L: rng.integers(0, 4, L).astype(np.uint8)  # noqa: E731
    reg = lambda rb, L=60, sc=60: _at(idx, rb, L, sc, rng)  # noqa: E731
    mate = lambda b1, d, dist: reg(_mate_rb(idx.l_pac, b1, d, dist))  # noqa
    out = [
        # FF and FR placed: RF's window clamps to [0, 19), min_seed_len
        ([reg(49)], [mate(49, 0, 250), mate(49, 1, 200)], rd(60), rd(60)),
        # ... to [0, 18): no SW
        ([reg(48)], [mate(48, 0, 250), mate(48, 1, 200)], rd(60), rd(60)),
        # a mate at the anchor's rb is RR at dist 0, not FF: FF
        ([reg(3000)], [reg(3000)], rd(60), rd(60)),
        # FF's mate at dist high: FR
        ([reg(3000)], [mate(3000, 0, 500)], rd(60), rd(60)),
        # FF placed, FR's mate at dist low: RF
        ([reg(3000)], [mate(3000, 0, 250), mate(3000, 1, 100)], rd(60),
         rd(60)),
        # scores at first - pen_unpaired and one below
        # (the mate lies in the first anchor's FF window)
        ([reg(1500, sc=100), reg(2500, sc=83), reg(4500, sc=82)], [],
         rd(60), codes[1700:1760].copy()),
        # an unsorted list: the first score sets the threshold
        ([reg(5000, sc=80), reg(5500, sc=100), reg(6000, sc=70)], [],
         rd(60), rd(60)),
        # FF's window [6719, 7280) has its midpoint 6999.5 on contig a
        ([reg(6719)], [], rd(60), rd(61)),
        # reverse anchor at the end of the text: FF placed, FR's window
        # past 2 l_pac is empty, RF runs
        ([reg(l2 - 50, L=50)], [reg(l2 - 20, L=20)], rd(50), rd(40)),
    ]
    return out


def _fit_256_pair(idx, codes, rng):
    """One FR window of exactly 256 codes: [2904, 3160)."""
    mate = codes[2904:3060].copy()
    return [([_at(idx, 3000, 60, 60, rng)], [], codes[3000:3060].copy(),
             mate)]


EXTRA = {"exact_limits": _exact_pairs, "targets_fit_256": _fit_256_pair}


def make_batch(idx, codes, name):
    """(options, pestats, pairs, read-1 batch, read-2 batch, pads)."""
    c = {**BASE, **CASES[name]}
    rng = np.random.default_rng(100 + list(CASES).index(name))
    opt = MemOptions()
    if c["max_matesw"] is not None:
        opt.max_matesw = c["max_matesw"]
    specs = _random_pairs(c, idx, codes, rng)
    if name in EXTRA:
        specs += EXTRA[name](idx, codes, rng)
    B, width = len(specs), c["widths"].rescue_q
    rows = [np.full((B, width), 4, np.uint8) for _ in range(2)]
    lens = [np.zeros(B, np.int32) for _ in range(2)]
    for i, (_, _, *reads) in enumerate(specs):
        for e in range(2):
            rows[e][i, :reads[e].size] = reads[e]
            lens[e][i] = reads[e].size
    pairs = [(r0, r1) for r0, r1, _, _ in specs]
    b = [ReadBatch(codes=rows[e], lens=lens[e], names=[""] * B,
                   seqs=[""] * B, quals=[""] * B) for e in range(2)]
    w = c["widths"]
    pads = c["pads"] or (w.rescue_q, w.rescue_t)
    return opt, _pes(c["pes"]), pairs, b[0], b[1], pads


def reference(opt, idx, pes, pairs, b1, b2, mat, q_pad, t_pad, timers):
    """The generator path: align_pe_batch's anchor loop, one
    ``matesw_gen`` an anchor, driven by ``run_matesw_rounds``."""
    gens = []
    for i in range(len(pairs)):
        for end in range(2):
            regs_a = pairs[i][end]
            regs_m = pairs[i][1 - end]
            if not regs_a:
                continue
            mate_b = (b2 if end == 0 else b1)
            ms = mate_b.codes[i, : mate_b.lens[i]]
            cand = [p for p in regs_a
                    if p.score >= regs_a[0].score - opt.pen_unpaired]
            for p in cand[: opt.max_matesw]:
                gens.append(pair.matesw_gen(opt, idx, pes, p,
                                            int(mate_b.lens[i]), ms,
                                            regs_m))
    count(timers, "pair.rescue_jobs", len(gens))
    if not gens:
        return 0
    return pair.run_matesw_rounds(opt, gens, mat, q_pad=q_pad, t_pad=t_pad,
                                  timers=timers)


def _stub(core, min_seed_len):
    """K4 with first-round results moved to the limits of the second
    round's test: lane 5k + 1 scores min_seed_len - 1, 5k + 2 exactly
    min_seed_len, 5k + 3 keeps its score with qe -1."""
    def run(query, qlen, target, tlen, mat, minsc, endsc, **kw):
        res = core(query, qlen, target, tlen, mat, minsc, endsc, **kw)
        if int(endsc[0]) != 1 << 30:            # a second round
            return res
        sc, te, qe, s2 = (x.clone() for x in res)
        k = torch.arange(sc.numel()) % 5
        live = sc > 0
        sc[(k == 1) & live] = min_seed_len - 1
        sc[(k == 2) & live] = min_seed_len
        qe[(k == 3) & live] = -1
        return type(res)(sc, te, qe, s2)
    return run


def _run(fn, case, idx, stub):
    """Run `fn` (rescue_batch or reference) on a copy of the case; the
    lists after, the SWs, the counters and every local SW call's inputs."""
    opt, pes, pairs, b1, b2, (q_pad, t_pad) = case
    pairs = copy.deepcopy(pairs)
    calls = []
    core = pair.localsw_core
    inner = _stub(core, opt.min_seed_len) if stub else core

    def recording(*a, **kw):
        calls.append([x.clone() for x in a if isinstance(x, torch.Tensor)])
        return inner(*a, **kw)

    timers = PhaseTimers()
    pair.localsw_core = recording
    try:
        n = fn(opt, idx, pes, pairs, b1, b2, MAT, q_pad=q_pad, t_pad=t_pad,
               timers=timers)
    finally:
        pair.localsw_core = core
    lists = [[dataclasses.asdict(r) for r in end] for p in pairs
             for end in p]
    return lists, n, timers.counters, calls


@pytest.mark.parametrize("name", list(CASES))
def test_batch_rescue_equals_the_generators(genome, name):
    idx, codes = genome
    case = make_batch(idx, codes, name)
    opt, _, pairs0, _, _, (q_pad, t_pad) = case
    stub = CASES[name].get("stub", False)
    want, n_want, cnt_want, calls_want = _run(reference, case, idx, stub)
    got, n_got, cnt_got, calls_got = _run(pair.rescue_batch, case, idx,
                                          stub)
    assert n_got == n_want
    assert got == want
    assert len(calls_got) == len(calls_want)
    for cg, cw in zip(calls_got, calls_want):
        assert len(cg) == len(cw)
        for xg, xw in zip(cg, cw):
            assert xg.shape == xw.shape and torch.equal(xg, xw)
    for k in ("pair.rescue_jobs", "pair.rescue_truncated"):
        assert cnt_got.get(k, 0) == cnt_want.get(k, 0), k
    assert cnt_got["pair.rescue_sw"] == n_got
    before = sum(len(end) for p in pairs0 for end in p)
    assert cnt_got["pair.rescued"] == sum(map(len, got)) - before

    # the case exercises what it is named for
    assert n_want > 0 and cnt_got["pair.rescued"] > 0
    if name == "strands":            # anchors whose mates are placed
        assert cnt_got["pair.rescue_jobs"] > n_want
    widths = {c[2].shape[1] for c in calls_want}     # the targets' pads
    if name == "targets_fit_256":
        assert widths == {256}
    if name in ("narrow_cut", "wide_cut", "query_cut"):
        assert t_pad in widths
        assert cnt_want["pair.rescue_truncated"] > 0
    else:
        assert "pair.rescue_truncated" not in cnt_want
    if name == "wide_cut":
        assert q_pad == WIDE.rescue_q and t_pad == WIDE.rescue_t
    if name == "equal_scores":      # a list that took two at one score
        new = [[r["score"] for r in end if r["hash"] == 0] for end in got]
        assert any(len(set(sc)) < len(sc) for sc in new)
    if name == "stub_scores_at_the_limit_and_qe_minus_one":
        first = calls_want[0]
        assert len(calls_want) == 2 and first[0].shape[0] >= 15


def test_no_anchor_runs_no_round(genome):
    """Ends with no region, or every direction's model failed: no local
    SW call, and the anchors still counted."""
    idx, codes = genome
    opt, pes, pairs, b1, b2, _ = make_batch(idx, codes, "strands")
    anchors = sum(min(sum(r.score >= end[0].score - opt.pen_unpaired
                          for r in end), opt.max_matesw)
                  for p in pairs for end in p if end)
    for lists, models, want in (([([], [])] * len(pairs), pes, 0),
                                (pairs, _pes([None] * 4), anchors)):
        calls = []
        core = pair.localsw_core
        pair.localsw_core = lambda *a, **k: calls.append(a) or core(*a, **k)
        t = PhaseTimers()
        try:
            n = pair.rescue_batch(opt, idx, models, copy.deepcopy(lists),
                                  b1, b2, MAT, timers=t)
        finally:
            pair.localsw_core = core
        assert n == 0 and calls == []
        assert t.counters["pair.rescue_sw"] == t.counters["pair.rescued"] \
            == 0
        assert t.counters["pair.rescue_jobs"] == want


def test_ends_of_two_widths_or_too_few_reads_are_refused(genome):
    idx, codes = genome
    opt, pes, pairs, b1, b2, _ = make_batch(idx, codes, "strands")
    with pytest.raises(ValueError, match="differ in width"):
        pair.rescue_batch(opt, idx, pes, pairs, b1, b2.padded_to(300), MAT)
    short = dataclasses.replace(b2, codes=b2.codes[:-1], lens=b2.lens[:-1])
    long = dataclasses.replace(b2, lens=b2.lens + b2.codes.shape[1])
    for bad in (short, long):
        with pytest.raises(ValueError, match="do not match the pairs"):
            pair.rescue_batch(opt, idx, pes, pairs, b1, bad, MAT)
