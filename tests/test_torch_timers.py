"""The port's tracer, ``utils/timers.py::PhaseTimers``, and where the
drivers enter it.

* ``count`` and ``counters``, the report's counter lines, counts from two
  threads, no call into the profiler while none records, and a
  ``tpubwa.<NAME>`` range in a CPU ``torch.profiler`` trace while one does.
* The SE and PE drivers (one worker) on a tiny genome: ``FASTQ`` and
  ``WRITE`` entered once a batch (``FASTQ`` once more, for the pull that
  finds the end), ``REGS`` once an end of a PE batch, ``DEDUP`` once a PE
  batch; no two phases overlap.
* The counters against counts taken apart from them: ``bsw.calls`` against
  the calls of ``flatext.run_phased``, ``sam.generator_reads`` against the
  reads ``finalize.se_records_g`` / ``pair.sam_pe_g`` rendered,
  ``pair.rescue_jobs`` against the anchors of the pairs ``pair.
  rescue_batch`` was given (its reference ``pair.matesw_gen`` not called),
  ``pair.rescue_sw`` against the first rescue round's lanes.
* A tracer with phases only in the Aligner's place; the SAM text with and
  without a profiler recording.
* The width-bucket counters, each on a run built to trigger it and 0 on
  150-bp reads: ``fastq.wide_batches`` against the batches holding a read
  of 161-256 bp (SE; PE where only read 2 is long), ``seed.overflow_reads``
  against the Aligner's ``n_overflow`` under small seeding capacities,
  ``pair.rescue_truncated`` against the rescue jobs longer than the pads.
"""
import io
import json
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from tpubwa_torch.utils.timers import PhaseTimers, count

torch.set_num_threads(1)

GENOME = 30_000
BATCH = 32
FEW = 8


class SpanTimers(PhaseTimers):
    """PhaseTimers that also keeps each phase's interval."""

    def __init__(self):
        super().__init__()
        self.spans = []

    @contextmanager
    def phase(self, name):
        with super().phase(name):
            t = time.monotonic()
            try:
                yield
            finally:
                self.spans.append((name, t, time.monotonic()))


class PhasesOnly:
    """A tracer with a PhaseTimers' interface but no counters (``phase``,
    ``totals``, ``counts``, ``report``)."""

    def __init__(self):
        self.inner = PhaseTimers()
        self.totals, self.counts = self.inner.totals, self.inner.counts

    def phase(self, name):
        return self.inner.phase(name)

    def report(self):
        return self.inner.report()


def _disjoint(spans):
    spans = sorted(spans, key=lambda s: s[1])
    return all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


# ------------------------------------------------------------ the tracer --

def test_count_adds_and_the_report_lists_counters_after_the_phases():
    t = PhaseTimers()
    with t.phase("SMEM"):
        pass
    t.count("bsw.calls")
    t.count("bsw.rounds", 3)
    t.count("bsw.rounds", 2)
    t.count("pair.rescue_jobs", 0)
    assert dict(t.counters) == {"bsw.calls": 1, "bsw.rounds": 5,
                                "pair.rescue_jobs": 0}
    lines = t.report().splitlines()
    assert lines[0].startswith("Overall time (sec): ")
    assert lines[1].startswith("  SMEM: ") and lines[1].endswith("(n=1)")
    assert lines[2:] == ["  bsw.calls: 1", "  bsw.rounds: 5",
                         "  pair.rescue_jobs: 0"]


def test_counts_from_two_threads_are_all_kept():
    t = PhaseTimers()
    n = 20_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                t.count("c")
                t.count("d", 2)
                with t.phase("P"):
                    pass

        ths = [threading.Thread(target=work) for _ in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(old)
    assert t.counters["c"] == 2 * n and t.counters["d"] == 4 * n
    assert t.counts["P"] == 2 * n


def test_a_phase_calls_no_profiler_while_none_records(monkeypatch):
    import torch.autograd.profiler as ap

    def refuse(*a, **k):
        raise AssertionError("a profiler call without a profiler")

    monkeypatch.setattr(ap, "record_function", refuse)
    assert not ap._is_profiler_enabled
    t = PhaseTimers()
    with t.phase("FASTQ"):
        pass
    assert t.counts["FASTQ"] == 1


def test_a_phase_is_a_range_on_the_profilers_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    t = PhaseTimers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.phase("SMEM"):
            torch.ones(8).sum()
        with t.phase("WRITE"):
            pass
    with t.phase("SAM"):      # after the profiler stopped
        pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"tpubwa.SMEM", "tpubwa.WRITE"} <= names
    assert "tpubwa.SAM" not in names
    assert t.counts == {"SMEM": 1, "WRITE": 1, "SAM": 1}


def test_count_leaves_a_tracer_without_counters_alone():
    t = PhasesOnly()
    count(t, "bsw.calls", 4)
    assert not hasattr(t, "counters")
    p = PhaseTimers()
    count(p, "bsw.calls", 4)
    assert p.counters["bsw.calls"] == 4


# ------------------------------------------------------------ the drivers --

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A 30 kb genome, 100 SE reads and 64 pairs; every fourth SE read and
    read 1 of every fourth pair is a chimera of two far places, whose two
    primaries send it to the generator tier of SAM."""
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fasta import Contig
    from tpubwa_torch.utils import sim
    from tpubwa_torch.utils.dna import decode

    d = tmp_path_factory.mktemp("t_timers")
    codes = np.random.default_rng(31).integers(0, 4, GENOME).astype(np.uint8)
    ref = str(d / "ref.fa")
    with open(ref, "w") as f:
        f.write(">c1\n" + decode(codes) + "\n")
    contigs = [Contig("c1", GENOME, 0)]
    idx = FMIndex.build(contigs, codes)
    idx.save(ref)

    def chimera(k: int, n: int) -> str:
        a = 1000 + 211 * k
        return decode(codes[a:a + n // 2]) + decode(
            codes[a + 12_000:a + 12_000 + n - n // 2])

    se = sim.simulate_reads(codes, contigs, 100, length=120, seed=3)
    se = [(nm, chimera(k, 120) if k % 4 == 0 else s, q)
          for k, (nm, s, q) in enumerate(se)]
    fq = str(d / "r.fq")
    sim.write_fastq(fq, se)
    r1, r2 = sim.simulate_pairs(codes, contigs, 64, length=100, seed=4)
    r1 = [(nm, chimera(k, 100) if k % 4 == 0 else s, q)
          for k, (nm, s, q) in enumerate(r1)]
    fq1, fq2 = str(d / "p1.fq"), str(d / "p2.fq")
    sim.write_fastq(fq1, r1)
    sim.write_fastq(fq2, r2)
    # one short batch for the profiled runs (a CPU trace of a whole run
    # holds ~10^5 events a batch)
    few = [str(d / f"{n}_few.fq") for n in ("r", "p1", "p2")]
    for path, reads in zip(few, (se, r1, r2)):
        sim.write_fastq(path, reads[:FEW])
    return ref, idx, fq, fq1, fq2, few


def _aligner(idx, tracer):
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.config import MemOptions

    opt = MemOptions()
    opt.batch_reads = BATCH
    al = Aligner(idx, opt, device="cpu")
    al.timers = tracer
    return al


def _drive(al, fq, fq2=None):
    from tpubwa_torch.align.pair import align_pe_fastq
    from tpubwa_torch.align.pipeline import run_se_pipeline

    out = io.StringIO()
    if fq2 is None:
        run_se_pipeline(al, fq, out, workers=1)
    else:
        assert align_pe_fastq(al, fq, fq2, out, workers=1) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tiny):
    """SE and PE, each once with SpanTimers and with the three functions
    whose work the counters count wrapped to count it apart."""
    from tpubwa_torch.align import finalize, flatext, pair

    _, idx, fq, fq1, fq2, _ = tiny
    seen = {"run_phased": 0, "se_gen": 0, "pe_gen": 0, "matesw": 0,
            "anchors": 0, "lanes": 0}
    wrapped = {(flatext, "run_phased"): "run_phased",
               (finalize, "se_records_g"): "se_gen",
               (pair, "sam_pe_g"): "pe_gen", (pair, "matesw_gen"): "matesw",
               (pair, "rescue_batch"): "anchors",
               (pair, "localsw_core"): "lanes"}
    orig = {k: getattr(*k) for k in wrapped}

    def anchors(opt, pairs):
        """align_pe_batch's rule: per end, the regions within
        pen_unpaired of the list's first, at most max_matesw."""
        return sum(min(sum(r.score >= end[0].score - opt.pen_unpaired
                           for r in end), opt.max_matesw)
                   for p in pairs for end in p if end)

    def counting(key):
        def f(*a, **k):
            name = wrapped[key]
            if name == "anchors":
                seen[name] += anchors(a[0], a[3])
            elif name == "lanes":
                seen["lanes"] += a[0].shape[0] * (int(a[6][0]) == 1 << 30)
            else:
                seen[name] += 1
            return orig[key](*a, **k)
        return f

    out = {}
    try:
        for k in wrapped:
            setattr(*k, counting(k))
        for name, args in (("se", (fq,)), ("pe", (fq1, fq2))):
            for k in seen:
                seen[k] = 0
            t = SpanTimers()
            text = _drive(_aligner(idx, t), *args)
            out[name] = (t, text, dict(seen))
    finally:
        for k, f in orig.items():
            setattr(*k, f)
    return out


def test_se_driver_enters_the_host_phases_once_a_batch(runs):
    t, text, _ = runs["se"]
    batches = -(-100 // BATCH)
    assert t.counts["FASTQ"] == batches + 1
    assert t.counts["WRITE"] == batches
    assert t.counts["SAM"] == batches
    assert "REGS" not in t.counts and "DEDUP" not in t.counts
    assert _disjoint(t.spans)
    assert sum(1 for ln in text.splitlines() if not ln.startswith("@")) \
        >= 100


def test_pe_driver_enters_the_host_phases_once_a_batch(runs):
    t, _, _ = runs["pe"]
    batches = 64 // BATCH
    assert t.counts["FASTQ"] == batches + 1
    assert t.counts["WRITE"] == batches
    assert t.counts["REGS"] == 2 * batches     # one an end
    assert t.counts["DEDUP"] == batches
    assert t.counts["PAIR"] == batches
    assert _disjoint(t.spans)


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_bsw_calls_are_the_calls_of_run_phased(runs, mode):
    t, _, seen = runs[mode]
    assert t.counters["bsw.calls"] == seen["run_phased"] > 0
    assert t.counters["bsw.rounds"] >= t.counters["bsw.calls"]


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_generator_reads_are_the_reads_the_generator_tier_rendered(runs,
                                                                   mode):
    t, _, seen = runs[mode]
    want = seen["se_gen"] if mode == "se" else 2 * seen["pe_gen"]
    assert t.counters["sam.generator_reads"] == want > 0


def test_rescue_jobs_are_the_jobs_pair_built(runs):
    t, _, seen = runs["pe"]
    assert t.counters["pair.rescue_jobs"] == seen["anchors"] > 0
    assert t.counters["pair.rescue_sw"] == seen["lanes"] > 0
    assert t.counters["pair.rescued"] <= t.counters["pair.rescue_sw"]
    assert seen["matesw"] == 0        # the main path runs no generator


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_a_tracer_with_phases_only_gives_the_same_text(tiny, runs, mode):
    _, idx, fq, fq1, fq2, _ = tiny
    args = (fq,) if mode == "se" else (fq1, fq2)
    assert _drive(_aligner(idx, PhasesOnly()), *args) == runs[mode][1]


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_the_sam_text_is_the_same_under_a_profiler(tiny, mode):
    from torch.profiler import ProfilerActivity, profile

    _, idx, _, _, _, few = tiny
    args = few[:1] if mode == "se" else few[1:]
    plain = _drive(_aligner(idx, PhaseTimers()), *args)
    al = _aligner(idx, PhaseTimers())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        text = _drive(al, *args)
    assert text == plain
    assert sum(1 for ln in text.splitlines() if not ln.startswith("@")) \
        >= FEW * (1 if mode == "se" else 2)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"tpubwa.FASTQ", "tpubwa.SMEM", "tpubwa.BSW", "tpubwa.SAM",
            "tpubwa.WRITE"} <= names
    assert ("tpubwa.DEDUP" in names) == (mode == "pe")
    assert ("tpubwa.REGS" in names) == (mode == "pe")


# ------------------------------------------------- the bucket counters --

def _long_fastqs(d, codes, contigs, long_at: dict) -> list:
    """SE reads (or pairs) of 150 bp in batches of BATCH, with one read of
    200 bp in each batch named in `long_at` ({end: [batch, ...]})."""
    from tpubwa_torch.utils import sim
    from tpubwa_torch.utils.dna import decode

    n = 3 * BATCH
    ends = max(long_at) + 1
    if ends == 1:
        reads = [sim.simulate_reads(codes, contigs, n, length=150, seed=5)]
    else:
        reads = list(sim.simulate_pairs(codes, contigs, n, length=150,
                                        seed=6))
    paths = []
    for e, rs in enumerate(reads):
        for k in long_at.get(e, []):
            i = k * BATCH + 3
            rs[i] = (rs[i][0], decode(codes[500 + 97 * k:700 + 97 * k]),
                     "I" * 200)
        paths.append(str(d / f"long_{ends}_{e}.fq"))
        sim.write_fastq(paths[-1], rs)
    return paths


@pytest.mark.parametrize("case", ["se", "pe_read2", "short_se", "short_pe"])
def test_wide_batches_count_the_batches_with_a_long_read(tiny, tmp_path,
                                                         case):
    from tpubwa_torch.io.fasta import Contig

    _, idx, *_ = tiny
    codes = idx.fetch_ref(0, idx.l_pac)
    contigs = [Contig("c1", GENOME, 0)]
    long_at, want = {"se": ({0: [0, 2]}, 2), "pe_read2": ({0: [], 1: [1]}, 1),
                     "short_se": ({0: []}, 0),
                     "short_pe": ({0: [], 1: []}, 0)}[case]
    paths = _long_fastqs(tmp_path, codes, contigs, long_at)
    t = PhaseTimers()
    text = _drive(_aligner(idx, t), *paths)
    assert t.counters["fastq.wide_batches"] == want
    assert sum(1 for ln in text.splitlines() if not ln.startswith("@")) \
        >= 3 * BATCH * len(paths)
    for name in ("seed.overflow_reads", "pair.rescue_truncated"):
        assert t.counters[name] == 0


def test_overflow_reads_count_the_reads_cut_to_their_capacity(tiny):
    """Seed lists capped at 3 a read: every read with more seeds counts,
    as many as the Aligner's ``n_overflow``; the default capacities cut
    none of the same 120-bp reads."""
    _, idx, fq, *_ = tiny
    counts = []
    for cap in (3, None):
        t = PhaseTimers()
        al = _aligner(idx, t)
        if cap:
            al.opt.max_seeds_per_read = cap
        _drive(al, fq)
        counts.append((t.counters["seed.overflow_reads"], al.n_overflow))
    assert counts[0][0] == counts[0][1] > 10
    assert counts[1] == (0, 0)


def test_rescue_truncated_counts_the_jobs_longer_than_the_pads():
    """Rescue jobs whose query or target is longer than the pads count
    once each, at the narrow and at the wide pads."""
    from tpubwa_torch.align.pair import SWJob, run_matesw_rounds
    from tpubwa_torch.config import NARROW, WIDE, MemOptions

    opt = MemOptions()
    rng = np.random.default_rng(2)

    def gen(q, t):
        yield SWJob(rng.integers(0, 4, q).astype(np.uint8),
                    rng.integers(0, 4, t).astype(np.uint8), 19, 1 << 30)
        return 1

    shapes = [(100, 900), (100, 1500), (200, 900), (250, 2000)]
    for widths, want in ((NARROW, 3), (WIDE, 0)):
        t = PhaseTimers()
        n = run_matesw_rounds(opt, [gen(*s) for s in shapes],
                              torch.as_tensor(opt.score_matrix()),
                              q_pad=widths.rescue_q, t_pad=widths.rescue_t,
                              timers=t)
        assert n == len(shapes)
        assert t.counters["pair.rescue_truncated"] == want

