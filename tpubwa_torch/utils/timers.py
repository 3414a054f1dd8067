"""Per-phase wall timers and work counters: the port's one tracer.

The reference prints at exit: ``Overall time / MEM_PROCESS_SEQ() / Total
kernel / BSW`` plus SMEM/SAL components (SURVEY.md §5 "Tracing / profiling").
We keep the same phase names so profiles are comparable, and add the
host steps around them.  No phase nests inside another:

  FASTQ — the pull of the next batch: FASTQ parsing and batch building of
          one end or both (the drivers of ``align/pipeline.py``)
  SMEM  — FM-index seeding (backward search + SMEM generation)
  SAL   — suffix-array lookup (seed position resolution)
  CHAIN — seed chaining + filtering
  BSW   — banded Smith-Waterman extension (the DP kernel)
  REGS  — one ``AlnReg`` object a region (``Aligner.regions_batch``)
  DEDUP — PE's sort / dedup / patch rounds before pairing
  PAIR  — PE pairing + mate rescue
  SAM   — SAM record construction
  WRITE — a batch's text to the output (and its chunk file), the progress
          line

Counters (``count``; once a batch or a call, never a read):

  sam.generator_reads — reads the generator tier of SAM rendered
  sam.flat_pairs — PE pairs the flat tier's native selection kept flat
          (``align/pair.py::pe_sam_text``; a pair whose cigar overflows
          its pack still goes to the generator tier)
  bsw.calls, bsw.rounds — ``flatext.run_phased`` calls and their rounds
  pair.rescue_jobs — anchors PAIR considered for mate rescue (an
          anchor whose mate is placed, or whose windows reach no SW,
          runs none)
  pair.rescue_sw — anchors that ran a rescue SW: the first rescue
          round's lanes (``pair.rescue_batch``)
  pair.rescued — regions the rescue inserted: the second round's lanes
  fastq.fallback_batches — batches the line parser took
          (``io/fastq.py::stream_batches``)
  fastq.wide_batches — batches the drivers placed in the wide bucket
          (a read of 161-256 bp; a PE pair of batches counts once)
  seed.overflow_reads — reads whose SMEM or seed list was cut to its
          capacity (``Aligner.seed_batch_finish``)
  pair.rescue_truncated — mate-rescue jobs whose query or target was cut
          to its pad (``pair.rescue_batch``)

Under ``-t N`` the workers share one PhaseTimers, so a phase's total is
summed over threads and may exceed the wall.  While a ``torch.profiler``
records, each phase is also a ``record_function`` range named
``tpubwa.<NAME>``, on the profiler's clock beside the kernels.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

RANGE_PREFIX = "tpubwa."


def _profiler_range(name: str):
    """A ``record_function`` range for phase `name` while a torch profiler
    records; None otherwise, without a call into the profiler (a profiler
    cannot run before torch is imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return None
    return prof.record_function(RANGE_PREFIX + name)


class PhaseTimers:
    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self._t0 = time.monotonic()
        # totals/counts updates are read-modify-write; the pipeline's -t
        # workers share one PhaseTimers (ADVICE r2: racy counters)
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str):
        with _profiler_range(name) or nullcontext():
            t = time.monotonic()
            try:
                yield
            finally:
                dt = time.monotonic() - t
                with self._lock:
                    self.totals[name] += dt
                    self.counts[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def overall(self) -> float:
        return time.monotonic() - self._t0

    def report(self) -> str:
        lines = [f"Overall time (sec): {self.overall():.2f}"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name}: {tot:.2f} (n={self.counts[name]})")
        for name, n in sorted(self.counters.items()):
            lines.append(f"  {name}: {n}")
        return "\n".join(lines)


def count(timers, name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of `timers` (an Aligner's ``timers``).  A
    tracer put in a PhaseTimers' place may keep phases only; it is left
    alone."""
    add = getattr(timers, "count", None)
    if add is not None:
        add(name, n)
