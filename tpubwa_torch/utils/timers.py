"""Per-phase wall timers, mirroring the reference's built-in phase breakdown.

The reference prints at exit: ``Overall time / MEM_PROCESS_SEQ() / Total
kernel / BSW`` plus SMEM/SAL components (SURVEY.md §5 "Tracing / profiling").
We keep the same phase names so profiles are comparable:

  SMEM  — FM-index seeding (backward search + SMEM generation)
  SAL   — suffix-array lookup (seed position resolution)
  CHAIN — seed chaining + filtering
  BSW   — banded Smith-Waterman extension (the DP kernel)
  PAIR  — PE pairing + mate rescue
  SAM   — SAM record construction + write
  IO    — FASTQ read / device transfer
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class PhaseTimers:
    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._t0 = time.monotonic()
        # totals/counts updates are read-modify-write; the pipeline's -t
        # workers share one PhaseTimers (ADVICE r2: racy counters)
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str):
        t = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def overall(self) -> float:
        return time.monotonic() - self._t0

    def report(self) -> str:
        lines = [f"Overall time (sec): {self.overall():.2f}"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name}: {tot:.2f} (n={self.counts[name]})")
        return "\n".join(lines)
