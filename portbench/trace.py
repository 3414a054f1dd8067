"""What a run reads of the program's own spans, and of the device trace.

``PhaseClock`` takes the place of the aligner's ``PhaseTimers`` (it has its
interface: ``phase``, ``totals``, ``counts``, ``overall``, ``report``), so
the program's phases (SMEM, SAL, CHAIN, BSW, PAIR, SAM) are read without an
edit of the program.  Each phase is also kept as an interval, and in a
traced run becomes a ``torch.profiler.record_function`` range.

``device_record`` reduces a ``torch.profiler`` trace of the window: kernel
launches and their device time, the union of all device activity (kernels,
copies, sets) as busy time, the device time by operation name, and the
idle time of the device by the phase the host was in.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import numpy as np

PHASE_PREFIX = "portbench.phase."
WINDOW_RANGE = "portbench.window"
UNPHASED = "unphased"
NAME_CHARS = 160    # a device operation's name as the breakdown gives it


class PhaseClock:
    def __init__(self, profile: bool = False):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.spans: list[tuple[str, float, float]] = []
        self.profile = profile
        self._t0 = time.monotonic()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.profile:
            from torch.profiler import record_function
            rng = record_function(PHASE_PREFIX + name)
        else:
            rng = contextlib.nullcontext()
        with rng:
            t = time.monotonic()
            try:
                yield
            finally:
                t1 = time.monotonic()
                with self._lock:
                    self.totals[name] += t1 - t
                    self.counts[name] += 1
                    self.spans.append((name, t, t1))

    def overall(self) -> float:
        return time.monotonic() - self._t0

    def report(self) -> str:
        lines = [f"Overall time (sec): {self.overall():.2f}"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name}: {tot:.2f} (n={self.counts[name]})")
        return "\n".join(lines)


def union_length(iv: np.ndarray) -> float:
    """Total length of the union of intervals iv [n, 2]."""
    merged = merge(iv)
    return float((merged[:, 1] - merged[:, 0]).sum()) if merged.size else 0.0


def merge(iv: np.ndarray) -> np.ndarray:
    """Disjoint sorted union of intervals iv [n, 2]."""
    if iv.size == 0:
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    grp = np.cumsum(new) - 1
    stops = np.zeros(new.sum())
    np.maximum.at(stops, grp, ends)
    return np.stack([starts, stops], axis=1)


def covered(merged: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Length of [a_i, b_i] covered by the disjoint sorted intervals."""
    if merged.size == 0:
        return np.zeros_like(a, dtype=float)
    cum = np.concatenate([[0.0], np.cumsum(merged[:, 1] - merged[:, 0])])

    def upto(x):   # covered length of (-inf, x]
        k = np.searchsorted(merged[:, 0], x, side="right")
        part = np.where(k > 0, np.minimum(x, merged[np.maximum(k - 1, 0), 1])
                        - merged[np.maximum(k - 1, 0), 0], 0.0)
        return cum[np.maximum(k - 1, 0)] * (k > 0) + np.maximum(part, 0.0)

    return upto(b) - upto(a)


def _is_copy(name: str) -> bool:
    """A device copy or set (CUPTI names them so), not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def device_record(prof) -> dict:
    """Reduce a stopped ``torch.profiler.profile`` of the window."""
    from torch.autograd import DeviceType

    dev, names, phases, window = [], [], [], None
    n_kernels, kernel_ns = 0, 0
    by_name: dict[str, float] = defaultdict(float)
    for ev in prof.profiler.kineto_results.events():
        st, du = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if ev.name().startswith("portbench."):
                continue  # a range's copy on the device's timeline
            dev.append((st, st + du))
            by_name[ev.name()[:NAME_CHARS]] += du * 1e-9
            if not _is_copy(ev.name()):
                n_kernels += 1
                kernel_ns += du
            continue
        name = ev.name()
        if name == WINDOW_RANGE:
            window = (st, st + du)
        elif name.startswith(PHASE_PREFIX):
            phases.append((st, st + du))
            names.append(name[len(PHASE_PREFIX):])
    if window is None:
        raise RuntimeError(f"no {WINDOW_RANGE} range in the trace")
    w0, w1 = window

    def rel(iv):    # ns from the window's start, exact before the float
        a = np.array(iv, dtype=np.int64).reshape(-1, 2) - w0
        return np.clip(a, 0, w1 - w0).astype(float)

    busy_iv = rel(dev)
    merged = merge(busy_iv)
    busy = union_length(busy_iv)
    idle_by: dict[str, float] = defaultdict(float)
    ph = rel(phases)
    if phases:
        idle = (ph[:, 1] - ph[:, 0]) - covered(merged, ph[:, 0], ph[:, 1])
        for nm, v in zip(names, idle):
            idle_by[nm] += v * 1e-9
    total_idle = (w1 - w0) - busy
    idle_by[UNPHASED] += max(total_idle * 1e-9 - sum(idle_by.values()), 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-9, "span_s": (w1 - w0) * 1e-9,
            "kernel_launches": n_kernels, "kernel_s": kernel_ns * 1e-9,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[f"idle during {k}", v] for k, v in gaps]}
