"""Generic lockstep round driver for job-yielding generators.

The TPU-native replacement for the reference's per-thread work loops
(SURVEY.md §2.2 "SIMD inter-task parallelism"): per-item host control flow
is written as a generator that yields device jobs; the round loop collects one
pending job per live generator, executes them as one (or a few, bucketed)
batched device calls, and sends results back — so irregular per-read logic
stays readable Python while all DP math runs as fixed-shape device batches.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator


def drive_rounds(gens: Iterable[Iterator], execute: Callable[[list], list]
                 ) -> list:
    """Run generators to completion in lockstep rounds.

    Each generator yields job objects and receives the corresponding result
    via .send(); its StopIteration.value is collected.  `execute(jobs)`
    returns one result per job (same order).  Returns the list of generator
    return values in input order.
    """
    gens = list(gens)
    n = len(gens)
    results: list[Any] = [None] * n
    pending: list[Any] = [None] * n
    live: list[int] = []
    for i, g in enumerate(gens):
        try:
            pending[i] = next(g)
            live.append(i)
        except StopIteration as e:
            results[i] = e.value
    while live:
        jobs = [pending[i] for i in live]
        outs = execute(jobs)
        nxt: list[int] = []
        for i, res in zip(live, outs):
            try:
                pending[i] = gens[i].send(res)
                nxt.append(i)
            except StopIteration as e:
                results[i] = e.value
        live = nxt
    return results
