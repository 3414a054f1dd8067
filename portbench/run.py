"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``: from the start of this process to the first read of
the window): torch and CUDA, the cell's genome and the port's index (built
into ``build/portbench/`` by the first run in a checkout, loaded by every
later one), the ``Aligner`` with its kernels, and a warm-up of two batches
of reads from another stream of the seed.  Then a window of ``--seconds``
of fresh reads through the port's FASTQ reader (``portbench.producer``),
and, once it has closed, the check against the plain reference
(``portbench.reference``) on a sample of its batches drawn from the seed.

The last stdout line is one JSON object; with ``--trace 0`` its metrics are
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read by ``metrics/<name>.py`` from the window's phases and its
``torch.profiler`` trace.  The numbers compared and their limits close both
stdout's line (``checks``) and stderr.  Exits non-zero, with no result,
where torch sees fewer CUDA cards than the cell asks for, and where JAX or
the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def sample_batches(seed: int, n_batches: int, k: int) -> list[int]:
    """`k` of the window's batches, drawn from the seed."""
    import numpy as np

    rng = np.random.default_rng([seed & (2 ** 64 - 1), 7])
    k = min(k, n_batches)
    return sorted(int(b) for b in rng.choice(n_batches, size=k,
                                             replace=False))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when none is over."""
    checks = {}
    ok = True
    for name, lim in limits.items():
        v = numbers[name]
        checks[name] = {"value": v, "limit": lim}
        ok &= v <= lim
    return ok, checks


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t0: float = T0) -> dict:
    """Set up, measure, check; the result's fields."""
    import torch

    from portbench.harness import (WARM_STREAM, WINDOW_STREAM, Sink,
                                   finish_producer, layer_record, pipes_dir,
                                   read_metric, run_window)
    from portbench.reference.check import Reference

    marks = {"imports": time.monotonic()}
    text, built = cell.genome()
    prefix, b2 = cell.index()
    built.update(b2)
    marks["genome_index"] = time.monotonic()
    traffic = cell.traffic
    with pipes_dir() as tmp:
        warm = cell.producer(text, tmp, seed, WARM_STREAM, 1e9,
                             batches=int(traffic["warmup_batches"]))
        win = cell.producer(text, tmp, seed, WINDOW_STREAM, seconds)
        try:
            from tpubwa_torch.align.pipeline import Aligner, build_kernels
            from tpubwa_torch.index.fmindex import FMIndex

            t = time.monotonic()
            if device == "cuda":
                build_kernels()
            built["kernels_s"] = time.monotonic() - t
            marks["kernels"] = time.monotonic()
            idx = FMIndex.load(prefix)
            marks["index_load"] = time.monotonic()
            aligner = Aligner(idx, cell.mem_options(), device=device)
            marks["aligner"] = time.monotonic()
            cell.drive(aligner, warm[1], Sink())
            finish_producer(warm[0])
            if device == "cuda":
                torch.cuda.synchronize()
            marks["warmup"] = time.monotonic()
            rec = run_window(cell, aligner, text, seed, seconds, trace=trace,
                             proc_fifos=win)
        except BaseException:
            for p in (warm[0], win[0]):
                p.kill()
                p.wait()
            raise
    setup_s = rec["t_first"] - t0
    marks["first_read"] = rec["t_first"]
    # seconds of set-up by stage, each from the end of the one before
    parts, last = {}, t0
    for name, t in marks.items():
        parts[name] = t - last
        last = t
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    del aligner, idx
    if device == "cuda":
        torch.cuda.empty_cache()

    import numpy as np

    ref = Reference(np.load(text, mmap_mode="r"),
                    cell.config["genome"]["contig"], traffic,
                    cell.config["mem_options"], device=device)
    t = time.monotonic()
    sample = sample_batches(seed, rec["batches"],
                            int(traffic["check_batches"]))
    numbers = ref.check(rec["text"], seed, WINDOW_STREAM, rec["batches"],
                        sample)
    check_s = time.monotonic() - t
    examples = numbers.pop("examples")
    reads = rec["offered"] - numbers["unanswered"]
    correct, checks = judge(numbers, cell.limits)
    correct &= rec["batches"] > 0 and numbers["sampled_reads"] > 0

    device_out = {"platform": "gpu" if device == "cuda" else "cpu",
                  "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(rec["offered"]),
           "failed": int(numbers["unanswered"])}
    if trace:
        lrec = layer_record(rec, reads)
        metrics = {}
        for m in cell.per_layer:
            v = read_metric(cell.root, m["name"], lrec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        dev = rec.get("device")
        if dev is not None:
            device_out["busy_s"] = dev["busy_s"]
            device_out["window_s"] = dev["span_s"]
            out["breakdown"] = {"device_ops": dev["device_ops"],
                                "idle_gaps": dev["idle_gaps"]}
    else:
        values = {"reads_per_s": reads / rec["window_s"], "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    out["device"] = device_out
    out["checks"] = checks
    out["_run"] = {"built": built, "batches": rec["batches"],
                   "window_s": rec["window_s"], "setup_s": setup_s,
                   "starved_s": rec["starved_s"],
                   "check_s": check_s, "sample": sample,
                   "sampled_reads": numbers["sampled_reads"],
                   "batch_s": rec["batch_s"], "setup_parts_s": parts,
                   "examples": examples, "total_s": time.monotonic() - t0}
    return out


def main(argv=None) -> int:
    a = parse(argv)
    import torch

    from portbench.harness import Cell, forbidden_modules

    cell = Cell(a.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no fallback to the CPU)", file=sys.stderr)
        return 2
    import tpubwa_torch

    pkg = Path(tpubwa_torch.__file__).resolve()
    if cell.root.resolve() not in pkg.parents:
        print(f"portbench: the program {pkg.parent} is not the checkout's "
              f"({cell.root})", file=sys.stderr)
        return 4
    out = run(cell, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    meta = out.pop("_run")
    print(json.dumps({"run": meta}))
    for ex in meta["examples"]:
        print(f"failed {ex}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
