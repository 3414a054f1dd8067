"""The readings that a cell's limits are set from, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--seconds 10] [--out FILE]

Sets the cell up once, then runs a short window for each seed with the
program as the configuration states it (the sound runs: the lower
readings), and a window for each control seed with the cell's control
(``cells/<workload>.json``: ``control.mem_options``, the program run with
one guarantee of the configuration broken; the upper readings).  Each of
the cell's ``faults`` is read too: one given as ``mem_options`` runs a
window for each control seed with the program so set; one given as
``sam`` (``portbench.faults``) is planted in the SAM of the first three
sound windows, which is then checked again.  Each window is checked as a
run checks it.  Prints one JSON line a window and a summary: each number's
largest sound reading and smallest control and fault readings.  The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


TEXT_FAULT_SEEDS = 3     # sound windows that each SAM fault is planted in
COUNTS = ("sampled_reads", "checked_pairs")    # sizes, not readings


def windows(cell, aligner, text, seeds, seconds, ref, tag, log,
            text_faults=()) -> dict:
    """Check a window a seed; the SAM faults planted in the first few."""
    from portbench.faults import alter_sam
    from portbench.harness import WINDOW_STREAM, run_window
    from portbench.run import sample_batches

    out: dict = {tag: []}
    for k, seed in enumerate(seeds):
        t = time.monotonic()
        rec = run_window(cell, aligner, text, seed, seconds)
        sample = sample_batches(seed, rec["batches"],
                                int(cell.traffic["check_batches"]))
        planted = [(tag, rec["text"])]
        if k < TEXT_FAULT_SEEDS:
            planted += [(name, alter_sam(rec["text"], kind))
                        for name, kind in text_faults]
        for side, sam in planted:
            nums = ref.check(sam, seed, WINDOW_STREAM, rec["batches"], sample)
            row = {"side": side, "seed": seed, "batches": rec["batches"],
                   "reads_per_s": (rec["offered"] - nums["unanswered"])
                   / rec["window_s"], "numbers": nums,
                   "seconds": time.monotonic() - t}
            print(json.dumps(row), flush=True)
            log.append(row)
            out.setdefault(side, []).append(nums)
    return out


def calibrate(cell, seeds, control_seeds, seconds, device="cuda") -> dict:
    import numpy as np

    from portbench.harness import WARM_STREAM, Sink, finish_producer, pipes_dir
    from portbench.reference.check import Reference
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.index.fmindex import FMIndex

    text, _ = cell.genome()
    prefix, _ = cell.index()
    idx = FMIndex.load(prefix)
    ref = Reference(np.load(text, mmap_mode="r"),
                    cell.config["genome"]["contig"], cell.traffic,
                    cell.config["mem_options"], device=device)
    spec = json.loads((cell.root / "portbench" / "cells"
                       / f"{cell.name}.json").read_text())
    control, faults = spec["control"], spec.get("faults", {})
    text_faults = [(n, f["sam"]) for n, f in faults.items() if "sam" in f]
    log: list = []
    sides: dict = {}
    runs = [("sound", None, seeds), ("control", control["mem_options"],
                                     control_seeds)]
    runs += [(n, f["mem_options"], control_seeds)
             for n, f in faults.items() if "mem_options" in f]
    for tag, opts, ss in runs:
        if not ss:
            continue
        al = Aligner(idx, cell.mem_options(opts), device=device)
        with pipes_dir() as tmp:
            proc, fifos = cell.producer(
                text, tmp, ss[0], WARM_STREAM, 1e9,
                batches=int(cell.traffic["warmup_batches"]))
            cell.drive(al, fifos, Sink())
            finish_producer(proc)
        sides.update(windows(cell, al, text, ss, seconds, ref, tag, log,
                             text_faults if tag == "sound" else ()))
        del al
    summary = {}
    names = [k for k, v in sides["sound"][0].items()
             if isinstance(v, (int, float)) and k not in COUNTS] \
        if sides.get("sound") else list(cell.limits)
    for name in names:
        row = {}
        for side, nums in sides.items():
            have = [n[name] for n in nums if name in n]
            if have:
                row["lower" if side == "sound" else
                    "upper" if side == "control" else side] = (
                    max(have) if side == "sound" else min(have))
        summary[name] = row
    return {"workload": cell.name, "control": control, "faults": faults,
            "summary": summary, "windows": log}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    import torch

    from portbench.harness import Cell

    if not torch.cuda.is_available():
        print("portbench.calibrate: torch sees no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in a.seeds.split(",") if s]
    cseeds = [int(s) for s in a.control_seeds.split(",") if s]
    res = calibrate(Cell(a.workload), seeds, cseeds, a.seconds)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(res, indent=1) + "\n")
    print(json.dumps({"workload": res["workload"],
                      "summary": res["summary"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
