"""A tiny cell for the CPU tests: a copy of the benchmark's files in a
temporary directory, with a configuration, two mixes and their limits added
as new files (and entries in the copy's BENCHMARK.json), as a later change
adds a cell.  The tiny cells use the real cells' limits."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY_LEN = 120_000
TINY_BATCH = 128


def add_tiny(root: Path) -> None:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "chr21_sim.json").read_text())
    cfg.update(name="tiny", genome={"model": "realistic", "seed": 5,
                                    "length": TINY_LEN, "contig": "tiny"})
    cfg["mem_options"]["batch_reads"] = TINY_BATCH
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    for mix, real in (("tiny_se", "chr21_sim.se150"),
                      ("tiny_pe", "chr21_sim.pe150")):
        traffic = json.loads((pb / "traffic" / f"{real.split('.')[1]}.json")
                             .read_text())
        traffic.update(batch_reads=TINY_BATCH, check_batches=2)
        (pb / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
        name = f"tiny.{mix}"
        shutil.copy(pb / "cells" / f"{real}.json",
                    pb / "cells" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": mix, "chips": 1, "why": "t"})
        for metric in bench["per_layer"]:    # as the real cell's metrics
            if real in metric.get("workloads", []):
                metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    add_tiny(root)
    return root
