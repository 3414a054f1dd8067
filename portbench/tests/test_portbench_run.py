"""Whole runs of tiny cells on the CPU (the harness's look for a card
skipped), the last line's shape, cells and metrics found by name, the
faults a cell can have and the control, each of which comes out not
correct; and the command's refusal without a card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.faults import alter_sam
from portbench.harness import Cell, forbidden_modules
from portbench.run import run

REPO = Path(__file__).resolve().parents[2]
SE, PE = "tiny.tiny_se", "tiny.tiny_pe"


def tiny_run(root, workload, seed=2 ** 31 + 17, trace=False, cell=None,
             device="cpu"):
    cell = cell or Cell(workload, root=root)
    return run(cell, seed, 2.0, trace, device=device)


@pytest.mark.parametrize("workload", [SE, PE])
def test_tiny_cell_is_correct_and_its_line_has_the_contract_shape(
        tiny_root, workload):
    out = tiny_run(tiny_root, workload)
    meta = out.pop("_run")
    assert meta["batches"] >= 1 and meta["sampled_reads"] > 0
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 128
    assert set(out["metrics"]) == {"reads_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(out))
    assert not forbidden_modules()


def test_a_new_metric_file_is_read_by_name_in_a_traced_run(tiny_root):
    """A later change adds a metric as a file and an entry; no file that
    is there is edited (the tiny cell itself was added so, too)."""
    (tiny_root / "portbench" / "metrics" / "test.reads_seen.py").write_text(
        "def read(rec):\n    return float(rec['reads'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "test.reads_seen", "unit": "reads", "better": "higher",
        "source": "program_counter", "layer": "CLI / driver",
        "moves": "reads_per_s", "workloads": [SE]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = tiny_run(tiny_root, SE, trace=True)
    got = out["metrics"]
    assert got["test.reads_seen"]["value"] == out["attempted"]
    for name in ("driver.unphased_ms_per_kread", "smem.ms_per_kread",
                 "chain.ms_per_kread", "bsw.ms_per_kread",
                 "sam.ms_per_kread"):
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms/kread"
    # SE never pairs, and a CPU run has no device trace: those readers
    # find nothing and their metrics are left out
    assert "pair.ms_per_kread" not in got
    assert "kernels.device_ms_per_kread" not in got
    assert out["correct"] is True


def _text_fault(monkeypatch, kind: str, workload: str) -> None:
    """Break the timed path where a batch's SAM is produced."""
    from tpubwa_torch.align import pair, pipeline

    last = {}

    def alter(text: str) -> str:
        lines = text.split("\n")
        if kind == "stale":          # the step returns its state unchanged
            prev = last.get("text", text)
            last["text"] = text
            return prev
        if kind == "half":           # half of the batch left out
            keep = [ln for ln in lines if ln and
                    int(ln.split("\t")[0].rsplit("r", 1)[1]) % 2 == 0]
            return "\n".join(keep) + "\n"
        if kind in ("mapq0", "unpaired"):    # MAPQ 0, no proper pairs
            return alter_sam(text, kind)
        for k, ln in enumerate(lines):
            f = ln.split("\t")
            if len(f) > 9 and not int(f[1]) & 0x904:
                if kind == "pos":    # an answer altered where produced
                    f[3] = str(int(f[3]) + 3)
                else:                # a base of the read altered
                    f[9] = ("A" if f[9][0] != "A" else "C") + f[9][1:]
                lines[k] = "\t".join(f)
                break
        return "\n".join(lines)

    if workload == SE:
        orig = pipeline.Aligner.align_se_text
        monkeypatch.setattr(pipeline.Aligner, "align_se_text",
                            lambda self, *a, **k: alter(orig(self, *a, **k)))
    else:
        orig = pair.align_pe_batch
        monkeypatch.setattr(pair, "align_pe_batch",
                            lambda *a, **k: alter(orig(*a, **k)))


@pytest.mark.parametrize("workload,kind", [
    *[(w, k) for w in (SE, PE) for k in ("stale", "half", "pos", "seq",
                                          "mapq0")],
    (PE, "unpaired")])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch,
                                             workload, kind):
    _text_fault(monkeypatch, kind, workload)
    out = tiny_run(tiny_root, workload, seed=99 + len(kind))
    assert out["correct"] is False
    broken = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    want = {"stale": {"unanswered"}, "half": {"unanswered"},
            "pos": {"sam_fields"}, "seq": {"altered"},
            "mapq0": {"mapq0_unique_pct"}, "unpaired": {"mispaired_pct"}}[kind]
    assert want <= broken, out["checks"]


@pytest.mark.parametrize("workload", [SE, PE])
def test_the_control_is_not_correct(tiny_root, workload):
    """The cell's control (its ``control.mem_options``) put in the program's
    place; its readings on the card are in PERF.md."""
    cell = Cell(workload, root=tiny_root)
    control = json.loads((tiny_root / "portbench" / "cells"
                          / f"{workload}.json").read_text())["control"]
    plain = cell.mem_options
    cell.mem_options = lambda overrides=None: plain(control["mem_options"])
    out = tiny_run(tiny_root, workload, cell=cell)
    assert out["correct"] is False
    assert out["checks"]["misaligned_pct"]["value"] > \
        out["checks"]["misaligned_pct"]["limit"]


def test_mate_rescue_off_is_not_correct(tiny_root):
    """The pair mix's failing read 2s are placed by mate rescue; with it off
    (bwa's -m 0) they are not, and pairs go unreported."""
    cell = Cell(PE, root=tiny_root)
    plain = cell.mem_options
    cell.mem_options = lambda overrides=None: plain({"max_matesw": 0})
    out = tiny_run(tiny_root, PE, cell=cell)
    assert out["correct"] is False
    assert out["checks"]["mispaired_pct"]["value"] > \
        out["checks"]["mispaired_pct"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [SE, PE])
def test_tiny_cell_on_the_card_is_correct_and_traced(tiny_root, workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = tiny_run(tiny_root, workload, trace=True, device="cuda")
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
    got = out["metrics"]
    assert got["kernels.launches_per_kread"]["value"] > 0
    assert 0 < got["device.idle_share"]["value"] < 100
    assert 0 < len(out["breakdown"]["device_ops"]) <= 10
    assert ("pair.ms_per_kread" in got) == (workload == PE)


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "chr21_sim.pe150", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr and "no fallback" in p.stderr


def test_the_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "ecoli_sim.se150", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip().startswith("{")


def test_nothing_of_jax_or_the_jax_package_is_loaded_by_a_run(tiny_root):
    code = (
        "import sys, json; from pathlib import Path;"
        "from portbench.harness import Cell; from portbench.run import run;"
        f"run(Cell({SE!r}, root=Path({str(tiny_root)!r})), 5, 1.0, False,"
        " device='cpu');"
        "print(json.dumps(sorted(sys.modules)))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    mods = json.loads(p.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in mods}
    assert not {"jax", "jaxlib", "flax", "tpubwa", "bench"} & tops
    assert not [m for m in mods if m.startswith("tpubwa_torch.tools")]
    assert "tpubwa_torch" in tops     # the whole-name compare lets it by
