"""The per-layer metrics of the program's host steps around its device
phases (``FASTQ``, ``WRITE``, ``REGS``, ``DEDUP``): in the tiny cells'
traced lines where their ``workloads`` allow, read by name; none where the
program has no such phase; with the window's phases disjoint, so that what
they take comes out of ``driver.unphased_ms_per_kread``."""
from __future__ import annotations

import pytest

from portbench import harness
from portbench.harness import Cell, read_metric
from portbench.run import run

SE, PE = "tiny.tiny_se", "tiny.tiny_pe"
HOST = ("fastq.ms_per_kread", "write.ms_per_kread", "regs.ms_per_kread",
        "dedup.ms_per_kread")
PE_ONLY = ("regs.ms_per_kread", "dedup.ms_per_kread")


@pytest.mark.parametrize("workload", [SE, PE])
def test_a_traced_line_has_the_host_step_metrics(tiny_root, monkeypatch,
                                                 workload):
    seen = {}
    plain = harness.layer_record

    def keep(rec, reads):
        seen["spans"] = list(rec["clock"].spans)
        return plain(rec, reads)

    monkeypatch.setattr(harness, "layer_record", keep)
    out = run(Cell(workload, root=tiny_root), 2 ** 33 + 5, 2.0, True,
              device="cpu")
    assert out["correct"] is True, out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    want = [m for m in HOST if workload == PE or m not in PE_ONLY]
    assert set(want) <= set(got)
    assert not set(HOST) - set(want) & set(got)
    for m in want:
        assert out["metrics"][m]["unit"] == "ms/kread"
        assert got[m] >= 0 if m == "write.ms_per_kread" else got[m] > 0
    unphased = got["driver.unphased_ms_per_kread"]
    assert unphased < unphased + sum(got[m] for m in want)
    # one worker: no two phases of the window overlap
    spans = sorted(seen["spans"], key=lambda s: s[1])
    assert {"FASTQ", "WRITE"} <= {s[0] for s in spans}
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("name", HOST)
def test_a_program_without_the_phase_reads_none(tiny_root, name):
    rec = {"reads": 8192, "window_s": 1.0, "unphased_s": 0.5,
           "phase_s": {"SMEM": 0.1, "SAM": 0.2},
           "phase_n": {"SMEM": 1, "SAM": 1}}
    assert read_metric(tiny_root, name, rec) is None
    rec["phase_s"][name.split(".")[0].upper()] = 0.25
    assert read_metric(tiny_root, name, rec) == pytest.approx(1e6 * 0.25
                                                              / 8192)
