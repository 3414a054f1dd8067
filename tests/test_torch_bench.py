"""``python -m tpubwa_torch.tools.bench`` (the port of ``bench.py``) on the
CPU, at 0.2 Mb and 64 reads instead of 4.6 / 46 Mb and 20,000.

* ``ensure_fixture`` writes bench.py's ``_ensure_fixture`` files byte for
  byte (FASTA, FASTQs, the index's arrays and metadata): SE on the random
  genome, SE and PE on the chr21-style one.  ``bench.py`` is loaded from
  the repository root by its path, with ``_work_dir`` pointed elsewhere.
* ``main`` prints a record with the keys of ``BENCH_r05.json``'s parsed
  record, bench.py's metric name, and a SAM body hash equal to the JAX
  package's ``run_se_pipeline`` / ``align_pe_fastq`` body on the same files.
* ``--kernel`` (its shape patched small) gives the keys of
  ``BENCH_r05_kernel.json``, scores equal to ``tpubwa.ops.extend
  .extend_batch`` on the same jobs, the plain version's cell count, and no
  bound share or card on the CPU.
* ``--device cuda`` without a card raises before a file is written.
"""
import hashlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from tpubwa_torch.tools import bench

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_MB, N_READS, BATCH = 0.2, 64, 32


def _record(name: str) -> dict:
    with open(os.path.join(ROOT, name)) as f:
        rec = json.load(f)
    return rec.get("parsed", rec)


@pytest.fixture(scope="module")
def jax_bench(tmp_path_factory):
    """bench.py as it stands, its work directory in a tmp dir."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_py", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    work = str(tmp_path_factory.mktemp("jax_bench"))
    mod._work_dir = lambda: work
    return mod


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("port_bench"))


@pytest.mark.parametrize("style,pe", [("random", False), ("chr21", False),
                                      ("chr21", True)],
                         ids=["se-random", "se-chr21", "pe-chr21"])
def test_fixture_bytes_equal_bench_py(jax_bench, work, style, pe):
    got = bench.ensure_fixture(REF_MB, N_READS, pe, style, work)
    want = jax_bench._ensure_fixture(REF_MB, N_READS, pe, style=style)
    assert [os.path.basename(p) if p else p for p in got] == \
        [os.path.basename(p) if p else p for p in want]
    for a, b in zip(got, want):
        if a:
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), a
    fa, fb = got[0] + ".tpubwa", want[0] + ".tpubwa"
    with open(fa + ".json") as f, open(fb + ".json") as g:
        assert json.load(f) == json.load(g)
    a, b = np.load(fa + ".npz"), np.load(fb + ".npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_metric_names_are_bench_py_records():
    assert bench.metric_name(False, 4.6, "random") == \
        _record("BENCH_r05.json")["metric"]
    assert bench.metric_name(False, 46.0, "chr21") == \
        _record("BENCH_r05_chr21.json")["metric"]
    assert bench.metric_name(True, 46.0, "chr21") == \
        _record("BENCH_r05_pe.json")["metric"]


def _jax_body(fa: str, fq1: str, fq2) -> str:
    from tpubwa.align.pair import align_pe_fastq
    from tpubwa.align.pipeline import Aligner, run_se_pipeline
    from tpubwa.config import MemOptions
    from tpubwa.index.fmindex import FMIndex

    al = Aligner(FMIndex.load(fa), MemOptions(batch_reads=BATCH))
    out = io.StringIO()
    if fq2:
        align_pe_fastq(al, fq1, fq2, out)
    else:
        run_se_pipeline(al, fq1, out)
    return out.getvalue()


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_main_record_and_body_equal_jax(work, capsys, pe):
    style = "chr21" if pe else "random"
    argv = ["--device", "cpu", "--ref-mb", str(REF_MB), "--reads",
            str(N_READS), "--batch", str(BATCH), "--style", style,
            "--work", work] + (["--pe"] if pe else [])
    assert bench.main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(_record("BENCH_r05.json")) <= set(rec)
    assert rec["metric"] == ("reads_per_sec_1chip_pe_0.2Mb_chr21_150bp_"
                             "err1pct" if pe else
                             "reads_per_sec_1chip_se_0.2Mb_150bp_err1pct")
    assert rec["unit"] == "reads/s"
    assert len(rec["passes_s"]) == 3
    median = sorted(rec["passes_s"])[1]
    assert rec["value"] == pytest.approx(N_READS / median, abs=0.06)
    assert rec["vs_baseline"] == round(
        rec["value"] / bench.BASELINE_READS_PER_SEC, 4)
    assert {"SMEM", "BSW", "SAM"} <= set(rec["phases_s"])
    assert rec["device"] == "cpu" and rec["card"] is None
    fa, fq1, fq2 = bench.ensure_fixture(REF_MB, N_READS, pe, style, work)
    body = _jax_body(fa, fq1, fq2)
    assert rec["sam_records"] == body.count("\n") >= N_READS
    assert rec["sam_body_sha256"] == hashlib.sha256(body.encode()).hexdigest()


@pytest.mark.parametrize("layout", ["t", "b"])
def test_kernel_mode_against_jax(monkeypatch, capsys, layout):
    from tpubwa.ops.extend import extend_batch as jax_extend

    from tpubwa_torch.ops.extend import _extend_core

    monkeypatch.setattr(bench, "B", 8)
    monkeypatch.setattr(bench, "Q", 40)
    monkeypatch.setattr(bench, "T", 48)
    monkeypatch.setattr(bench, "REP", 2)
    assert bench.main(["--kernel", "--device", "cpu", "--ext-layout",
                       layout]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(_record("BENCH_r05_kernel.json")) <= set(rec)
    assert rec["metric"] == "dp_kernel_cells_per_sec_cpu"
    assert rec["vs_baseline"] is None and rec["card"] is None
    assert rec["max_abs_err"] == 0 and rec["launches"] == 0
    assert rec["hw_cells"] == 8 * 48 * 40 and rec["layout"] == layout

    args, kw = bench.kernel_inputs()
    assert args[0].shape == (8, 40) and args[2].shape == (8, 48)
    stats: dict = {}
    last = list(args)
    last[6] = args[6] + 1                       # h0 + REP - 1
    _extend_core(*(torch.as_tensor(a) for a in last), **kw, stats=stats)
    assert rec["cells"] == stats["cells"] > 0
    _, res = bench.bench_kernel(torch.device("cpu"), layout)
    want = jax_extend(*last, **kw)
    for f in ("score", "qle", "tle", "gtle", "gscore", "max_off"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_cuda_without_card_raises_before_building(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: --device cuda would run")
    work = str(tmp_path / "w")
    for extra in ([], ["--kernel"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(["--device", "cuda", "--ref-mb", str(REF_MB),
                        "--reads", str(N_READS), "--work", work] + extra)
    assert not os.path.exists(work)
