"""The host-time profilers of the port on the CPU, at 0.2 Mb and 64 reads
(batches of 32) instead of 4.6 / 46 Mb and 20,000 reads.

* ``tools.profile_se`` (``scripts/profile_r4.py``): its replay of batch 1
  stage by stage gives the text of the port's ``align_se_text`` (the tool
  checks that itself) and of the JAX package's on the same batch; its
  record has every stage.
* ``tools.profile_pe`` (``scripts/profile_pe_r5.py``): the profiled batch's
  text equals ``tpubwa.align.pair.align_pe_batch``'s, and its record names
  the six functions of ``align/pair.py`` whose share it reports.
* ``--device cuda`` without a card raises before a file is written.
"""
import json
import os

import pytest
import torch

from tpubwa_torch.tools import profile_pe, profile_se

torch.set_num_threads(1)
REF_MB, N_READS, BATCH = 0.2, 64, 32
SE_STAGES = {"r1_prep", "r2_loop", "r3_sort", "seed_rows", "dispatch",
             "device_wait", "finish_download", "ext_prepare", "waves",
             "ext_finalize", "flatsam", "flat_windows", "windows_download",
             "flatsam_again", "ga", "residual_host"}


@pytest.fixture
def small(monkeypatch):
    for mod in (profile_se, profile_pe):
        monkeypatch.setattr(mod, "N_READS", N_READS)
        monkeypatch.setattr(mod, "BATCH_READS", BATCH)


def _jax_batches(fq: str, n: int) -> list:
    from tpubwa.config import MemOptions
    from tpubwa.io.fastq import stream_batches

    it = stream_batches(fq, BATCH, MemOptions().max_read_len)
    return [next(it) for _ in range(n)]


def _jax_aligner(fa: str):
    from tpubwa.align.pipeline import Aligner
    from tpubwa.config import MemOptions
    from tpubwa.index.fmindex import FMIndex

    return Aligner(FMIndex.load(fa), MemOptions(batch_reads=BATCH))


@pytest.mark.parametrize("style", ["random", "chr21"])
def test_profile_se_replay_equals_jax(tmp_path, small, capsys, style):
    from tpubwa_torch.tools.bench import ensure_fixture

    work = str(tmp_path)
    rec, text = profile_se.profile(REF_MB, style, "cpu", work)
    out = capsys.readouterr().out
    assert "== profiling batch of 32 reads ==" in out and "TOTAL" in out
    assert set(rec["stages_ms"]) == SE_STAGES
    assert all(v >= 0 for k, v in rec["stages_ms"].items()
               if k != "residual_host")
    assert rec["reads"] == BATCH and rec["n_jobs"] > 0
    assert rec["seed_rows"] > 0
    # the reads the flat tier takes (``flatsam.select_se``), of one
    # region or of several: at 0.2 Mb the chr21-style genome's reads
    # all have several
    assert 0 < rec["flat_lanes"] <= BATCH
    assert rec["text_bytes"] == len(text)
    assert rec["device"] == "cpu" and rec["card"] is None
    json.dumps(rec)
    fa, fq, _ = ensure_fixture(REF_MB, N_READS, False, style, work)
    batch = _jax_batches(fq, 2)[1]
    assert text == _jax_aligner(fa).align_se_text(batch, 0)
    assert text.count("\n") >= BATCH


def test_profile_pe_batch_equals_jax(tmp_path, small, capsys):
    from tpubwa.align.pair import align_pe_batch

    from tpubwa_torch.tools.bench import ensure_fixture

    work = str(tmp_path)
    rec, text = profile_pe.profile(REF_MB, "cpu", 12, work)
    out = capsys.readouterr().out
    assert "warm batch:" in out and "Ordered by: cumulative time" in out
    assert set(rec["h1_cum_s"]) == set(rec["h1_share"]) == {
        "pestat", "rescue_batch", "mem_pair", "pe_sam_text",
        "_pe_generator_text"}
    assert rec["h1_cum_s"]["pe_sam_text"] > 0
    assert rec["h1_cum_s"]["pestat"] > 0
    assert {"SMEM", "BSW", "PAIR", "SAM"} <= set(rec["phases_s"])
    assert rec["pairs"] == BATCH and rec["card"] is None
    fa, fq1, fq2 = ensure_fixture(REF_MB, N_READS, True, "chr21", work)
    b1, b2 = _jax_batches(fq1, 1)[0], _jax_batches(fq2, 1)[0]
    assert text == align_pe_batch(_jax_aligner(fa), b1, b2, 0)
    assert text.count("\n") >= 2 * BATCH


@pytest.mark.parametrize("tool", [profile_se, profile_pe],
                         ids=["profile_se", "profile_pe"])
def test_cuda_without_card_raises_before_building(tmp_path, tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: --device cuda would run")
    work = str(tmp_path / "w")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--ref-mb", str(REF_MB), "--work", work])
    assert not os.path.exists(work)
