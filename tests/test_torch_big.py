"""``python -m tpubwa_torch.tools.big`` (the port of ``scripts/build_big.py``
+ ``scripts/run_big.py``) on the CPU, at 400 kb instead of 1.2 Gbp.

* ``main`` builds the realistic genome, its index and reads, serves them
  on ``--device cpu`` and prints a record with every field of
  ``BENCH_r05_big.json`` and ``BUILD_BIG.json``; a second run reuses the
  build; ``--device cuda`` without a visible card raises before anything
  is built.
* The SAM body equals the JAX package's ``run_se_pipeline`` on the same
  files.
* The bodies of the full SA, ``--sa-shift 5`` and the forced wide layout
  are equal.
* ``ops.fm.wide_sa`` (the wide layout's SA, made on the device a chunk at
  a time) equals ``idx.sa.astype(np.int64)``.
"""
import io
import json
import os

import numpy as np
import pytest
import torch

from tpubwa_torch.tools import big

torch.set_num_threads(1)
REF_LEN, N_READS, BATCH = 400_000, 32, 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("big"))
    argv = ["--ref-len", str(REF_LEN), "--n-reads", str(N_READS),
            "--device", "cpu", "--work", work]
    return work, argv


def test_big_main_record(run, capsys, monkeypatch):
    work, argv = run
    monkeypatch.setattr(big, "BATCH_READS", BATCH)   # the buffers' size
    assert big.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    brec, srec = json.loads(lines[-2]), json.loads(lines[-1])
    for name, rec in (("BUILD_BIG.json", brec),
                      ("BENCH_r05_big.json", srec)):
        with open(os.path.join(ROOT, name)) as f:
            assert set(json.load(f)) <= set(rec), name
    assert brec["wide"] is False and brec["seq_len"] == 2 * REF_LEN
    assert srec["sam_records"] == N_READS      # no read is split here
    assert srec["mapped_near_truth_frac"] >= 0.92
    assert {"device_bytes", "card", "sam_body_sha256"} <= set(srec)
    assert srec["card"] is None and srec["device_bytes"]["total"] > 0
    with open(os.path.join(work, f"serve_{REF_LEN}_s5.json")) as f:
        assert json.load(f) == srec
    # a second run reuses the build and keeps its timings on file
    assert big.main(argv + ["--sa-shift", "0"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["sam_body_sha256"] == srec["sam_body_sha256"]
    with open(os.path.join(work, f"build_{REF_LEN}.json")) as f:
        assert json.load(f) == brec
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            big.main(argv[:-4] + ["--device", "cuda", "--work", work + "/x"])
        assert not os.path.exists(work + "/x")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("bigf"))
    big.build(REF_LEN, N_READS, work)
    return big.paths(work, REF_LEN, N_READS)


def test_big_body_matches_jax_and_every_layout(files):
    from tpubwa.align.pipeline import Aligner as JaxAligner
    from tpubwa.align.pipeline import run_se_pipeline as jax_run
    from tpubwa.config import MemOptions
    from tpubwa.index.fmindex import FMIndex

    fa, fq = files
    bodies = {}
    for shift, wide in ((0, None), (5, None), (0, True)):
        rec, bodies[shift, wide] = big.serve(fa, fq, shift, N_READS, "cpu",
                                             wide=wide, batch_reads=BATCH)
        assert rec["wide"] is bool(wide)
    assert bodies[0, None] == bodies[5, None] == bodies[0, True]
    out = io.StringIO()
    jax_run(JaxAligner(FMIndex.load(fa), MemOptions(batch_reads=BATCH)), fq,
            out)
    assert bodies[0, None] == out.getvalue()


def test_wide_sa_chunked_upload(files):
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.ops.fm import DeviceIndex, wide_sa

    idx = FMIndex.load(files[0])
    want = idx.sa.astype(np.int64)
    for chunk in (1 << 26, 100_003, 64):
        got = wide_sa(idx, "cpu", chunk=chunk)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    di = DeviceIndex.from_host(idx, "cpu", wide=True)
    np.testing.assert_array_equal(di.sa.numpy(), want)
    # values past 2^31 and 2^32: a low word with its sign bit set, a high
    # byte
    idx.sa_ls[5] = 0xFFFFFFF0
    idx.sa_ms[3] = 2
    got = wide_sa(idx, "cpu", chunk=64)
    assert int(got[5]) == 0xFFFFFFF0
    assert int(got[3]) == (2 << 32) | int(idx.sa_ls[3])
    np.testing.assert_array_equal(got.numpy(), idx.sa.astype(np.int64))
