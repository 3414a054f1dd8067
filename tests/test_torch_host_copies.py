"""The port's own copies of the host code against the JAX package's.

``tpubwa_torch`` imports nothing of ``tpubwa``; it carries its own
FM-index builder and file format, ``MemOptions``, the native host library
and the flat extension's host half.  Here both packages are imported and
held against each other: an index saved by either loads in the other with
every array equal and gives the same device tensors; the options agree;
``prepare_jobs`` / ``finalize_fields`` agree on one seeded batch; and the
port's native library builds into ``build/tpubwa_torch/`` and raises when
the compiler fails.  All comparisons are exact (integers and text).
"""
import dataclasses
import os
import subprocess

import numpy as np
import pytest
import torch

import tpubwa.config
import tpubwa.index.fmindex
import tpubwa.io.fasta
import tpubwa_torch.config
import tpubwa_torch.index.fmindex
import tpubwa_torch.io.fasta

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 12_000
ARRAYS = ("pac_words", "L2", "cp", "sa_ls", "sa_ms", "holes")
PKGS = {"tpubwa": (tpubwa.index.fmindex.FMIndex, tpubwa.io.fasta.Contig),
        "tpubwa_torch": (tpubwa_torch.index.fmindex.FMIndex,
                         tpubwa_torch.io.fasta.Contig)}


def _codes():
    return np.random.default_rng(5).integers(0, 4, N).astype(np.uint8)


def _build(pkg):
    FMIndex, Contig = PKGS[pkg]
    return FMIndex.build([Contig("cA", 7000, 0), Contig("cB", N - 7000, 7000)],
                         _codes())


def _same_index(a, b):
    assert (a.l_pac, a.primary, a.seq_len) == (b.l_pac, b.primary, b.seq_len)
    assert [dataclasses.astuple(c) for c in a.contigs] == \
        [dataclasses.astuple(c) for c in b.contigs]
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.cp_hi is None) == (b.cp_hi is None)


@pytest.mark.parametrize("writer,reader", [("tpubwa", "tpubwa_torch"),
                                           ("tpubwa_torch", "tpubwa")])
def test_index_written_by_one_package_loads_in_the_other(tmp_path, writer,
                                                         reader):
    built = _build(writer)
    prefix = str(tmp_path / "ref.fa")
    built.save(prefix)
    assert PKGS[reader][0].exists(prefix)
    loaded = PKGS[reader][0].load(prefix)
    assert type(loaded) is PKGS[reader][0]
    _same_index(built, loaded)
    _same_index(loaded, _build(reader))      # and the builders agree


@pytest.mark.parametrize("wide,sa_stub", [(False, False), (True, False),
                                          (False, True), (True, True)],
                         ids=["narrow", "wide", "narrow-stub", "wide-stub"])
def test_device_index_of_both_packages_is_equal(wide, sa_stub):
    from tpubwa_torch.ops.fm import DeviceIndex

    a = DeviceIndex.from_host(_build("tpubwa"), "cpu", wide=wide,
                              sa_stub=sa_stub)
    b = DeviceIndex.from_host(_build("tpubwa_torch"), "cpu", wide=wide,
                              sa_stub=sa_stub)
    for name in ("cp", "sa", "pac_words", "L2"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype == (
            torch.int32 if name == "pac_words" or not wide else torch.int64)
        assert torch.equal(x, y), name
    assert (a.primary, a.l_pac) == (b.primary, b.l_pac)
    assert a.sa.shape == ((1,) if sa_stub else (2 * N + 1,))


def test_mem_options_agree():
    a, b = tpubwa.config.MemOptions(), tpubwa_torch.config.MemOptions()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    assert (a.split_len, a.mapQ_coef_fac) == (b.split_len, b.mapQ_coef_fac)
    np.testing.assert_array_equal(a.score_matrix(), b.score_matrix())
    c = tpubwa_torch.config.MemOptions(a=2, b=3)
    np.testing.assert_array_equal(
        c.score_matrix(), tpubwa.config.MemOptions(a=2, b=3).score_matrix())
    assert dataclasses.asdict(tpubwa_torch.config.MemOptions.preset(
        "cpu-dev")) == dataclasses.asdict(
            tpubwa.config.MemOptions.preset("cpu-dev"))


def test_prepare_jobs_and_finalize_fields_agree():
    """One seeded batch through the port on the CPU up to its seed rows;
    then both packages' host halves on the same rows and DP results."""
    from tpubwa.align import flatext as jflat
    from tpubwa_torch.align import flatext as tflat
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.io.fastq import Read, batch_reads
    from tpubwa_torch.utils import sim

    idx = _build("tpubwa_torch")
    reads = sim.simulate_reads(_codes(), idx.contigs, 40, length=120,
                               err=0.02, indel=0.003, seed=9)
    opt = tpubwa_torch.config.MemOptions()
    aligner = Aligner(idx, opt, device="cpu")
    batch = next(batch_reads([Read(*r) for r in reads], len(reads),
                             opt.max_read_len))
    handle = aligner.seed_batch_dispatch(batch.codes, batch.lens)
    rows, l_rep = aligner.seed_batch_finish(handle)
    B = batch.n
    bounds = np.searchsorted(rows[:, 0], np.arange(B + 1))
    skip = (np.asarray(batch.lens) < opt.min_seed_len).astype(np.uint8)
    args = (idx.l_pac, aligner.contig_offsets, rows, bounds, skip, batch.lens,
            l_rep[:B])
    th, tjobs, tn = tflat.prepare_jobs(opt, *args)
    jh, jjobs, jn = jflat.prepare_jobs(tpubwa.config.MemOptions(), *args)
    assert tn == jn and tn > B // 2
    assert sorted(tjobs) == sorted(jjobs)
    for k in tjobs:
        assert tjobs[k].dtype == jjobs[k].dtype
        np.testing.assert_array_equal(tjobs[k][:tn], jjobs[k][:jn], err_msg=k)

    results = tflat.run_phased(aligner, handle[2], handle[3], th, tjobs, tn,
                               lens_host=batch.lens)
    tf, tb = tflat.finalize_fields(th, results, B, tn)
    jf, jb = jflat.finalize_fields(jh, results, B, jn)
    np.testing.assert_array_equal(tb, jb)
    n_reg = int(tb[-1])
    assert n_reg >= B // 2 and sorted(tf) == sorted(jf)
    for k in tf:
        assert tf[k].dtype == jf[k].dtype
        np.testing.assert_array_equal(tf[k][:n_reg], jf[k][:n_reg], err_msg=k)
    # the AlnReg view of the same fields (ext_finalize consumed the
    # handles: prepare again)
    th = tflat.prepare_jobs(opt, *args)[0]
    jh = jflat.prepare_jobs(tpubwa.config.MemOptions(), *args)[0]
    tr = tflat.finalize_regs(th, results, B, tn)
    jr = jflat.finalize_regs(jh, results, B, jn)
    assert [[dataclasses.astuple(r) for r in regs] for regs in tr] == \
        [[dataclasses.astuple(r) for r in regs] for regs in jr]


def test_native_library_builds_into_the_build_directory():
    from tpubwa_torch.native import build as nbuild
    from tpubwa_torch.ops import cuda_build

    lib = nbuild.load_native()
    assert nbuild.load_native() is lib               # loaded once
    assert cuda_build.BUILD_DIR == \
        type(cuda_build.BUILD_DIR)(ROOT) / "build" / "tpubwa_torch"
    sos = [f for f in os.listdir(cuda_build.BUILD_DIR)
           if f.startswith("libtpubwa_native_") and f.endswith(".so")]
    assert sos, os.listdir(cuda_build.BUILD_DIR)
    assert not [f for f in os.listdir(nbuild._DIR) if f.endswith(".so")]
    for fn in ("sais_u8", "bwt_from_sa", "chain_filter_batch",
               "ext_prepare", "ext_finalize", "ext_phase1", "ext_missing",
               "sam_emit_se"):
        assert getattr(lib, fn).argtypes is not None


@pytest.mark.parametrize("fault", ["fails", "missing"])
def test_failed_native_build_raises(tmp_path, monkeypatch, fault):
    """A compiler that fails, or is not there, raises with its message;
    nothing is returned and nothing is left in the build directory."""
    from tpubwa_torch.native import build as nbuild

    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        if fault == "missing":
            raise FileNotFoundError(2, "No such file or directory", cmd[0])
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("partial")
        return subprocess.CompletedProcess(cmd, 1, "",
                                           "core.h:1:1: error: boom")

    monkeypatch.setattr(nbuild, "_lib", None)
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(nbuild.subprocess, "run", fake_run)
    want = "g[+][+] not found" if fault == "missing" else "error: boom"
    with pytest.raises(RuntimeError, match=want):
        nbuild.load_native()
    assert len(calls) == 1 and calls[0][0] == "g++"
    assert "-O3" in calls[0] and "-march=native" in calls[0]
    assert sorted(os.path.basename(a) for a in calls[0]
                  if a.endswith(".cpp")) == ["chain.cpp", "extension.cpp",
                                             "flatsel.cpp", "rescue.cpp",
                                             "sais.cpp", "samemit.cpp"]
    if fault == "fails":
        assert os.listdir(tmp_path / "b") == []
    assert nbuild._lib is None
