"""The port's serving modes on the CPU: ``--chunks`` resume, ``--hosts``
sharding, the ``-t N`` worker pool and ``--profile``.

* tests/test_chunk_resume.py's resume (chunk files, a reused sentinel
  chunk, the manifest refusal) through ``tpubwa_torch``.
* tests/test_multihost.py's two CLI processes (``--device cpu``) and the
  in-process shard filter, under both drivers.
* ``-t 3`` SE and PE write the ``-t 1`` text.
* tests/test_pool.py's three cases against the port's
  ``run_ordered_pool``.
* The thread-safety repairs: the first build of a kernel in
  ``ops.cuda_build``, the ``n_overflow`` count under ``-t 4``, and the
  manifest written by two hosts at once.
"""
import glob
import io
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig
from tpubwa.utils import sim
from tpubwa.utils.dna import decode

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _body(sam: str) -> str:
    return "".join(ln + "\n" for ln in sam.splitlines()
                   if not ln.startswith("@"))


@pytest.fixture(scope="module")
def se_fixture(tmp_path_factory):
    """tests/test_chunk_resume.py's genome and reads (100 x 120 bp)."""
    d = tmp_path_factory.mktemp("t_serving")
    codes = np.random.default_rng(21).integers(0, 4, 25000).astype(np.uint8)
    contigs = [Contig("c1", 25000, 0)]
    ref = str(d / "ref.fa")
    with open(ref, "w") as f:
        f.write(">c1\n" + decode(codes) + "\n")
    FMIndex.build(contigs, codes).save(ref)
    fq = str(d / "r.fq")
    sim.write_fastq(fq, sim.simulate_reads(codes, contigs, 100, length=120,
                                           err=0.01, seed=3))
    fq1, fq2 = str(d / "p1.fq"), str(d / "p2.fq")
    r1, r2 = sim.simulate_pairs(codes, contigs, 48, length=100, seed=4)
    sim.write_fastq(fq1, r1)
    sim.write_fastq(fq2, r2)
    return d, ref, fq, fq1, fq2


def _align(ref, fq, fq2=None, **kw):
    from tpubwa_torch.align.pipeline import align_fastq

    out = io.StringIO()
    assert align_fastq(ref, fq, fq2, out, device="cpu", batch_reads=32,
                       **kw) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def single(se_fixture):
    """The -t 1 SE and PE texts."""
    _, ref, fq, fq1, fq2 = se_fixture
    return _align(ref, fq), _align(ref, fq1, fq2)


def test_chunk_resume_identical(se_fixture, single, tmp_path):
    _, ref, fq, _, _ = se_fixture
    base = single[0]
    cdir = str(tmp_path / "chunks")
    assert _body(_align(ref, fq, chunk_dir=cdir)) == _body(base)
    assert os.path.exists(os.path.join(cdir, "manifest.json"))
    chunks = sorted(c for c in os.listdir(cdir) if c != "manifest.json")
    assert chunks == [f"chunk_{i:06d}.sam" for i in range(4)]   # 100 / 32

    # an interrupted run: two chunks gone, one poisoned to prove that a
    # completed chunk is reused verbatim, not recomputed
    os.remove(os.path.join(cdir, chunks[1]))
    os.remove(os.path.join(cdir, chunks[3]))
    sentinel = os.path.join(cdir, chunks[0])
    with open(sentinel) as f:
        keep = f.read()
    with open(sentinel, "w") as f:
        f.write("SENTINEL\n")
    assert "SENTINEL\n" in _align(ref, fq, chunk_dir=cdir)
    with open(sentinel, "w") as f:
        f.write(keep)
    assert _body(_align(ref, fq, chunk_dir=cdir)) == _body(base)

    # another run identity (batch size -> chunk boundaries) is refused
    from tpubwa_torch.align.pipeline import align_fastq

    with pytest.raises(RuntimeError, match="manifest"):
        align_fastq(ref, fq, None, io.StringIO(), device="cpu",
                    batch_reads=16, chunk_dir=cdir)


def test_two_processes_concatenate_to_single_host(se_fixture, single):
    d, ref, fq, _, _ = se_fixture
    chunks = str(d / "mh_chunks")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for h in (0, 1):
        r = subprocess.run(
            [sys.executable, "-m", "tpubwa_torch.cli", "mem", "--device",
             "cpu", "--batch", "32", "--hosts", "2", "--host-id", str(h),
             "--chunks", chunks, ref, fq],
            env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
    files = sorted(glob.glob(os.path.join(chunks, "chunk_*.sam")))
    assert len(files) == 4          # global numbering across both hosts
    merged = "".join(open(f).read() for f in files)
    assert merged == _body(single[0])


@pytest.mark.parametrize("workers", [1, 2])
def test_shard_filter_in_process(se_fixture, single, tmp_path, workers):
    """Each host computes only its own items, under either driver; the
    chunks of both hosts make the single-host body."""
    _, ref, fq, fq1, fq2 = se_fixture
    for kind, args, base in (("se", (fq,), single[0]),
                             ("pe", (fq1, fq2), single[1])):
        cdir = str(tmp_path / kind)
        for h in (0, 1):
            text = _align(ref, *args, chunk_dir=cdir, shard=(h, 2),
                          threads=workers)
            own = sorted(glob.glob(os.path.join(cdir, "chunk_*.sam")))
            assert _body(text) == "".join(
                open(f).read() for f in own if int(f[-10:-4]) % 2 == h)
        files = sorted(glob.glob(os.path.join(cdir, "chunk_*.sam")))
        assert "".join(open(f).read() for f in files) == _body(base)


def test_hosts_requires_chunks(se_fixture):
    from tpubwa_torch.align.pipeline import align_fastq

    _, ref, fq, _, _ = se_fixture
    with pytest.raises(ValueError, match="--chunks"):
        align_fastq(ref, fq, None, io.StringIO(), device="cpu",
                    shard=(0, 2))


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_threads_match_single(se_fixture, single, kind):
    _, ref, fq, fq1, fq2 = se_fixture
    args = (fq,) if kind == "se" else (fq1, fq2)
    want = single[0] if kind == "se" else single[1]
    assert _body(_align(ref, *args, threads=3)) == _body(want)


def test_cli_profile_writes_trace(se_fixture, tmp_path):
    _, ref, fq, _, _ = se_fixture
    with open(fq) as f:
        head = [next(f) for _ in range(4 * 8)]      # 8 reads
    fq = str(tmp_path / "r8.fq")
    with open(fq, "w") as f:
        f.writelines(head)
    trace = str(tmp_path / "trace")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "tpubwa_torch.cli", "mem", "--device", "cpu",
         "--batch", "32", "--profile", trace, ref, fq],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    files = glob.glob(os.path.join(trace, "*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 1000
    assert len(_body(r.stdout).splitlines()) >= 8   # the SAM still goes out


# ---------------------------------------------- tests/test_pool.py ----

def test_pool_worker_error_propagates_quickly():
    from tpubwa_torch.align.pipeline import run_ordered_pool

    def items():
        for i in range(100):
            yield i, 1

    def work(payload):
        if payload == 3:
            raise RuntimeError("boom")
        return f"item{payload}\n"

    for workers in (1, 2, 4):
        with pytest.raises(RuntimeError, match="boom"):
            run_ordered_pool(items(), work, io.StringIO(), workers)


def test_pool_reader_error_propagates():
    from tpubwa_torch.align.pipeline import run_ordered_pool

    def items():
        yield 0, 1
        raise ValueError("reader boom")

    with pytest.raises(ValueError, match="reader boom"):
        run_ordered_pool(items(), work=lambda p: "x\n", out=io.StringIO(),
                         workers=2)


def test_pool_ordered_output_many_workers():
    from tpubwa_torch.align.pipeline import run_ordered_pool

    def items():
        for i in range(50):
            yield i, 1

    out = io.StringIO()
    assert run_ordered_pool(items(), lambda p: f"{p}\n", out,
                            workers=16) == 50
    assert out.getvalue() == "".join(f"{i}\n" for i in range(50))


# ------------------------------------------------ thread-safety repairs ----

def test_first_build_is_thread_safe(tmp_path, monkeypatch):
    """Two threads reach a kernel's first use together: one nvcc run, no
    exception, one final library and no temporary left behind."""
    from tpubwa_torch.ops import cuda_build

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a kernel\n")
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:      # a slow build, written in pieces
            for _ in range(20):
                f.write("x" * 100)
                f.flush()
                time.sleep(0.005)
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda src: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    errs, libs = [], []
    start = threading.Barrier(2)

    def first_use():
        try:
            start.wait(timeout=10)
            libs.append(cuda_build.build("fake")[0])
        except BaseException as e:   # recorded, asserted below
            errs.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert errs == []
    assert len(calls) == 1
    files = os.listdir(build)
    assert len(files) == 1 and files[0].endswith(".so")
    assert libs == [str(build / files[0])] * 2
    assert os.path.getsize(build / files[0]) == 2000


def test_manifest_written_by_two_hosts_at_once(tmp_path, monkeypatch):
    """Two ``--hosts`` processes that start together both find no
    manifest and both write it; each publishes its own temporary, so
    neither fails and no temporary is left behind."""
    from tpubwa_torch.align.pipeline import _check_chunk_manifest

    replace = os.replace
    together = threading.Barrier(2)

    def replace_together(src, dst):    # both written before either moves
        together.wait(timeout=10)
        replace(src, dst)

    monkeypatch.setattr(os, "replace", replace_together)
    manifest = {"ref": ["ref.fa", 1, 2.0], "opt": {"batch_reads": 32}}
    errs = []

    def host():
        try:
            _check_chunk_manifest(str(tmp_path), manifest)
        except BaseException as e:   # recorded, asserted below
            errs.append(e)

    threads = [threading.Thread(target=host) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert errs == []
    assert os.listdir(tmp_path) == ["manifest.json"]
    _check_chunk_manifest(str(tmp_path), manifest)      # a resume accepts it
    with pytest.raises(RuntimeError, match="manifest"):
        _check_chunk_manifest(str(tmp_path), {**manifest, "opt": {}})


def test_overflow_count_same_under_threads(tmp_path):
    """Reads whose seed lists overflow (a per-read cap of 4 on a repeat
    genome): ``-t 4`` counts as many as ``-t 1``, with the thread switch
    interval shortened so that a lost update would show."""
    from tpubwa.utils.gensim import repeat_genome
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline

    codes = repeat_genome(np.random.default_rng(99), 30_000)
    contigs = [Contig("c1", 30_000, 0)]
    idx = FMIndex.build(contigs, codes)
    fq = str(tmp_path / "r.fq")
    sim.write_fastq(fq, sim.simulate_reads(codes, contigs, 32, length=100,
                                           err=0.01, seed=8))
    opt = MemOptions(batch_reads=8, max_seeds_per_read=4)
    counts, texts = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for workers in (1, 4):
            al = Aligner(idx, opt, device="cpu")
            out = io.StringIO()
            run_se_pipeline(al, fq, out, workers=workers)
            counts.append(al.n_overflow)
            texts.append(out.getvalue())
    finally:
        sys.setswitchinterval(old)
    assert counts[0] == counts[1] > 10
    assert texts[0] == texts[1]
