"""The port's CLI on bad input: one line on stderr, exit code 1, no
traceback, as the JAX package's CLI does.

A FASTQ whose third line lacks the ``+`` goes through ``main`` of both
CLIs.  An unknown ``--preset`` and an ``--ext-layout`` outside ``t|b`` are
stopped by argparse's ``choices`` (exit code 2) before ``cmd_mem`` sees
them, so those two reach ``cmd_mem`` as a parsed namespace with the one
value replaced.  A ``RuntimeError`` is not caught: a refused manifest, a
missing GPU and a failed build stay loud.
"""
import argparse
import os

import numpy as np
import pytest
import torch

import tpubwa.cli
import tpubwa_torch.cli
from tpubwa_torch.index.fmindex import FMIndex
from tpubwa_torch.utils.dna import decode

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("t_cli"))
    codes = np.random.default_rng(5).integers(0, 4, 4000).astype(np.uint8)
    ref = os.path.join(d, "ref.fa")
    with open(ref, "w") as f:
        f.write(">c1\n" + decode(codes) + "\n")
    FMIndex.from_fasta(ref).save(ref)
    seq = decode(codes[100:150])
    good = os.path.join(d, "good.fq")
    with open(good, "w") as f:
        f.write(f"@r0\n{seq}\n+\n{'I' * 50}\n")
    bad = os.path.join(d, "bad.fq")
    with open(bad, "w") as f:
        f.write(f"@r0\n{seq}\n+\n{'I' * 50}\n@r1\n{seq}\n-\n{'I' * 50}\n")
    return ref, good, bad


def _namespace(ref, fq, **over):
    ns = argparse.Namespace(
        ref=ref, reads1=fq, reads2=None, device="cpu", ext_layout="t", t=1,
        k=19, batch=None, preset=None, chunks=None, sa_shift=0, profile=None,
        hosts=None, host_id=0)
    vars(ns).update(over)
    return ns


@pytest.mark.parametrize("case", ["fastq", "fastq-profiled", "preset",
                                  "ext-layout"])
def test_bad_input_is_one_line_and_exit_1(files, case, capsys, tmp_path):
    ref, good, bad = files
    if case == "fastq":
        rc = tpubwa_torch.cli.main(["mem", "--device", "cpu", ref, bad])
    elif case == "fastq-profiled":
        rc = tpubwa_torch.cli.main(["mem", "--device", "cpu", "--profile",
                                    str(tmp_path / "trace"), ref, bad])
    elif case == "preset":
        rc = tpubwa_torch.cli.cmd_mem(_namespace(ref, good, preset="v9z-2"))
    else:
        rc = tpubwa_torch.cli.cmd_mem(_namespace(ref, good, ext_layout="x"))
    err = capsys.readouterr().err
    assert rc == 1
    lines = [ln for ln in err.splitlines()
             if ln.startswith("tpu-bwa-torch mem:")]
    assert len(lines) == 1 and "Traceback" not in err
    # nothing else but progress lines of the run itself
    assert all(ln.startswith(("tpu-bwa-torch mem:", "[tpu-bwa-torch]", "["))
               for ln in err.splitlines())
    if case.startswith("fastq"):
        assert "malformed FASTQ" in lines[0]
        rc_jax = tpubwa.cli.main(["mem", ref, bad])
        err_jax = capsys.readouterr().err
        assert rc_jax == 1 and "Traceback" not in err_jax
        jax_lines = [ln for ln in err_jax.splitlines()
                     if ln.startswith("tpu-bwa mem:")]
        assert len(jax_lines) == 1
        # the same message after the program's name
        assert (jax_lines[0].split(": ", 1)[1]
                == lines[0].split(": ", 1)[1])


def test_good_input_still_exits_0(files, capsys):
    ref, good, _ = files
    assert tpubwa_torch.cli.main(["mem", "--device", "cpu", ref, good]) == 0
    out = capsys.readouterr().out
    assert out.startswith("@") and "\nr0\t" in out


def test_runtime_errors_stay_loud(files, monkeypatch):
    """Only ValueError becomes a line: anything else propagates."""
    import tpubwa_torch.align.pipeline as pipeline

    ref, good, _ = files

    def refuse(**kw):
        raise RuntimeError("manifest refused")

    monkeypatch.setattr(pipeline, "align_fastq", refuse)
    with pytest.raises(RuntimeError, match="manifest refused"):
        tpubwa_torch.cli.main(["mem", "--device", "cpu", ref, good])


def test_mesh_preset_on_cpu_equals_one_device(files, capsys):
    """``--preset v5e-4 --device cpu``: four CPU shards, named in the
    banner, and the one-device body."""
    ref, good, _ = files
    bodies = []
    for argv in (["--device", "cpu"],
                 ["--preset", "v5e-4", "--device", "cpu"]):
        assert tpubwa_torch.cli.main(["mem", *argv, ref, good]) == 0
        cap = capsys.readouterr()
        bodies.append([ln for ln in cap.out.splitlines()
                       if not ln.startswith("@")])
    assert "mesh of 4: cpu, cpu, cpu, cpu (batch 32768" in cap.err
    assert bodies[0] == bodies[1] and bodies[0][0].startswith("r0\t")


@pytest.mark.parametrize("case", ["device-list", "shard-sa-without-mesh"])
def test_mesh_refusals_are_one_line(files, case, capsys, monkeypatch):
    """A device list of the wrong length, and ``shard_sa`` without a mesh
    (no CLI option sets it: here through the options ``align_fastq``
    builds), are one line and exit code 1; the second is the JAX
    package's own message."""
    import dataclasses

    import tpubwa_torch.align.pipeline as pipeline

    ref, good, _ = files
    if case == "device-list":
        argv = ["--preset", "v5e-4", "--device", "cpu,cpu,cpu"]
        want = "the device list names 3 device(s) but the mesh has 4"
    else:
        from tpubwa.align.pipeline import Aligner as JaxAligner
        from tpubwa.config import MemOptions as JaxOptions
        from tpubwa.index.fmindex import FMIndex as JaxIndex

        @dataclasses.dataclass
        class ShardedOptions(pipeline.MemOptions):
            shard_sa: bool = True

        monkeypatch.setattr(pipeline, "MemOptions", ShardedOptions)
        argv = ["--device", "cpu"]
        with pytest.raises(ValueError) as e:
            JaxAligner(JaxIndex.load(ref), JaxOptions(shard_sa=True))
        want = str(e.value)
    rc = tpubwa_torch.cli.main(["mem", *argv, ref, good])
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines()
             if ln.startswith("tpu-bwa-torch mem:")]
    assert rc == 1 and "Traceback" not in err
    assert lines == [f"tpu-bwa-torch mem: {want}"]


def test_two_hosts_with_coordinator(files, tmp_path):
    """Two ``--hosts 2 --coordinator 127.0.0.1:PORT`` processes join one
    gloo group (each waits for the other) and their chunks concatenate to
    the single-host body."""
    import socket
    import subprocess
    import sys

    from tpubwa_torch.utils import sim

    ref, _, _ = files
    idx = FMIndex.load(ref)
    codes = np.random.default_rng(5).integers(0, 4, 4000).astype(np.uint8)
    fq = str(tmp_path / "r.fq")
    sim.write_fastq(fq, sim.simulate_reads(codes, idx.contigs, 24, seed=4))
    want = io_body(["mem", "--device", "cpu", "--batch", "8", ref, fq])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpubwa_torch.cli", "mem", "--device", "cpu",
         "--batch", "8", "--hosts", "2", "--host-id", str(h), "--chunks",
         str(tmp_path / "ck"), "--coordinator", f"127.0.0.1:{port}", ref,
         fq], env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for h in (0, 1)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], errs
    chunks = sorted((tmp_path / "ck").glob("chunk_*.sam"))
    assert len(chunks) == 3
    assert "".join(c.read_text() for c in chunks) == want


def io_body(argv) -> str:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tpubwa_torch.cli.main(argv) == 0
    return "".join(ln for ln in buf.getvalue().splitlines(True)
                   if not ln.startswith("@"))
