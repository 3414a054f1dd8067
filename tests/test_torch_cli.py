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
