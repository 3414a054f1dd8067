"""The port stands alone: in a fresh interpreter, importing
``tpubwa_torch.align.pipeline``, ``tpubwa_torch.cli``,
``tpubwa_torch.tools.big``, ``tpubwa_torch.utils.gensim`` and the modules of
the per-read path, the fused device step and the oracles, aligning a few
reads (sampled SA, two workers) and a few pairs on the CPU, and running the
per-read path and ``device_align_step`` on those reads, with the fixture
made by the port's own copies, leaves ``jax`` and every ``tpubwa`` module
out of ``sys.modules``; and no source of the port, nor
``chip_smoke.py``, imports ``tpubwa``.  Also the CLI's refusals: no silent CPU
fallback for ``--device cuda`` without a card, the JAX CLI's checks of
``--hosts``, and a device mesh refused in one line where its devices do
not match (a device list of the wrong length, or ``--device cuda`` for a
mesh of four when torch sees no card)."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import io, sys
import numpy as np
import torch
torch.set_num_threads(1)
import tpubwa_torch.align.pipeline
import tpubwa_torch.cli
import tpubwa_torch.tools.big
import tpubwa_torch.utils.gensim
import tpubwa_torch.align.chain, tpubwa_torch.align.region
import tpubwa_torch.ops.extend_ref, tpubwa_torch.ops.fm_ref
import tpubwa_torch.parallel.mesh
from tpubwa_torch.index.fmindex import FMIndex
from tpubwa_torch.io.fasta import Contig
from tpubwa_torch.utils import sim

d = sys.argv[1]
codes = np.random.default_rng(1).integers(0, 4, 8000).astype(np.uint8)
contigs = [Contig("c1", 8000, 0)]
with open(d + "/ref.fa", "w") as f:
    f.write(">c1\n" + "".join("ACGT"[c] for c in codes) + "\n")
FMIndex.build(contigs, codes).save(d + "/ref.fa")
sim.write_fastq(d + "/r.fq", sim.simulate_reads(codes, contigs, 12, seed=2))
rc = tpubwa_torch.cli.main(["mem", "--device", "cpu", "--sa-shift", "2",
                            "-t", "2", d + "/ref.fa", d + "/r.fq"])
assert rc == 0, rc
r1, r2 = sim.simulate_pairs(codes, contigs, 16, length=100, seed=3)
sim.write_fastq(d + "/p1.fq", r1)
sim.write_fastq(d + "/p2.fq", r2)
rc = tpubwa_torch.cli.main(["mem", "--device", "cpu", "--ext-layout", "b",
                            d + "/ref.fa", d + "/p1.fq", d + "/p2.fq"])
assert rc == 0, rc
from tpubwa_torch.align.pipeline import Aligner
from tpubwa_torch.io.fastq import batch_reads, read_fastq
from tpubwa_torch.parallel.mesh import device_align_step
al = Aligner(FMIndex.load(d + "/ref.fa"), device="cpu")
batch = next(batch_reads(list(read_fastq(d + "/r.fq")), 12, 160))
rows, l_rep = al.seed_batch(batch.codes, batch.lens)
regs = al.extend_batch_rounds(batch.codes, batch.lens,
                              al.chain_batch(rows, l_rep, batch.lens))
assert sum(map(len, regs)) >= 10, regs
step = device_align_step(al.di, torch.as_tensor(batch.codes),
                         torch.as_tensor(batch.lens), al.mat)
assert (step[4] > 0).sum() >= 10, step[4]
print("JAX_LOADED", "jax" in sys.modules, file=sys.stderr)
print("TPUBWA_LOADED", sorted(m for m in sys.modules if m == "tpubwa"
                              or m.startswith("tpubwa.")), file=sys.stderr)
"""


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)


def test_port_runs_without_jax(tmp_path):
    p = _run(["-c", SCRIPT, str(tmp_path)], tmp_path)
    assert p.returncode == 0, p.stderr
    assert "JAX_LOADED False" in p.stderr
    assert "TPUBWA_LOADED []" in p.stderr
    sam = [ln.split("\t") for ln in p.stdout.splitlines()
           if not ln.startswith("@")]
    se = [f for f in sam if not int(f[1]) & 1]
    pe = [f for f in sam if int(f[1]) & 1]
    assert len(se) >= 12
    assert sum(not int(f[1]) & 4 for f in se) >= 10
    assert sum(not int(f[1]) & 0x900 for f in pe) == 32
    assert sum(int(f[1]) & 2 > 0 for f in pe) >= 24      # proper pairs


def test_port_sources_do_not_import_tpubwa():
    """No ``import tpubwa`` / ``from tpubwa`` (followed by ``.`` or white
    space) in any source of the port or in chip_smoke.py; ``tpubwa_torch``
    itself does not match."""
    pat = re.compile(r"^\s*(?:from|import)\s+tpubwa(?:\.|\s|$)", re.M)
    assert pat.search("import tpubwa\n")
    assert pat.search("from tpubwa.x import y")
    assert not pat.search("from tpubwa_torch.ops import fm")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "tpubwa_torch")):
        files += [os.path.join(base, n) for n in names
                  if n.endswith((".py", ".cu", ".cpp", ".h"))]
    assert len(files) > 30
    for new in ("align/chain.py", "align/region.py", "ops/extend_ref.py",
                "ops/fm_ref.py", "native/chain.cpp"):
        assert os.path.join(ROOT, "tpubwa_torch", new) in files, new
    bad = []
    for path in files:
        with open(path) as f:
            if pat.search(f.read()):
                bad.append(os.path.relpath(path, ROOT))
    assert not bad, bad


@pytest.mark.parametrize("argv,err", [
    (["--hosts", "2"], "--hosts requires --chunks DIR"),
    (["--hosts", "2", "--host-id", "2", "--chunks", "c"],
     "--host-id must be in [0, --hosts)"),
    (["--preset", "v5e-4", "--device", "cpu,cpu"],
     "tpu-bwa-torch mem: the device list names 2 device(s) but the mesh "
     "has 4"),
    (["--preset", "v5e-4", "--device", "cuda"],
     "tpu-bwa-torch mem: a mesh of 4 CUDA devices, but torch sees no CUDA "
     "device"),
], ids=["hosts-without-chunks", "host-id-range", "mesh-device-list",
        "mesh-without-cards"])
def test_cli_refuses_unported_paths(tmp_path, argv, err):
    """Invalid host splits are refused as the JAX CLI refuses them; a
    device mesh whose devices do not match is refused in one line."""
    import numpy as np

    from tpubwa.index.fmindex import FMIndex
    from tpubwa.io.fasta import Contig

    if "cuda" in argv and torch_sees_cards(4):
        pytest.skip("this machine has the cards: the mesh runs")
    codes = np.random.default_rng(1).integers(0, 4, 2000).astype(np.uint8)
    (tmp_path / "REF").write_text(">c1\n" + "".join("ACGT"[c] for c in codes)
                                  + "\n")
    FMIndex.build([Contig("c1", 2000, 0)], codes).save(str(tmp_path / "REF"))
    (tmp_path / "R").write_text("")
    p = _run(["-m", "tpubwa_torch.cli", "mem", "--device", "cpu", *argv,
              "REF", "R"], tmp_path)
    assert p.returncode != 0
    assert err in p.stderr
    if argv[0] == "--preset":
        assert p.returncode == 1 and "Traceback" not in p.stderr


def torch_sees_cards(n: int) -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.device_count() >= n


def test_cuda_device_without_card_raises():
    import torch

    from tpubwa_torch.align.pipeline import resolve_device

    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
