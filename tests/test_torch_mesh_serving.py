"""The serving modes on a device mesh of CPU shards: ``--sa-shift``,
``-t 2``, ``--chunks`` (run, then resumed from its chunks), the v5e-4
preset (four shards) through ``align_fastq``, and the preset's options
reaching an Aligner of four shards.  Each SAM body is the one-device
body on the 100 kb repeat genome of ``test_torch_mesh.py``."""
import io
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_mesh import repeat_genome_fixture  # noqa: E402

torch.set_num_threads(1)

N_READS = 48
BATCH = 20


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from tpubwa_torch.align.pipeline import align_fastq
    from tpubwa_torch.utils.dna import decode
    from tpubwa_torch.utils.sim import write_fastq

    d = repeat_genome_fixture()
    tmp = tmp_path_factory.mktemp("mesh_serving")
    fa = str(tmp / "ref.fa")
    with open(fa, "w") as f:
        f.write(">c1\n" + decode(d["codes"]) + "\n")
    d["idx"].save(fa)
    fq = str(tmp / "r.fq")
    write_fastq(fq, [(r.name, r.seq, r.qual)
                     for r in d["reads"][:N_READS]])
    out = io.StringIO()
    assert align_fastq(fa, fq, None, out, device="cpu",
                       batch_reads=BATCH) == 0
    return fa, fq, _body(out.getvalue()), tmp


def _body(sam: str) -> str:
    return "".join(ln for ln in sam.splitlines(True)
                   if not ln.startswith("@"))


@pytest.mark.parametrize("kw", [
    dict(device="cpu,cpu,cpu", sa_sample_shift=3),
    dict(device="cpu,cpu,cpu", threads=2),
    dict(device="cpu,cpu,cpu", chunks=True),
    dict(device="cpu", preset="v5e-4"),
], ids=["sa-shift", "threads", "chunks", "preset-v5e-4"])
def test_serving_mode_on_mesh(files, kw):
    from tpubwa_torch.align.pipeline import align_fastq

    fa, fq, want, tmp = files
    assert want.count("\n") >= N_READS
    runs = 1
    if kw.pop("chunks", False):
        kw["chunk_dir"] = str(tmp / "ck")
        runs = 2                        # the second run resumes
    for _ in range(runs):
        out = io.StringIO()
        assert align_fastq(fa, fq, None, out, batch_reads=BATCH, **kw) == 0
        assert _body(out.getvalue()) == want
    if runs == 2:
        assert len(os.listdir(tmp / "ck")) == 4      # 3 chunks + manifest


def test_preset_reaches_four_shards(files):
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex

    fa, fq, want, _ = files
    opt = MemOptions.preset("v5e-4", batch_reads=32)
    al = Aligner(FMIndex.load(fa), opt, device="cpu")
    assert len(al.mesh) == 4 and opt.mesh_shape == (4,)
    out = io.StringIO()
    assert run_se_pipeline(al, fq, out) == N_READS
    assert out.getvalue() == want
