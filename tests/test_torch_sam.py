"""End-to-end SAM through the port on the CPU.

* ``align_fastq`` reproduces tests/golden/se.sam byte for byte on the
  fixture and batch size of tests/test_golden_sam.py (@PG stripped).
* The gates of tests/test_realistic_fixture.py (N-islands, STRs, GC
  isochores): one primary per read, mapping-rate floors, an all-N read
  unmapped — and the port's SAM text equals the JAX Aligner's on it.
"""
import io
import os
import sys

import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_sam import GOLDEN_DIR, _build_fixture, _strip_pg  # noqa: E402

torch.set_num_threads(1)

LENGTH = 200_000
N_READS = 160


def test_golden_se_sam_byte_for_byte(tmp_path):
    from tpubwa_torch.align.pipeline import align_fastq

    ref, se_fq, _, _ = _build_fixture(str(tmp_path))
    buf = io.StringIO()
    assert align_fastq(ref, se_fq, None, buf, device="cpu",
                       batch_reads=64) == 0
    with open(os.path.join(GOLDEN_DIR, "se.sam")) as f:
        assert _strip_pg(buf.getvalue()) == f.read()


@pytest.fixture(scope="module")
def realistic(tmp_path_factory):
    """tests/test_realistic_fixture.py's genome and reads."""
    from tpubwa.io.fasta import read_fasta
    from tpubwa.utils import sim
    from tpubwa.utils.dna import decode, revcomp_codes
    from tpubwa.utils.simgenome import realistic_genome

    codes = realistic_genome(np.random.default_rng(77), LENGTH)
    d = tmp_path_factory.mktemp("realg")
    fa = str(d / "realg.fa")
    with open(fa, "w") as f:
        f.write(">rg1\n")
        seq = decode(codes)
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")
    FMIndex.from_fasta(fa).save(fa)
    _, codes2, holes = read_fasta(fa)
    assert len(holes) >= 5
    ok = np.lib.stride_tricks.sliding_window_view(codes2 < 4, 150).all(1)
    good_pos = np.nonzero(ok)[0]
    reads = []
    rr = np.random.default_rng(9)
    for i in range(N_READS):
        pos = int(good_pos[rr.integers(0, len(good_pos))])
        strand = int(rr.integers(0, 2))
        s = sim._mutate(rr, codes2[pos:pos + 150].copy(), 0.01, 0.001, 150)
        if strand:
            s = revcomp_codes(s)
        reads.append((f"sim_{i}_0_{pos}_{strand}", decode(s), "I" * len(s)))
    fq = str(d / "r.fq")
    sim.write_fastq(fq, reads)
    return FMIndex.load(fa), reads, fq


def test_realistic_gates_through_port(realistic):
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline

    idx, reads, fq = realistic
    out = io.StringIO()
    run_se_pipeline(Aligner(idx, MemOptions(batch_reads=64), device="cpu"),
                    fq, out)
    prim = {}
    for line in out.getvalue().splitlines():
        f = line.split("\t")
        if int(f[1]) & 0x900:
            continue
        assert f[0] not in prim, "duplicate primary"
        prim[f[0]] = (int(f[1]), f[2], int(f[3]))
    assert len(prim) == N_READS
    mapped = [(n, p) for n, (fl, r, p) in prim.items() if not fl & 4]
    near = sum(abs(p - 1 - int(n.split("_")[3])) <= 50 for n, p in mapped)
    assert len(mapped) >= int(0.97 * N_READS)
    assert near >= int(0.92 * N_READS)


def test_realistic_sam_matches_jax_and_n_reads(realistic):
    from tpubwa.align.pipeline import Aligner as JaxAligner
    from tpubwa.io.fastq import Read, batch_reads
    from tpubwa_torch.align.pipeline import Aligner

    idx, reads, _ = realistic
    rr = [Read(*r) for r in reads[:94]] + [
        Read("nread", "N" * 150, "I" * 150),
        Read("polya", "A" * 150, "I" * 150)]
    batch = next(batch_reads(rr, 96, 160))
    got = Aligner(idx, MemOptions(batch_reads=96),
                  device="cpu").align_se_text(batch, 0)
    want = JaxAligner(idx, MemOptions(batch_reads=96)).align_se_text(batch, 0)
    assert got == want
    rows = {ln.split("\t")[0]: ln.split("\t") for ln in got.splitlines()
            if not int(ln.split("\t")[1]) & 0x900}
    assert int(rows["nread"][1]) & 4
    assert "polya" in rows
