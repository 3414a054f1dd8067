"""The record API of the port's Aligner against the JAX package's:
``seed_batch`` (seed rows and l_rep), and ``align_se_batch`` (lists of
SamRecord through the generator tier, ``_se_records_from_regs``), whose
lines equal ``tpubwa``'s ``align_se_batch`` and the port's own
``align_se_text``.  On the golden fixture (its first batch of 64 reads,
whose lines are also the head of tests/golden/se.sam) and on the
realistic fixture of tests/test_torch_sam.py (N-islands, STRs, an all-N
read)."""
import os
import sys

import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_sam import GOLDEN_DIR, _build_fixture  # noqa: E402
from test_torch_sam import realistic  # noqa: E402,F401 (fixture)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    from tpubwa.io.fastq import batch_reads, read_fastq

    ref, se_fq, _, _ = _build_fixture(str(tmp_path_factory.mktemp("g")))
    batch = next(batch_reads(list(read_fastq(se_fq)), 64, 160))
    with open(os.path.join(GOLDEN_DIR, "se.sam")) as f:
        head = [ln for ln in f.read().splitlines()
                if not ln.startswith("@")]
    return FMIndex.load(ref), batch, head


@pytest.fixture(scope="module")
def realistic_batch(realistic):  # noqa: F811
    from tpubwa.io.fastq import Read, batch_reads

    idx, reads, _ = realistic
    rr = [Read(*r) for r in reads[:94]] + [
        Read("nread", "N" * 150, "I" * 150),
        Read("polya", "A" * 150, "I" * 150)]
    return idx, next(batch_reads(rr, 96, 160))


def _fixture(request, name):
    if name == "golden":
        idx, batch, _ = request.getfixturevalue("golden")
        return idx, batch
    return request.getfixturevalue("realistic_batch")


@pytest.mark.parametrize("name", ["golden", "realistic"])
def test_seed_batch_matches_jax(request, name):
    from tpubwa.align.pipeline import Aligner as JaxAligner
    from tpubwa_torch.align.pipeline import Aligner

    idx, batch = _fixture(request, name)
    opt = MemOptions(batch_reads=batch.n)
    rows, l_rep = Aligner(idx, opt, device="cpu").seed_batch(batch.codes,
                                                             batch.lens)
    want_rows, want_l_rep = JaxAligner(idx, opt).seed_batch(batch.codes,
                                                           batch.lens)
    assert len(rows) > batch.n
    np.testing.assert_array_equal(rows, np.asarray(want_rows))
    np.testing.assert_array_equal(l_rep[:batch.n],
                                  np.asarray(want_l_rep)[:batch.n])


@pytest.mark.parametrize("name", ["golden", "realistic"])
def test_align_se_batch_matches_jax_and_text(request, name):
    from tpubwa.align.pipeline import Aligner as JaxAligner
    from tpubwa_torch.align.pipeline import Aligner

    idx, batch = _fixture(request, name)
    opt = MemOptions(batch_reads=batch.n)
    al = Aligner(idx, opt, device="cpu")
    recs = al.align_se_batch(batch, 0)
    assert len(recs) == batch.n
    got = [r.line() for rl in recs for r in rl]
    want = [r.line() for rl in JaxAligner(idx, opt).align_se_batch(batch, 0)
            for r in rl]
    assert got == want
    assert got == al.align_se_text(batch, 0).splitlines()
    assert al.timers.counts["SAM"] == 2
    if name == "golden":
        assert got == request.getfixturevalue("golden")[2][:len(got)]


def test_records_from_given_regions(golden):
    """``_se_records_from_regs`` renders the regions it is given (here
    the port's regions_batch with one read's list emptied: that read
    comes out unmapped, the rest as align_se_batch gives them)."""
    from tpubwa_torch.align.pipeline import Aligner

    idx, batch, _ = golden
    al = Aligner(idx, MemOptions(batch_reads=batch.n), device="cpu")
    regs = al.regions_batch(batch)
    full = al._se_records_from_regs(batch, 0, regs)
    regs[3] = []
    cut = al._se_records_from_regs(batch, 0, regs)
    assert [r.line() for r in cut[3]] == [
        f"{batch.names[3]}\t4\t*\t0\t0\t*\t*\t0\t0\t{batch.seqs[3]}\t"
        f"{batch.quals[3]}"]
    assert [[r.line() for r in rl] for i, rl in enumerate(cut) if i != 3] \
        == [[r.line() for r in rl] for i, rl in enumerate(full) if i != 3]
