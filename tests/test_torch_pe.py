"""Paired ends through the port on the CPU, against the JAX package.

* ``align_fastq`` with two FASTQs reproduces tests/golden/pe.sam byte for
  byte (@PG stripped), under both extension layouts.
* ``align_pe_batch`` equals the JAX ``align_pe_batch`` text on
  tests/test_pe_flat.py's repeat-genome fixture plus pairs whose second
  end carries ~8 % errors, and the mate-rescue rounds really ran.
* The generator tier (``FLAT_PE = False``) and ``ext_layout="b"`` give
  the same text, on the repeat fixture at 125 bp (the narrow widths) and
  at 250 bp (the wide widths), with pairs on both tiers.
* FASTQs of unequal length write every complete batch and return 1.
"""
import io
import os
import sys

import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig
from tpubwa.io.fastq import Read, batch_reads
from tpubwa.utils import sim

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_sam import GOLDEN_DIR, _build_fixture, _strip_pg  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return _build_fixture(str(tmp_path_factory.mktemp("golden_pe")))


@pytest.mark.parametrize("layout", ["t", "b"])
def test_golden_pe_sam_byte_for_byte(golden, layout):
    from tpubwa_torch.align.pipeline import align_fastq

    ref, _, fq1, fq2 = golden
    buf = io.StringIO()
    assert align_fastq(ref, fq1, fq2, buf, device="cpu", batch_reads=64,
                       ext_layout=layout) == 0
    with open(os.path.join(GOLDEN_DIR, "pe.sam")) as f:
        assert _strip_pg(buf.getvalue()) == f.read()


@pytest.fixture(scope="module")
def repeat_setup():
    return repeat_inputs()


def repeat_inputs(read_len: int = 125):
    """tests/test_pe_flat.py's repeat genome and pairs, plus a 40 kb
    unique contig with 64 pairs: they give pestat its insert-size model
    (the repeat pairs alone are too ambiguous for it), and in 32 of them
    the second end carries ~8 % extra substitutions, so its seeds miss
    and the mate rescue has work.  Reads of 250 bp (insert 550 +- 100)
    are batched by the port's reader, at the wide bucket's width."""
    from tpubwa.utils.gensim import repeat_genome
    from tpubwa_torch.io import fastq as port_fastq

    rng = np.random.default_rng(23)
    codes = np.concatenate([repeat_genome(rng, 120_000),
                            rng.integers(0, 4, 40_000).astype(np.uint8)])
    contigs = [Contig("cR", 120_000, 0), Contig("cU", 40_000, 120_000)]
    idx = FMIndex.build(contigs, codes)
    ins = {} if read_len <= 160 else dict(isize_mean=550, isize_std=100)
    r1, r2 = sim.simulate_pairs(codes[:120_000], contigs[:1], 96,
                                length=read_len, err=0.01, indel=0.002,
                                seed=31, **ins)
    u1, u2 = sim.simulate_pairs(codes[120_000:], [Contig("cU", 40_000, 0)],
                                64, length=read_len, err=0.01, seed=41,
                                **ins)
    noisy = np.random.default_rng(43)
    for k in range(32, 64):
        s2 = np.array(list(u2[k][1]))
        hit = noisy.random(s2.size) < 0.08
        s2[hit] = ["CGTA"["ACGT".index(c)] for c in s2[hit]]
        u2[k] = (u2[k][0], "".join(s2), u2[k][2])
    r1 += [("u" + n, s_, q) for n, s_, q in u1]
    r2 += [("u" + n, s_, q) for n, s_, q in u2]
    rd, batch = ((Read, batch_reads) if read_len <= 160
                 else (port_fastq.Read, port_fastq.batch_reads))
    b1, b2 = (next(batch([rd(n, s_, q) for n, s_, q in r], 160, 160))
              for r in (r1, r2))
    return idx, b1, b2


def _port_text(idx, b1, b2, layout="t", flat=True, counters=None):
    from tpubwa_torch.align import pair
    from tpubwa_torch.align.pipeline import Aligner

    al = Aligner(idx, MemOptions(batch_reads=160, max_read_len=160),
                 device="cpu", ext_layout=layout)
    try:
        pair.FLAT_PE = flat
        return pair.align_pe_batch(al, b1, b2, 0)
    finally:
        pair.FLAT_PE = True
        if counters is not None:
            counters.update(al.timers.counters)


@pytest.fixture(scope="module")
def port_flat(repeat_setup):
    """The port's text on the repeat fixture, and the lane count of each
    mate-rescue round it ran."""
    from tpubwa_torch.align import pair

    lanes = []
    core = pair.localsw_core

    def counting(query, *a, **kw):
        lanes.append(query.shape[0])
        return core(query, *a, **kw)

    pair.localsw_core = counting
    counters = {}
    try:
        return _port_text(*repeat_setup, counters=counters), lanes, counters
    finally:
        pair.localsw_core = core


def test_pe_batch_matches_jax_with_rescue(repeat_setup, port_flat):
    from tpubwa.align.pair import align_pe_batch as jax_pe_batch
    from tpubwa.align.pipeline import Aligner as JaxAligner

    idx, b1, b2 = repeat_setup
    got, lanes, _ = port_flat
    want = jax_pe_batch(
        JaxAligner(idx, MemOptions(batch_reads=160, max_read_len=160)),
        b1, b2, 0)
    assert got == want
    assert len(lanes) >= 2 and sum(lanes) >= 50, lanes   # rescue SWs ran
    assert "XA:Z:" in got


@pytest.mark.parametrize("read_len", [125, 250])
def test_pe_generator_tier_and_layout_b_same_text(request, read_len):
    if read_len == 125:
        setup = request.getfixturevalue("repeat_setup")
        flat, _, counters = request.getfixturevalue("port_flat")
    else:
        setup, counters = repeat_inputs(read_len), {}
        flat = _port_text(*setup, counters=counters)
    assert setup[1].codes.shape[1] == (160 if read_len <= 160 else 256)
    assert counters["sam.flat_pairs"] > 0     # the flat tier rendered
    assert _port_text(*setup, flat=False) == flat
    assert _port_text(*setup, layout="b") == flat


def test_unequal_fastqs_write_complete_batches(tmp_path):
    from tpubwa_torch.align.pipeline import align_fastq

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 20_000).astype(np.uint8)
    contigs = [Contig("c1", 20_000, 0)]
    ref = str(tmp_path / "ref.fa")
    with open(ref, "w") as f:
        f.write(">c1\n" + "".join("ACGT"[c] for c in codes) + "\n")
    FMIndex.build(contigs, codes).save(ref)
    r1, r2 = sim.simulate_pairs(codes, contigs, 40, length=100, seed=3)
    fq1, fq2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    sim.write_fastq(fq1, r1)
    sim.write_fastq(fq2, r2[:36])          # batch 3 is 8 vs 4 reads
    buf = io.StringIO()
    assert align_fastq(ref, fq1, fq2, buf, device="cpu",
                       batch_reads=16) == 1
    body = [ln.split("\t") for ln in buf.getvalue().splitlines()
            if not ln.startswith("@")]
    names = {r[0] for r in body}
    assert names == {n for n, _, _ in r1[:32]}   # batches 1 and 2
    assert sum(not int(r[1]) & 0x900 for r in body) == 64
