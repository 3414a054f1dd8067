"""Edge reads and batch remainders through the port, against the JAX
package.

* tests/test_edge_reads.py's reads (empty, one base, all N, max length,
  too long, short) plus a read with an island of 20 N and reads of 18
  and 19 bases (just under and at the minimum seed length): the SAM
  equals the JAX package's and keeps that test's gates, and repeated
  runs are identical.  "too long" is past the port's 256 bp, so the batch
  stays in the narrow bucket, 160 wide, as the JAX package's.  A read of
  200 bp, which the JAX package leaves unmapped, the port aligns in a
  FASTQ of its own (the wide bucket).
* tests/test_fuzz_remainders.py's batch sizes 7, 32 and 61 (odd tail
  batches) give the JAX package's text, and so do its length extremes.
"""
import io
import os

import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig
from tpubwa.io.fastq import Read, batch_reads
from tpubwa.utils import sim
from tpubwa.utils.dna import decode
from tpubwa_torch.io.fastq import stream_batches

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """tests/test_edge_reads.py's reference (30 kb, seed 5)."""
    d = tmp_path_factory.mktemp("t_edge")
    codes = np.random.default_rng(5).integers(0, 4, 30000).astype(np.uint8)
    path = os.path.join(str(d), "ref.fa")
    with open(path, "w") as f:
        f.write(">e1\n")
        seq = decode(codes)
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")
    FMIndex.from_fasta(path).save(path)
    return path, codes


def _fastq(path, reads):
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def _port(ref_path, fq):
    from tpubwa_torch.align.pipeline import align_fastq

    buf = io.StringIO()
    assert align_fastq(ref_path, fq, None, buf, device="cpu",
                       batch_reads=32) == 0
    return [ln for ln in buf.getvalue().splitlines()
            if not ln.startswith("@")]


def _jax(ref_path, fq):
    from tpubwa.align.pipeline import align_fastq

    buf = io.StringIO()
    assert align_fastq(ref_path, fq, None, buf, batch_reads=32) == 0
    return [ln for ln in buf.getvalue().splitlines()
            if not ln.startswith("@")]


def test_edge_reads_match_jax(ref, tmp_path):
    from tpubwa_torch.config import LONG_READ_LEN

    ref_path, codes = ref
    max_len = 160  # MemOptions default max_read_len
    good = decode(codes[1000:1000 + 150])
    reads = [
        ("empty", ""),
        ("one_base", "A"),
        ("all_n", "N" * 100),
        ("max_len", decode(codes[2000:2000 + max_len])),
        ("too_long", decode(codes[:LONG_READ_LEN + 40])),
        ("good", good),
        ("short", good[:8]),
        ("n_island", good[:65] + "N" * 20 + good[85:]),
        ("len18", decode(codes[5000:5018])),
        ("len19", decode(codes[6000:6019])),
    ]
    fq = str(tmp_path / "edge.fq")
    _fastq(fq, reads)
    assert next(stream_batches(fq, 32, max_len)).codes.shape[1] == max_len
    recs = _port(ref_path, fq)
    assert recs == _jax(ref_path, fq)
    by_name = {}
    for line in recs:
        f = line.split("\t")
        by_name.setdefault(f[0], []).append(f)
    assert set(by_name) == {n for n, _ in reads}
    # len19 seeds but scores under the output threshold T = 30
    for n in ("empty", "one_base", "all_n", "too_long", "short", "len18",
              "len19"):
        assert int(by_name[n][0][1]) & 4, f"{n} should be unmapped"
    assert int(by_name["max_len"][0][3]) == 2001
    assert int(by_name["good"][0][3]) == 1001
    assert int(by_name["good"][0][4]) > 0
    assert int(by_name["n_island"][0][3]) == 1001


def test_a_200bp_read_aligns_in_the_wide_bucket(ref, tmp_path):
    """A 200-bp read, past the JAX package's 160 bp, runs in the port's
    wide bucket (with a 150-bp read padded to it) and maps end to end."""
    from tpubwa_torch.config import LONG_READ_LEN

    ref_path, codes = ref
    fq = str(tmp_path / "long.fq")
    _fastq(fq, [("long", decode(codes[3000:3200])),
                ("good", decode(codes[1000:1150]))])
    assert next(stream_batches(fq, 32, 160)).codes.shape[1] == LONG_READ_LEN
    by_name = {f[0]: f for f in (ln.split("\t") for ln in _port(ref_path, fq))}
    assert set(by_name) == {"long", "good"}
    for name, pos, cigar in (("long", 3001, "200M"), ("good", 1001, "150M")):
        assert not int(by_name[name][1]) & 4
        assert (int(by_name[name][3]), by_name[name][5]) == (pos, cigar)


def test_edge_reads_repeat_identical(ref, tmp_path):
    """Repeated runs of reads with injected errors are byte-identical,
    and equal to the JAX package's."""
    ref_path, codes = ref
    rng = np.random.default_rng(9)
    reads = []
    for i in range(40):
        p = int(rng.integers(0, len(codes) - 120))
        s = list(decode(codes[p:p + 120]))
        for _ in range(3):
            s[int(rng.integers(0, len(s)))] = "ACGT"[int(rng.integers(0, 4))]
        reads.append((f"r{i}", "".join(s)))
    fq = str(tmp_path / "stab.fq")
    _fastq(fq, reads)
    first = _port(ref_path, fq)
    assert _port(ref_path, fq) == first
    assert first == _jax(ref_path, fq)


@pytest.fixture(scope="module")
def remainders():
    """tests/test_fuzz_remainders.py's genome (40 kb, seed 23), 61 reads
    of 111 bp with indels, and the JAX text at batch 61."""
    from tpubwa.align.pipeline import Aligner as JaxAligner

    codes = np.random.default_rng(23).integers(0, 4, 40000).astype(np.uint8)
    contigs = [Contig("c1", 40000, 0)]
    idx = FMIndex.build(contigs, codes)
    reads = [Read(n, s, q) for n, s, q in sim.simulate_reads(
        codes, contigs, 61, length=111, err=0.02, indel=0.003, seed=31)]
    b = next(batch_reads(reads, 61, 128))
    want = JaxAligner(idx, MemOptions(batch_reads=61, max_read_len=128)
                      ).align_se_text(b, 0)
    return codes, idx, reads, want


@pytest.mark.parametrize("bs", [7, 32, 61])
def test_odd_batch_sizes_match_jax(remainders, bs):
    from tpubwa_torch.align.pipeline import Aligner

    _, idx, reads, want = remainders
    al = Aligner(idx, MemOptions(batch_reads=bs, max_read_len=128),
                 device="cpu")
    text, rid0 = [], 0
    for b in batch_reads(reads, bs, 128):
        text.append(al.align_se_text(b, rid0))
        rid0 += b.n
    assert "".join(text) == want


def test_length_extremes_match_jax(remainders):
    from tpubwa.align.pipeline import Aligner as JaxAligner
    from tpubwa_torch.align.pipeline import Aligner

    codes, idx, _, _ = remainders
    rng = np.random.default_rng(5)
    rows = []
    for ln in (1, 18, 19, 20, 127, 128):
        p = int(rng.integers(0, 40000 - 128))
        rows.append(Read(f"len{ln}", decode(codes[p:p + ln]), "I" * ln))
    b = next(batch_reads(rows, 8, 128))
    opt = MemOptions(batch_reads=8, max_read_len=128)
    got = Aligner(idx, opt, device="cpu").align_se_text(b, 0)
    assert got == JaxAligner(idx, opt).align_se_text(b, 0)
    by_name = {ln.split("\t")[0]: ln.split("\t") for ln in got.splitlines()}
    assert set(by_name) == {r.name for r in rows}
    assert int(by_name["len1"][1]) & 4
    assert not int(by_name["len128"][1]) & 4
