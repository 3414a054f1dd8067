"""The port's FASTQ reader, ``io/fastq.py::stream_batches``, which parses a
batch's records from a block of bytes at once.

* Every batch equals, field by field (``codes``, ``lens``, ``names``,
  ``seqs``, ``quals``) and in the warnings it prints, what the JAX
  package's ``tpubwa.io.fastq.stream_batches`` (a line parser, independent
  of the port's code) gives at the batch's bucket: at ``max_len`` where no
  read of the batch is longer, else at ``LONG_READ_LEN`` (the JAX package
  has one width; the port's wide bucket is its batch at that width).  On
  FASTQ texts made here: equal, nearly equal and ragged lengths (0 to
  ``max_len + 5``), reads past ``LONG_READ_LEN`` in narrow and in wide
  batches, lowercase, ``N`` and IUPAC bases, CRLF, blank lines, comments
  with tabs, bytes outside ASCII, a last batch short of ``batch_size``, a
  ``.gz`` file; each with the stream read a byte, 7 bytes or a whole
  ``READ_SIZE`` at a time, so that records split at every offset of a
  read.
  ``fastq.fallback_batches`` counts 0 on clean text and more on the rest.
* Malformed text raises the same ``ValueError`` after the same batches as
  the JAX package's reader.
* Two named pipes written in lockstep, as the benchmark's producer and
  ``bwa mem ref <(zcat r1) <(zcat r2)`` users do, read through
  ``align_pe_fastq`` within a few seconds.
"""
import gzip
import io
import os
import threading
import zlib
from contextlib import redirect_stderr

import numpy as np
import pytest

from tpubwa.io.fastq import stream_batches as reference_batches
from tpubwa_torch.config import LONG_READ_LEN
from tpubwa_torch.io import fastq
from tpubwa_torch.io.fastq import stream_batches
from tpubwa_torch.utils.timers import PhaseTimers

MAX_LEN = 40
BATCH = 16
IUPAC = "ACGTacgtNnRYKMSWBDHVryk"


def _records(rng, n, lens, bases="ACGT", comment=None):
    out = []
    for i in range(n):
        L = int(lens[i])
        seq = "".join(rng.choice(list(bases), L)) if L else ""
        qual = "".join(chr(c) for c in rng.integers(33, 75, L))
        head = f"@r{i}" + (comment(i) if comment else "")
        out.append((head, seq, "+", qual))
    return out


def _text(records, eol="\n", sep=""):
    return sep.join(eol.join(r) + eol for r in records)


def _case(name):
    """(text bytes, clean: the block parser takes every batch)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = 3 * BATCH + 5                     # a last batch short of BATCH
    equal = np.full(n, 30)
    if name == "equal":
        return _text(_records(rng, n, equal)).encode(), True
    if name == "nearly_equal":            # two runs of one length a batch
        lens = equal.copy()
        lens[[15, 26, 27, 28, 29, 30, 31]] = 29
        return _text(_records(rng, n, lens)).encode(), True
    if name == "ragged":                  # 0 .. MAX_LEN + 5, some wide
        lens = rng.integers(0, MAX_LEN + 6, n)
        lens[:3] = [0, MAX_LEN, MAX_LEN + 1]
        lens[BATCH:2 * BATCH] = np.minimum(lens[BATCH:2 * BATCH], MAX_LEN)
        return _text(_records(rng, n, lens)).encode(), True
    if name == "all_too_long":            # every read in the wide bucket
        lens = np.full(n, MAX_LEN + 5)
        return _text(_records(rng, n, lens)).encode(), True
    if name == "past_long":               # reads the port cannot take
        lens = rng.integers(0, MAX_LEN + 1, n)
        lens[[3, 9]] = [LONG_READ_LEN + 1, LONG_READ_LEN + 40]   # narrow
        lens[[BATCH + 2, BATCH + 5]] = [LONG_READ_LEN, LONG_READ_LEN + 1]
        lens[2 * BATCH + 7] = MAX_LEN + 1                        # wide
        return _text(_records(rng, n, lens)).encode(), True
    if name == "bases":                   # lowercase, N, IUPAC
        lens = rng.integers(1, MAX_LEN + 1, n)
        return _text(_records(rng, n, lens, IUPAC)).encode(), True
    if name == "crlf":
        lens = rng.integers(0, MAX_LEN + 3, n)
        return _text(_records(rng, n, lens), eol="\r\n").encode(), True
    if name == "edge_space":              # a tab or space around lines
        recs = _records(rng, n, equal)
        recs = [(h + " ", " " + s + "\t", p, q + " ") if i % 5 == 0
                else (h, s, p, q) for i, (h, s, p, q) in enumerate(recs)]
        return _text(recs).encode(), True
    if name == "comments":                # comments with tabs and spaces
        recs = _records(rng, n, rng.integers(20, 31, n),
                        comment=lambda i: f" 1:N:0:{i}\tBC:Z:AC GT" * (i % 2))
        return _text(recs).encode(), True
    if name == "no_final_newline":
        return _text(_records(rng, n, equal)).encode()[:-1], True
    if name == "blank_lines":             # blank lines between records
        return _text(_records(rng, n, equal), sep="\n").encode(), False
    if name == "blank_ragged":            # the line parser's buckets
        lens = rng.integers(0, MAX_LEN + 6, n)
        lens[BATCH:2 * BATCH] = np.minimum(lens[BATCH:2 * BATCH], MAX_LEN)
        lens[[5, BATCH + 3]] = LONG_READ_LEN + 1
        return _text(_records(rng, n, lens), sep="\n").encode(), False
    if name == "trailing_blank":
        return _text(_records(rng, n, equal)).encode() + b"\n \n", False
    if name == "non_ascii":               # UTF-8 in a name and a comment
        recs = _records(rng, n, equal, comment=lambda i: " é" * (i == 7))
        recs[BATCH + 2] = ("@rë",) + recs[BATCH + 2][1:]
        return _text(recs).encode(), False
    if name == "str_only_space":          # \x1c: white space to str only
        recs = _records(rng, n, equal)
        recs[4] = ("@a\x1cb",) + recs[4][1:]
        return _text(recs).encode(), False
    if name == "lead_space":              # " @name": the line parser strips
        recs = _records(rng, n, equal)
        recs[9] = (" " + recs[9][0],) + recs[9][1:]
        return _text(recs).encode(), False
    if name == "empty":
        return b"", True
    raise KeyError(name)


CASES = ["equal", "nearly_equal", "ragged", "all_too_long", "past_long",
         "bases", "crlf", "edge_space", "comments", "no_final_newline",
         "blank_lines", "blank_ragged", "trailing_blank", "non_ascii",
         "str_only_space", "lead_space", "empty"]


def _write(tmp_path, data, gz):
    path = tmp_path / ("r.fq.gz" if gz else "r.fq")
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)
    return str(path)


def _run(gen):
    err = io.StringIO()
    with redirect_stderr(err):
        batches = list(gen)
    return batches, err.getvalue()


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.codes.dtype == w.codes.dtype == np.uint8
        assert g.codes.shape == w.codes.shape
        assert w.codes.shape in ((BATCH, MAX_LEN), (BATCH, LONG_READ_LEN))
        np.testing.assert_array_equal(g.codes, w.codes)
        assert g.lens.dtype == w.lens.dtype == np.int32
        np.testing.assert_array_equal(g.lens, w.lens)
        assert g.names == w.names
        assert g.seqs == w.seqs
        assert g.quals == w.quals


def _bucketed_reference(path):
    """The JAX package's batches of `path`, each at its bucket: the batch
    read at ``LONG_READ_LEN`` where a read of it is longer than
    ``MAX_LEN`` and no longer than ``LONG_READ_LEN``, else at ``MAX_LEN``;
    and the warnings of the read at ``LONG_READ_LEN``, the longest read the
    port takes."""
    narrow, _ = _run(reference_batches(path, BATCH, MAX_LEN))
    wide, wide_err = _run(reference_batches(path, BATCH, LONG_READ_LEN))
    assert len(narrow) == len(wide)
    return [w if (w.lens > MAX_LEN).any() else b
            for b, w in zip(narrow, wide)], wide_err


@pytest.mark.parametrize("read_size", [1, 7, fastq.READ_SIZE],
                         ids=["1B", "7B", "full"])
@pytest.mark.parametrize("case,gz", [(c, False) for c in CASES]
                         + [("crlf", True), ("ragged", True),
                            ("blank_lines", True)])
def test_block_parser_equals_line_parser(tmp_path, monkeypatch, case, gz,
                                         read_size):
    data, clean = _case(case)
    path = _write(tmp_path, data, gz)
    monkeypatch.setattr(fastq, "READ_SIZE", read_size)
    timers = PhaseTimers()
    got, got_err = _run(stream_batches(path, BATCH, MAX_LEN, timers=timers))
    want, want_err = _bucketed_reference(path)
    _same(got, want)
    assert got_err == want_err
    fell_back = timers.counters["fastq.fallback_batches"]
    assert (fell_back == 0) if clean else (fell_back > 0)
    if case != "empty":
        assert len(got) == 4 and got[-1].n == 5


@pytest.mark.parametrize("case", ["missing_plus_line", "blank_plus",
                                  "truncated", "bad_lead"])
def test_malformed_raises_as_line_parser(tmp_path, case):
    rng = np.random.default_rng(3)
    recs = _records(rng, 3 * BATCH, np.full(3 * BATCH, 25))
    if case in ("missing_plus_line", "blank_plus"):
        recs[BATCH + 4] = recs[BATCH + 4][:2] + ("",) + recs[BATCH + 4][3:]
        data = _text(recs)
        if case == "missing_plus_line":
            data = data.replace("\n\n", "\n")
    elif case == "truncated":             # the file ends after a sequence
        data = _text(recs) + "@last\nACGT\n"
    else:                                 # a header without its @
        recs[2 * BATCH + 1] = ("r",) + recs[2 * BATCH + 1][1:]
        data = _text(recs)
    path = _write(tmp_path, data.encode(), False)
    outs = []
    for gen in (stream_batches(path, BATCH, MAX_LEN),
                reference_batches(path, BATCH, MAX_LEN)):
        done = []
        with pytest.raises(ValueError, match="malformed FASTQ") as e:
            for b in gen:
                done.append(b)
        outs.append((done, str(e.value)))
    _same(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


class _FakeAligner:
    """What ``run_se_pipeline`` and ``align_pe_fastq`` need of an Aligner:
    options, timers and a seeding dispatch (a token here)."""

    def __init__(self, batch_size, max_len):
        from tpubwa_torch.config import MemOptions

        self.opt = MemOptions(batch_reads=batch_size, max_read_len=max_len)
        self.timers = PhaseTimers()

    def seed_batch_dispatch(self, codes, lens):
        return ()


def test_lockstep_pipes_through_align_pe_fastq(tmp_path, monkeypatch):
    """Batch k of read 1 is written whole before batch k of read 2, each
    larger than a pipe's buffer: a reader that asked pipe 1 for bytes of
    batch k + 1 before reading batch k of pipe 2 would wait forever."""
    from tpubwa_torch.align import pair

    n_batches, batch_size, L = 3, 512, 150
    rng = np.random.default_rng(11)
    ends = []
    for e in range(2):
        recs = _records(rng, n_batches * batch_size,
                        np.full(n_batches * batch_size, L))
        recs = [(f"@p{i}/{e + 1}",) + r[1:] for i, r in enumerate(recs)]
        ends.append([_text(recs[k * batch_size:(k + 1) * batch_size]).encode()
                     for k in range(n_batches)])
    ends[1][1] = ends[1][1].replace(b"\n@p700/", b"\n\n@p700/")
    assert len(ends[0][0]) > 2 * 65536
    fifos = [str(tmp_path / f"r{e + 1}.fq") for e in range(2)]
    for p in fifos:
        os.mkfifo(p)

    def writer():
        outs = [None, None]
        for k in range(n_batches):
            for e in range(2):
                if outs[e] is None:
                    outs[e] = open(fifos[e], "wb")
                outs[e].write(ends[e][k])
                outs[e].flush()
        for f in outs:
            f.close()

    def align_pe_batch(aligner, b1, b2, pair_id0, handles=None):
        return "".join(f"{x}\t{y}\t{s}\n"
                       for x, y, s in zip(b1.names, b2.names, b1.seqs))

    monkeypatch.setattr(pair, "align_pe_batch", align_pe_batch)
    al = _FakeAligner(batch_size, 160)
    out, rc = io.StringIO(), []
    wt = threading.Thread(target=writer, daemon=True)
    rt = threading.Thread(target=lambda: rc.append(
        pair.align_pe_fastq(al, fifos[0], fifos[1], out)), daemon=True)
    with redirect_stderr(io.StringIO()):
        wt.start()
        rt.start()
        rt.join(timeout=20)
        wt.join(timeout=5)
    assert not rt.is_alive() and not wt.is_alive(), "the pipes deadlocked"
    assert rc == [0]
    rows = out.getvalue().splitlines()
    assert len(rows) == n_batches * batch_size
    assert rows[5].split("\t")[:2] == ["p5/1", "p5/2"]
    assert al.timers.counters["fastq.fallback_batches"] == 1  # the blank
    assert al.timers.counts["FASTQ"] == n_batches + 1


def test_run_se_pipeline_counts_fallback_batches(tmp_path):
    """``run_se_pipeline`` hands its Aligner's timers to the reader: a
    clean file counts no fallback, one with blank lines one a batch."""
    from tpubwa_torch.align.pipeline import run_se_pipeline

    class SEAligner(_FakeAligner):
        def align_se_text(self, batch, read_id0, seed_handle=None):
            return "".join(f"{x}\t{s}\n" for x, s in zip(batch.names,
                                                          batch.seqs))

    for case, fell_back in (("equal", 0), ("blank_lines", 4)):
        path = _write(tmp_path, _case(case)[0], False)
        al, out = SEAligner(BATCH, MAX_LEN), io.StringIO()
        with redirect_stderr(io.StringIO()):
            assert run_se_pipeline(al, path, out) == 3 * BATCH + 5
        assert al.timers.counters["fastq.fallback_batches"] == fell_back
        assert out.getvalue().splitlines()[BATCH].startswith("r16\t")
