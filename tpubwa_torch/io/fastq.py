"""FASTQ reading + fixed-shape device batching (host side).

Reference analog: fastmap.cpp stage 1 of the kt_pipeline (read a chunk of
FASTQ into memory; SURVEY.md §3.1).  On TPU the chunk becomes a fixed-shape
(B, L) uint8 code tensor + length vector so everything downstream is
static-shaped for XLA.
"""
from __future__ import annotations

import dataclasses
import gzip
import io
import itertools
import sys
from typing import Iterator

import numpy as np

from tpubwa_torch.config import LONG_READ_LEN, batch_width
from tpubwa_torch.utils.dna import NT4_TABLE, encode
from tpubwa_torch.utils.timers import count

READ_SIZE = 1 << 20          # the most bytes one read1 call asks for
_NT4 = NT4_TABLE.tobytes()   # the table as a bytes.translate map
# bytes that str's split() and strip() take for white space and bytes'
# do not: a block that holds one goes to the line parser
_STR_ONLY_SPACE = (b"\x1c", b"\x1d", b"\x1e", b"\x1f")
_SPACE = np.zeros(256, dtype=bool)   # what bytes.strip() strips
_SPACE[list(b" \t\n\r\x0b\x0c")] = True


@dataclasses.dataclass
class Read:
    name: str
    seq: str
    qual: str
    comment: str = ""


@dataclasses.dataclass
class ReadBatch:
    """Fixed-shape batch of reads ready for device transfer.

    codes: (B, L) uint8, 0..3 bases, 4 = ambiguous, padded with 4 past length
    lens:  (B,) int32 actual read lengths (0 for padding rows)
    names/seqs/quals: host-side metadata for SAM emission

    L is the batch's width bucket (``config.batch_width``): the aligner
    runs the batch at ``config.batch_widths`` of L (``config.Widths``).
    """

    codes: np.ndarray
    lens: np.ndarray
    names: list[str]
    seqs: list[str]
    quals: list[str]

    @property
    def n(self) -> int:
        return len(self.names)

    def padded_to(self, width: int) -> "ReadBatch":
        """The batch with its rows padded to `width` (itself when that
        is its width)."""
        if width == self.codes.shape[1]:
            return self
        codes = np.full((self.codes.shape[0], width), 4, dtype=np.uint8)
        codes[:, :self.codes.shape[1]] = self.codes
        return dataclasses.replace(self, codes=codes)


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fastq(path: str) -> Iterator[Read]:
    with _open(path) as f:
        yield from _records(f)


def _records(f) -> Iterator[Read]:
    """Records off anything with ``readline()``, a line at a time."""
    while True:
        h = f.readline()
        if not h:
            return
        h = h.strip()
        if not h:
            continue
        seq = f.readline().strip()
        plus = f.readline()
        qual = f.readline().strip()
        if not h.startswith(b"@") or not plus.startswith(b"+"):
            raise ValueError(f"malformed FASTQ near {h[:50]!r}")
        parts = h[1:].split(None, 1)
        name = parts[0].decode()
        comment = parts[1].decode() if len(parts) > 1 else ""
        yield Read(name=name, seq=seq.decode(), qual=qual.decode(),
                   comment=comment)


def batch_reads(reads: list[Read], batch_size: int, max_len: int,
                pad_to_batch: bool = True, on_too_long: str = "raise"
                ) -> Iterator[ReadBatch]:
    """Group reads into fixed-shape batches, each as wide as its bucket
    (``config.batch_width``): `max_len`, or ``LONG_READ_LEN`` where it
    holds a read longer than `max_len`.

    Reads longer than both don't fit a device shape.  on_too_long:
    "raise", or "skip" — keep the read in the batch with length 0 so it
    is reported as unmapped (with a stderr warning) instead of aborting
    the whole run.
    """
    limit = max(max_len, LONG_READ_LEN)
    for i in range(0, len(reads), batch_size):
        chunk = reads[i : i + batch_size]
        b = batch_size if pad_to_batch else len(chunk)
        width = batch_width(max_len, [len(r.seq) for r in chunk])
        codes = np.full((b, width), 4, dtype=np.uint8)
        lens = np.zeros(b, dtype=np.int32)
        for j, r in enumerate(chunk):
            if len(r.seq) > width:
                if on_too_long == "skip":
                    print(f"[tpu-bwa] warning: read {r.name} length "
                          f"{len(r.seq)} > max read length {limit}; "
                          "emitting it unmapped", file=sys.stderr)
                    continue
                raise ValueError(
                    f"read {r.name} length {len(r.seq)} > max_len {limit}")
            codes[j, : len(r.seq)] = encode(r.seq)
            lens[j] = len(r.seq)
        yield ReadBatch(
            codes=codes,
            lens=lens,
            names=[r.name for r in chunk],
            seqs=[r.seq for r in chunk],
            quals=[r.qual for r in chunk],
        )


def stream_batches(path: str, batch_size: int, max_len: int, timers=None
                   ) -> Iterator[ReadBatch]:
    """Stream fixed-shape batches straight off a FASTQ file without
    materializing the whole file (fastmap stage-1 behavior).

    Each batch is parsed from a block of bytes at once (``_parse_block``):
    the next ``4 * batch_size`` lines.  The bytes are taken with ``read1``,
    which returns what the stream holds instead of waiting for a count, and
    no more are asked for once the block is whole: ``align_pe_fastq`` reads
    two pipes in lockstep, and a writer that fills batch k of read 1 before
    batch k of read 2 would otherwise block against the reader.  Bytes past
    the block are kept for the next one.

    A block the block parser does not take (a blank or stray line, a lead
    other than ``@`` / ``+``, a byte outside ASCII, a truncated last
    record) is parsed by ``read_fastq``'s line parser and ``batch_reads``,
    which give the same batches and raise the same errors; each such batch
    counts one ``fastq.fallback_batches`` in `timers` (an Aligner's).
    A batch is `max_len` wide, or ``LONG_READ_LEN`` wide where it holds a
    read longer than `max_len` (``config.batch_width``).  Reads longer
    than both stay in the batch with length 0 and a warning
    (``batch_reads``' ``on_too_long="skip"``)."""
    with _open(path) as f:
        carry = b""
        while True:
            buf = _read_lines(f, carry, 4 * batch_size)
            if not buf:
                return
            batch, carry = _parse_block(buf, batch_size, max_len)
            if batch is not None:
                yield batch
                continue
            count(timers, "fastq.fallback_batches")
            lines = _Carry(buf, f)
            chunk = list(itertools.islice(_records(lines), batch_size))
            if not chunk:
                return
            carry = lines.rest()
            yield from batch_reads(chunk, batch_size, max_len,
                                   on_too_long="skip")


def _read_lines(f, carry: bytes, n: int) -> bytes:
    """`carry`, then the stream's bytes until they hold `n` lines or the
    stream ends."""
    parts, have = [carry], _newlines(carry)
    while have < n:
        chunk = f.read1(READ_SIZE)
        if not chunk:
            break
        parts.append(chunk)
        have += _newlines(chunk)
    return b"".join(parts)


def _newlines(b: bytes) -> int:
    # numpy counts a byte several times faster than bytes.count
    return int(np.count_nonzero(np.frombuffer(b, dtype=np.uint8) == 10))


def _parse_block(buf: bytes, batch_size: int, max_len: int
                 ) -> tuple[ReadBatch | None, bytes]:
    """The batch of the first ``4 * batch_size`` lines of `buf` (all of it
    at the stream's end) and the bytes after them, as wide as
    ``batch_reads`` makes it; (None, `buf`) where the block is not
    four-line records of ASCII whose leads are ``@`` and ``+``."""
    a = np.frombuffer(buf, dtype=np.uint8)
    ends = np.flatnonzero(a == 10)
    if len(ends) >= 4 * batch_size:
        ends = ends[:4 * batch_size]
        block, carry = buf[:ends[-1] + 1], buf[ends[-1] + 1:]
    else:  # the stream's last block
        block, carry = buf, b""
        if not buf.endswith(b"\n"):
            block += b"\n"
            ends = np.append(ends, len(buf))
    if len(ends) % 4 or any(c in block for c in _STR_ONLY_SPACE):
        return None, buf
    starts = np.concatenate(([0], ends[:-1] + 1))
    firsts = a[starts].reshape(-1, 4)
    if not ((firsts[:, 0] == ord("@")).all()
            and (firsts[:, 2] == ord("+")).all()):
        return None, buf
    try:
        lines = block.decode("ascii").split("\n")
    except UnicodeDecodeError:
        return None, buf
    del lines[-1]  # after the block's last newline
    heads, seqs, quals = lines[0::4], lines[1::4], lines[3::4]
    n = len(heads)
    lasts = a[ends - 1].reshape(-1, 4)
    edges = np.concatenate([firsts[:, 1], lasts[:, 1], firsts[:, 3],
                            lasts[:, 3]])
    if _SPACE[edges].any():
        # CRLF, or an empty line: strip each line as the line parser does
        seqs = [s.strip() for s in seqs]
        quals = [q.strip() for q in quals]
        lens = np.fromiter(map(len, seqs), dtype=np.int32, count=n)
    else:
        lens = (ends[1::4] - starts[1::4]).astype(np.int32)
    names = [h[1:].split(None, 1)[0] for h in heads]
    flat = np.frombuffer("".join(seqs).encode().translate(_NT4),
                         dtype=np.uint8)
    width = batch_width(max_len, lens)
    long = lens > width
    if long.any():
        for i in np.flatnonzero(long):
            print(f"[tpu-bwa] warning: read {names[i]} length {lens[i]} > "
                  f"max read length {max(max_len, LONG_READ_LEN)}; "
                  "emitting it unmapped", file=sys.stderr)
        flat = flat[np.repeat(~long, lens)]
        lens[long] = 0
    codes = np.full((batch_size, width), 4, dtype=np.uint8)
    _place(codes, flat, lens)
    out_lens = np.zeros(batch_size, dtype=np.int32)
    out_lens[:n] = lens
    return ReadBatch(codes=codes, lens=out_lens, names=names, seqs=seqs,
                     quals=quals), carry


def _place(codes: np.ndarray, flat: np.ndarray, lens: np.ndarray) -> None:
    """Row i of `codes` takes the next ``lens[i]`` codes of `flat`, a run
    of rows of one length at a time: one reshape of a slice of `flat` a
    run (one run where every read has the same length)."""
    bounds = [0, *(np.flatnonzero(np.diff(lens)) + 1).tolist(), len(lens)]
    offs = np.concatenate(([0], np.cumsum(lens))).tolist()
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        codes[r0:r1, :lens[r0]] = flat[offs[r0]:offs[r1]].reshape(
            r1 - r0, lens[r0])


class _Carry:
    """``readline()`` over bytes already taken off a stream, then over the
    stream: the line parser's input where a block falls back."""

    def __init__(self, head: bytes, f):
        self._head = io.BytesIO(head)
        self._f = f

    def readline(self) -> bytes:
        line = self._head.readline()
        if line.endswith(b"\n"):
            return line
        return line + self._f.readline()

    def rest(self) -> bytes:
        """The bytes taken that the line parser has not read."""
        return self._head.read()
