"""FASTQ reading + fixed-shape device batching (host side).

Reference analog: fastmap.cpp stage 1 of the kt_pipeline (read a chunk of
FASTQ into memory; SURVEY.md §3.1).  On TPU the chunk becomes a fixed-shape
(B, L) uint8 code tensor + length vector so everything downstream is
static-shaped for XLA.
"""
from __future__ import annotations

import dataclasses
import gzip
from typing import Iterator

import numpy as np

from tpubwa_torch.utils.dna import encode


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
    """

    codes: np.ndarray
    lens: np.ndarray
    names: list[str]
    seqs: list[str]
    quals: list[str]

    @property
    def n(self) -> int:
        return len(self.names)


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fastq(path: str) -> Iterator[Read]:
    with _open(path) as f:
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
    """Group reads into fixed-shape batches.

    Reads longer than max_len don't fit the static device shape (long-read
    support would use a different length bucket — SURVEY.md §5 "length
    bucketing + dtype escalation").  on_too_long: "raise", or "skip" — keep
    the read in the batch with length 0 so it is reported as unmapped
    (with a stderr warning) instead of aborting the whole run.
    """
    import sys as _sys

    for i in range(0, len(reads), batch_size):
        chunk = reads[i : i + batch_size]
        b = batch_size if pad_to_batch else len(chunk)
        codes = np.full((b, max_len), 4, dtype=np.uint8)
        lens = np.zeros(b, dtype=np.int32)
        for j, r in enumerate(chunk):
            if len(r.seq) > max_len:
                if on_too_long == "skip":
                    print(f"[tpu-bwa] warning: read {r.name} length "
                          f"{len(r.seq)} > max read length {max_len}; "
                          "emitting it unmapped", file=_sys.stderr)
                    continue
                raise ValueError(
                    f"read {r.name} length {len(r.seq)} > max_len {max_len}")
            codes[j, : len(r.seq)] = encode(r.seq)
            lens[j] = len(r.seq)
        yield ReadBatch(
            codes=codes,
            lens=lens,
            names=[r.name for r in chunk],
            seqs=[r.seq for r in chunk],
            quals=[r.qual for r in chunk],
        )


def stream_batches(path: str, batch_size: int, max_len: int
                   ) -> Iterator[ReadBatch]:
    """Stream fixed-shape batches straight off a FASTQ file without
    materializing the whole file (fastmap stage-1 behavior)."""
    import itertools

    it = read_fastq(path)
    while True:
        chunk = list(itertools.islice(it, batch_size))
        if not chunk:
            return
        yield from batch_reads(chunk, batch_size, max_len,
                               on_too_long="skip")
