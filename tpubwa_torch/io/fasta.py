"""FASTA reading (host side).

Reference analog: the index-build side of bwa-mem2 reads FASTA into the 2-bit
``pac`` (SURVEY.md §3.2).  Ambiguous bases (N etc.) are recorded as "holes"
(the reference's ``.amb`` file concept) and replaced with a deterministic
pseudo-random A/C/G/T so the packed reference is strictly 2-bit.
"""
from __future__ import annotations

import dataclasses
import gzip
import io

import numpy as np

from tpubwa_torch.utils.dna import encode


@dataclasses.dataclass
class Contig:
    name: str
    length: int
    offset: int  # cumulative offset in the concatenated forward reference


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path: str) -> tuple[list[Contig], np.ndarray, np.ndarray]:
    """Parse FASTA.

    Returns (contigs, codes, holes) where ``codes`` is the concatenated
    forward reference as uint8 0..3 (ambiguous bases substituted), and
    ``holes`` is a (n_holes, 2) int64 array of [start, end) ambiguous runs in
    concatenated coordinates.
    """
    contigs: list[Contig] = []
    chunks: list[bytes] = []
    name = None
    cur: list[bytes] = []
    offset = 0

    def flush():
        nonlocal offset
        if name is None:
            return
        seq = b"".join(cur)
        contigs.append(Contig(name=name, length=len(seq), offset=offset))
        chunks.append(seq)
        offset += len(seq)

    with _open(path) as f:
        for raw in io.BufferedReader(f):
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b">"):
                flush()
                name = line[1:].split()[0].decode()
                cur = []
            else:
                cur.append(line)
        flush()

    codes = encode(b"".join(chunks))
    amb = codes >= 4
    holes = _runs(amb)
    if amb.any():
        # Deterministic substitution: bwa uses lrand48 seeded with 11; we use
        # a fixed-seed PCG so index builds are reproducible.
        rng = np.random.default_rng(11)
        codes = codes.copy()
        codes[amb] = rng.integers(0, 4, size=int(amb.sum()), dtype=np.uint8)
    return contigs, codes.astype(np.uint8), holes


def _runs(mask: np.ndarray) -> np.ndarray:
    """[start, end) runs of True in a boolean array."""
    if not mask.any():
        return np.zeros((0, 2), dtype=np.int64)
    m = mask.astype(np.int8)
    d = np.diff(m, prepend=0, append=0)
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    return np.stack([starts, ends], axis=1).astype(np.int64)
