"""Simulated reads, a batch at a time, from a seed.

The read model is the port's simulator's (``utils/sim.py``, wgsim-like):
each base of a fragment is substituted with probability ``err`` by one of
the other three; then, scanning the original bases left to right, each is
deleted with probability ``indel / 2`` or has a random base inserted before
it with probability ``indel / 2``; the result is cut to ``read_len``.  Pairs
take an insert of ``int(N(mean, std))`` (at least ``read_len + 10``), read 1
from the fragment's left end and read 2 the reverse complement of its right
end; with probability ``mate_swap`` the two are exchanged, as wgsim does.
A mix may also give ``r2_bad_share`` and ``r2_bad_err``: that share of
pairs has read 2 substituted at ``r2_bad_err`` on top of ``err`` (a read 2
whose quality collapsed, which seeds poorly and is placed by mate rescue);
a mix without them draws nothing for them.  Qualities are all ``I``.

The port's simulator draws its random numbers one base at a time (about
3,000 reads/s); this one draws whole arrays, so one process offers reads
faster than the card takes them.  The same model, other draws: the port's
``_mutate`` skips a deletion once it would leave fewer than half the
bases, which 75 deletions in one read would need.

A batch is a function of (seed, stream, batch number) alone, so the
reference can make any batch of a run again.
"""
from __future__ import annotations

import dataclasses

import numpy as np

LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class Batch:
    """Reads of one batch: ``codes`` [n_ends, n, read_len] as offered (read
    1, and read 2 for pairs; past ``lens`` undefined), the forward-strand
    start of the bases each read was cut from and its strand (1: the read
    is the reverse complement of the forward strand)."""

    names: list[str]
    codes: np.ndarray
    lens: np.ndarray
    pos: np.ndarray
    strand: np.ndarray

    def fastq(self, end: int) -> bytes:
        """FASTQ text of read 1 (`end` 0) or read 2 (`end` 1)."""
        chars = LUT[self.codes[end] & 3]
        out = []
        for name, row, n in zip(self.names, chars, self.lens[end].tolist()):
            out.append(b"@%s\n%s\n+\n%s\n" % (name.encode(), row[:n].tobytes(),
                                               b"I" * n))
        return b"".join(out)

    def forward(self, end: int) -> np.ndarray:
        """Reads of `end` on the forward strand, [n, read_len] (4 past the
        length)."""
        return orient(self.codes[end], self.lens[end], self.strand[end])


def rng_for(seed: int, stream: int, batch: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2 ** 64 - 1), stream, batch])


def mutate(rng: np.random.Generator, frag: np.ndarray, err: float,
           indel: float) -> tuple[np.ndarray, np.ndarray]:
    """The read model on fragments [n, L]: (reads [n, L], lengths)."""
    n, L = frag.shape
    seq = frag.astype(np.uint8, copy=True)
    sub = rng.random((n, L), dtype=np.float32) < err
    seq[sub] = (seq[sub] + rng.integers(1, 4, int(sub.sum()),
                                        dtype=np.uint8)) % 4
    r = rng.random((n, L), dtype=np.float32)
    lens = np.full(n, L, dtype=np.int32)
    rows = np.flatnonzero((r < indel).any(axis=1))
    if rows.size == 0:
        return seq, lens
    m = rows.size
    rr = r[rows]
    dele = rr < indel / 2
    ins = (rr >= indel / 2) & (rr < indel)
    ins_base = np.zeros((m, L), dtype=np.uint8)
    ins_base[ins] = rng.integers(0, 4, int(ins.sum()), dtype=np.uint8)
    # each original base is two slots: the base inserted before it (if
    # any), then the base itself (unless deleted)
    present = np.stack([ins, ~dele], axis=2).reshape(m, 2 * L)
    vals = np.stack([ins_base, seq[rows]], axis=2).reshape(m, 2 * L)
    at = np.cumsum(present, axis=1) - 1
    keep = present & (at < L)
    out = np.full((m, L), 4, dtype=np.uint8)
    r_idx = np.broadcast_to(np.arange(m)[:, None], (m, 2 * L))
    out[r_idx[keep], at[keep]] = vals[keep]
    seq[rows] = out
    lens[rows] = np.minimum(present.sum(axis=1), L)
    return seq, lens


def orient(codes: np.ndarray, lens: np.ndarray, strand: np.ndarray
           ) -> np.ndarray:
    """Reverse-complement the rows with ``strand`` 1 within their length;
    4 past the length."""
    n, L = codes.shape
    j = np.arange(L)[None, :]
    valid = j < lens[:, None]
    src = np.where(strand[:, None] == 1, lens[:, None] - 1 - j, j)
    src = np.clip(src, 0, L - 1)
    base = np.take_along_axis(codes, src, axis=1)
    base = np.where(strand[:, None] == 1, 3 - base, base)
    return np.where(valid, base, 4).astype(np.uint8)


def make_batch(text: np.ndarray, traffic: dict, seed: int, stream: int,
               batch: int) -> Batch:
    """Batch `batch` of stream `stream` under `seed`, cut from the index
    text `text` (a single contig)."""
    rng = rng_for(seed, stream, batch)
    n, L = int(traffic["batch_reads"]), int(traffic["read_len"])
    err, indel = float(traffic["err"]), float(traffic["indel"])
    l_tot = text.size
    cols = np.arange(L)[None, :]
    names = [f"s{stream}b{batch}r{i}" for i in range(n)]
    if traffic["ends"] == 1:
        pos = rng.integers(0, l_tot - L, n)
        strand = rng.integers(0, 2, n).astype(np.int8)
        fwd, lens = mutate(rng, text[pos[:, None] + cols], err, indel)
        codes = orient(fwd, lens, strand)
        return Batch(names, codes[None], lens[None], pos[None],
                     strand[None])
    isize = np.maximum(rng.normal(traffic["isize_mean"], traffic["isize_std"],
                                  n).astype(np.int64), L + 10)
    pos = rng.integers(0, np.maximum(l_tot - isize, 1))
    left, llen = mutate(rng, text[pos[:, None] + cols], err, indel)
    rpos = pos + isize - L
    right, rlen = mutate(rng, text[rpos[:, None] + cols], err, indel)
    swap = rng.random(n) < float(traffic["mate_swap"])
    fpos = np.stack([np.where(swap, rpos, pos), np.where(swap, pos, rpos)])
    strand = np.stack([swap, ~swap]).astype(np.int8)
    fwd = np.stack([np.where(swap[:, None], right, left),
                    np.where(swap[:, None], left, right)])
    lens = np.stack([np.where(swap, rlen, llen), np.where(swap, llen, rlen)])
    if float(traffic.get("r2_bad_share", 0)) > 0:
        bad = rng.random(n) < float(traffic["r2_bad_share"])
        sub = ((rng.random((n, L), dtype=np.float32)
                < float(traffic["r2_bad_err"])) & bad[:, None]
               & (cols < lens[1][:, None]) & (fwd[1] < 4))
        fwd[1][sub] = (fwd[1][sub] + rng.integers(1, 4, int(sub.sum()),
                                                  dtype=np.uint8)) % 4
    codes = np.stack([orient(fwd[e], lens[e], strand[e]) for e in (0, 1)])
    return Batch(names, codes, lens, fpos, strand)
