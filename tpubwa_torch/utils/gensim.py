"""Realistic synthetic genome generator (the port's copy of
``tpubwa.utils.gensim``; ``repeat_genome`` is ``utils.simgenome``'s, the
same function).

Uniform-random references skip whole pipeline phases (the reference
project's recorded trap, [ref] SVE_OPTIMIZATION_FINDINGS.md:63-84): no
max_occ saturation, no re-seeding, no MAPQ-vs-sub pressure.  Real genomes
add composition that even the repeat fixture lacks — homopolymer runs,
microsatellites, N-islands (assembly gaps), regional GC skew.  This module
generates all of those deterministically so the golden gates can run on a
"real-sequence-like" fixture without any downloads (VERDICT r4 missing #5).

Structure of ``realistic_genome(rng, n)``:
- backbone: 8 segmental duplications of one base segment at ~2% divergence
  (large dups -> multi-hit seeds, sub-score pressure on MAPQ)
- Alu-like family: ~300 bp element at ~10% divergence inserted every ~3 kb
  (~n/3000 copies -> max_occ saturation, l_rep coverage)
- microsatellites: (AC)n / (CAG)n style 1-6 bp motif expansions, 30-120
  units, every ~50 kb (slippage-style repeats -> chain ambiguity)
- homopolymer runs: 15-60 bp single-base runs every ~20 kb
- GC skew: a slow sinusoidal remap bias so composition drifts regionally
- N-islands: assembly-gap runs (returned as a mask; the FASTA writer emits
  'N' there, exercising the hole/amb machinery end to end)
"""
from __future__ import annotations

import numpy as np

from tpubwa_torch.utils.simgenome import repeat_genome

__all__ = ["repeat_genome", "realistic_genome", "write_fasta"]


def realistic_genome(rng: np.random.Generator, ref_len: int,
                     with_n_islands: bool = True
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Returns (codes uint8 [ref_len] in 0..3, n_mask bool [ref_len]).

    codes at n_mask positions are placeholder A's; the FASTA writer should
    emit 'N' there (read_fasta then re-substitutes deterministically,
    exercising the amb/hole path the same way a real assembly gap does)."""
    codes = repeat_genome(rng, ref_len)
    # repeat_genome makes 8 segments of ref_len // 8 bases: pad the
    # remainder (ref_len % 8 bases) with A's, which draws nothing from rng
    codes = np.concatenate(
        [codes, np.zeros(ref_len - codes.size, dtype=np.uint8)])

    # GC skew: flip A<->G in slow sinusoidal windows so GC% drifts
    # regionally (isochore-like).  Cheap vectorized remap.
    win = 1 << 16
    n_win = ref_len // win + 1
    phase = np.sin(np.linspace(0, 40 * np.pi, n_win))
    for w in np.nonzero(phase > 0.6)[0]:
        lo, hi = w * win, min((w + 1) * win, ref_len)
        seg = codes[lo:hi]
        a_pos = np.nonzero(seg == 0)[0]
        flip = a_pos[rng.random(a_pos.size) < 0.3]
        seg[flip] = 2  # A -> G

    # microsatellites every ~50 kb
    motifs = [np.array(m, np.uint8) for m in
              ([0, 1], [1, 0, 2], [0, 3], [1, 0, 2, 3], [0], [2, 1])]
    for p in range(25_000, ref_len - 1000, 50_000):
        motif = motifs[int(rng.integers(len(motifs)))]
        units = int(rng.integers(30, 120))
        run = np.tile(motif, units)[: min(len(motif) * units,
                                          ref_len - p - 1)]
        codes[p : p + run.size] = run

    # homopolymer runs every ~20 kb
    for p in range(10_000, ref_len - 100, 20_000):
        ln = int(rng.integers(15, 60))
        codes[p : p + ln] = rng.integers(0, 4)

    n_mask = np.zeros(ref_len, dtype=bool)
    if with_n_islands:
        # a few large assembly-gap islands + scattered short N runs
        for p in np.linspace(ref_len * 0.1, ref_len * 0.9, 5).astype(np.int64):
            ln = int(rng.integers(5_000, 20_000))
            n_mask[p : p + ln] = True
        for p in rng.integers(0, ref_len - 100, 40):
            n_mask[p : p + int(rng.integers(5, 60))] = True
        codes[n_mask] = 0
    return codes, n_mask


def write_fasta(path: str, codes: np.ndarray, n_mask: np.ndarray | None,
                name: str = "synth", width: int = 80) -> None:
    """Stream codes (with N at n_mask) to a FASTA without building the full
    string in memory (a 1.2 Gbp genome as one Python str is ~5 GB of
    transient peak otherwise)."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        chunk = 10_000_000 - (10_000_000 % width)
        for lo in range(0, codes.size, chunk):
            hi = min(lo + chunk, codes.size)
            row = lut[codes[lo:hi]].copy()
            if n_mask is not None:
                row[n_mask[lo:hi]] = ord("N")
            tail = row.size % width
            full, rest = (row[: row.size - tail], row[row.size - tail:])
            if full.size:
                mat = full.reshape(-1, width)
                f.write(np.concatenate(
                    [mat, np.full((mat.shape[0], 1), ord("\n"), np.uint8)],
                    axis=1).tobytes())
            if rest.size:  # only possible on the final chunk
                f.write(rest.tobytes() + b"\n")
