"""Realistic-composition synthetic genome generator.

Every fixture in earlier rounds was uniform-random or pure
segmental-repeat; real genomes additionally have composition features
that exercise different pipeline behavior — N-islands (assembly gaps /
centromeres: FASTA holes, unmappable windows), microsatellites and
homopolymer runs (slippage-prone STRs: low-complexity seeds that
saturate ``max_occ``), GC-skewed isochores (non-uniform base
composition shifts occ-table balance), and interspersed mobile elements
at two scales (SINE/Alu-like ~300 bp high-copy, LINE-like ~2 kb
lower-copy).  The reference project validated against real E. coli /
chr22 / chrM with alignment-count invariants; this module is the
no-download
stand-in: the same invariant style over sequence that has real-genome
composition (tests/test_realistic_fixture.py).

Returns uint8 nt4 codes (0..3 = ACGT, 4 = N) ready for
``utils.dna.decode`` / ``FMIndex.build``.  ``repeat_genome`` is the
chr21-style segmental-repeat recipe of the repository's benchmark
(``bench.py::_repeat_genome``), kept here so that fixtures made with it
need nothing outside this package.
"""
from __future__ import annotations

import numpy as np

_STR_MOTIFS = ("A", "AC", "AT", "CAG", "GATA", "AAAG", "ACGTAC")


def _gc_block(rng, n: int, gc: float) -> np.ndarray:
    """n bases with the given GC fraction (C/G vs A/T equiprobable)."""
    is_gc = rng.random(n) < gc
    strong = rng.integers(0, 2, n)          # C or G
    weak = rng.integers(0, 2, n)            # A or T
    return np.where(is_gc, 1 + strong, 3 * weak).astype(np.uint8)


def realistic_genome(rng: np.random.Generator, length: int, *,
                     n_islands: bool = True) -> np.ndarray:
    """Composition-realistic synthetic genome of ``length`` codes."""
    # isochore backbone: ~25 kb blocks, GC ~ N(0.41, 0.07) clipped
    blocks = []
    done = 0
    while done < length:
        n = min(int(rng.integers(15_000, 35_000)), length - done)
        gc = float(np.clip(rng.normal(0.41, 0.07), 0.25, 0.62))
        blocks.append(_gc_block(rng, n, gc))
        done += n
    g = np.concatenate(blocks)[:length]

    # SINE (Alu-like): ~300 bp consensus, ~1 copy / 3 kb, ~10% divergence
    sine = rng.integers(0, 4, 300).astype(np.uint8)
    p = int(rng.integers(500, 3000))
    while p + 300 < length:
        a = sine.copy()
        mut = rng.random(300) < 0.10
        a[mut] = (a[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        g[p:p + 300] = a
        p += int(rng.integers(1500, 4500))

    # LINE-like: ~2 kb consensus, ~1 copy / 30 kb, ~15% divergence,
    # often 5'-truncated (like real L1 insertions)
    line = rng.integers(0, 4, 2000).astype(np.uint8)
    p = int(rng.integers(5_000, 30_000))
    while p + 2000 < length:
        a = line.copy()
        mut = rng.random(2000) < 0.15
        a[mut] = (a[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        cut = int(rng.integers(0, 1500))    # 5' truncation
        g[p:p + 2000 - cut] = a[cut:]
        p += int(rng.integers(15_000, 45_000))

    # microsatellites + homopolymers: ~1 STR / 5 kb, 10..60 motif copies
    p = int(rng.integers(200, 5000))
    while p < length - 400:
        motif = _STR_MOTIFS[int(rng.integers(0, len(_STR_MOTIFS)))]
        mcodes = np.array(["ACGT".index(c) for c in motif], np.uint8)
        reps = int(rng.integers(10, 60))
        run = np.tile(mcodes, reps)[: min(len(mcodes) * reps,
                                          length - p)]
        g[p:p + len(run)] = run
        p += len(run) + int(rng.integers(2000, 8000))

    # segmental duplication: one 8-15% of the genome block re-inserted
    # elsewhere at ~2% divergence (multi-region / XA pressure)
    seg_len = int(length * rng.uniform(0.08, 0.15))
    if seg_len > 1000:
        src = int(rng.integers(0, length - 2 * seg_len))
        dst = int(rng.integers(src + seg_len, length - seg_len))
        dup = g[src:src + seg_len].copy()
        mut = rng.random(seg_len) < 0.02
        dup[mut] = (dup[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        g[dst:dst + seg_len] = dup

    if n_islands:
        # centromere-like gap (~1.5% of length) + telomeric caps + a few
        # short assembly gaps — all N (code 4, FASTA holes)
        cen = max(int(length * 0.015), 100)
        c0 = int(length * rng.uniform(0.4, 0.6))
        g[c0:c0 + cen] = 4
        cap = max(length // 500, 20)
        g[:cap] = 4
        g[-cap:] = 4
        for _ in range(3):
            p = int(rng.integers(cap, length - cap - 200))
            g[p:p + int(rng.integers(30, 200))] = 4
    return g


def repeat_genome(rng: np.random.Generator, ref_len: int) -> np.ndarray:
    """chr21-style repeat-structured synthetic genome (the draw order of
    ``bench.py::_repeat_genome``, so one seed gives one genome in both):
    8 segmental copies of one base segment at ~2% divergence (large
    duplications -> multi-hit seeds), with a ~300 bp high-copy element
    (Alu-like, ~10% divergence) inserted every ~3 kb (-> max_occ
    saturation, re-seeding, long backward walks in the SMEM chains)."""
    n_seg = 8
    alu_len, alu_every = 300, 3000
    seg_len = ref_len // n_seg
    base = rng.integers(0, 4, seg_len).astype(np.uint8)
    alu = rng.integers(0, 4, alu_len).astype(np.uint8)
    segs = []
    for _ in range(n_seg):
        seg = base.copy()
        mut = rng.random(seg_len) < 0.02
        seg[mut] = (seg[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        for p in range(alu_every, seg_len - alu_len, alu_every):
            a = alu.copy()
            m = rng.random(alu_len) < 0.10
            a[m] = (a[m] + rng.integers(1, 4, int(m.sum()))) % 4
            seg[p:p + alu_len] = a
        segs.append(seg)
    return np.concatenate(segs)[:ref_len]
