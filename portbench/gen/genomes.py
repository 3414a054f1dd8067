"""Reference genomes of the benchmark's configurations, made from the seed in
each configuration's file.  A frozen copy of the port's generators
(``utils/simgenome.py::repeat_genome``, ``utils/gensim.py::realistic_genome``
and ``write_fasta``, ``tools/bench.py``'s uniform genome): the same seed gives
the same genome, byte for byte (``tests/test_portbench_gen.py``).

``index_text`` is the text an index of the written FASTA holds: the FASTA
writes N over the mask, and a reader substitutes each N by a pseudo-random
base (bwa's ``.amb`` holes; ``io/fasta.py``: a PCG seeded with 11, drawn in
order over the N positions).  Reads are cut from that text.
"""
from __future__ import annotations

import numpy as np

AMB_SEED = 11


def repeat_genome(rng: np.random.Generator, ref_len: int) -> np.ndarray:
    """chr21-style repeat-structured genome: 8 segmental copies of one base
    segment at ~2% divergence, with a ~300 bp high-copy element (Alu-like,
    ~10% divergence) every ~3 kb."""
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


def realistic_genome(rng: np.random.Generator, ref_len: int,
                     with_n_islands: bool = True
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(codes uint8 in 0..3, N mask): ``repeat_genome`` padded to `ref_len`
    with A's, GC skew, microsatellites every ~50 kb, homopolymer runs every
    ~20 kb, and assembly-gap N islands (placeholder A's under the mask)."""
    codes = repeat_genome(rng, ref_len)
    codes = np.concatenate(
        [codes, np.zeros(ref_len - codes.size, dtype=np.uint8)])

    win = 1 << 16
    n_win = ref_len // win + 1
    phase = np.sin(np.linspace(0, 40 * np.pi, n_win))
    for w in np.nonzero(phase > 0.6)[0]:
        lo, hi = w * win, min((w + 1) * win, ref_len)
        seg = codes[lo:hi]
        a_pos = np.nonzero(seg == 0)[0]
        flip = a_pos[rng.random(a_pos.size) < 0.3]
        seg[flip] = 2

    motifs = [np.array(m, np.uint8) for m in
              ([0, 1], [1, 0, 2], [0, 3], [1, 0, 2, 3], [0], [2, 1])]
    for p in range(25_000, ref_len - 1000, 50_000):
        motif = motifs[int(rng.integers(len(motifs)))]
        units = int(rng.integers(30, 120))
        run = np.tile(motif, units)[: min(len(motif) * units,
                                          ref_len - p - 1)]
        codes[p : p + run.size] = run

    for p in range(10_000, ref_len - 100, 20_000):
        ln = int(rng.integers(15, 60))
        codes[p : p + ln] = rng.integers(0, 4)

    n_mask = np.zeros(ref_len, dtype=bool)
    if with_n_islands:
        for p in np.linspace(ref_len * 0.1, ref_len * 0.9, 5).astype(np.int64):
            ln = int(rng.integers(5_000, 20_000))
            n_mask[p : p + ln] = True
        for p in rng.integers(0, ref_len - 100, 40):
            n_mask[p : p + int(rng.integers(5, 60))] = True
        codes[n_mask] = 0
    return codes, n_mask


def uniform_genome(rng: np.random.Generator, ref_len: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Uniform random bases, no N."""
    return (rng.integers(0, 4, ref_len).astype(np.uint8),
            np.zeros(ref_len, dtype=bool))


MODELS = {"realistic": realistic_genome, "uniform": uniform_genome}


def make_genome(spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """(codes, N mask) of a configuration's ``genome`` entry."""
    if spec["model"] not in MODELS:
        raise ValueError(f"genome model {spec['model']!r}: choose from "
                         f"{sorted(MODELS)}")
    return MODELS[spec["model"]](np.random.default_rng(spec["seed"]),
                                 int(spec["length"]))


def index_text(codes: np.ndarray, n_mask: np.ndarray) -> np.ndarray:
    """The bases an index of the FASTA holds: each N replaced in order by a
    draw of a PCG seeded with ``AMB_SEED``."""
    text = codes.astype(np.uint8, copy=True)
    n = int(n_mask.sum())
    if n:
        text[n_mask] = np.random.default_rng(AMB_SEED).integers(
            0, 4, size=n, dtype=np.uint8)
    return text


def write_fasta(path: str, codes: np.ndarray, n_mask: np.ndarray,
                name: str, width: int = 80) -> None:
    """One contig, N at the mask, `width` bases a line, written a chunk at a
    time."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        chunk = 10_000_000 - (10_000_000 % width)
        for lo in range(0, codes.size, chunk):
            hi = min(lo + chunk, codes.size)
            row = lut[codes[lo:hi]].copy()
            row[n_mask[lo:hi]] = ord("N")
            tail = row.size % width
            full, rest = row[: row.size - tail], row[row.size - tail:]
            if full.size:
                mat = full.reshape(-1, width)
                f.write(np.concatenate(
                    [mat, np.full((mat.shape[0], 1), ord("\n"), np.uint8)],
                    axis=1).tobytes())
            if rest.size:
                f.write(rest.tobytes() + b"\n")
