"""wgsim-like read simulator (host) — test fixtures + benchmarks.

The reference learned the hard way that only error-injected reads exercise
the DP kernel (SURVEY.md §4.5 "test-data design pitfall"); this simulator
injects substitutions and indels and encodes ground truth in read names:

  sim_<serial>_<rid>_<pos0>_<strand>[_<mate>]   (pos0 = 0-based leftmost
  forward coordinate of the originating fragment/segment)
"""
from __future__ import annotations

import argparse

import numpy as np

from tpubwa_torch.io.fasta import read_fasta
from tpubwa_torch.utils.dna import decode, revcomp_codes


def simulate_reads(codes: np.ndarray, contigs, n: int, length: int = 150,
                   err: float = 0.01, indel: float = 0.0005,
                   seed: int = 7) -> list[tuple[str, str, str]]:
    """Single-end reads: returns [(name, seq, qual)]."""
    rng = np.random.default_rng(seed)
    out = []
    l_tot = codes.size
    offs = np.array([c.offset for c in contigs])
    for i in range(n):
        pos = int(rng.integers(0, l_tot - length))
        frag = codes[pos : pos + length].copy()
        strand = int(rng.integers(0, 2))
        rid = int(np.searchsorted(offs, pos, side="right") - 1)
        seq = _mutate(rng, frag, err, indel, length)
        if strand:
            seq = revcomp_codes(seq)
        name = f"sim_{i}_{rid}_{pos}_{strand}"
        out.append((name, decode(seq), "I" * len(seq)))
    return out


def simulate_pairs(codes: np.ndarray, contigs, n: int, length: int = 150,
                   isize_mean: int = 400, isize_std: int = 50,
                   err: float = 0.01, indel: float = 0.0005,
                   seed: int = 7):
    """Paired-end (FR orientation): returns ([(name,seq,qual)] r1, r2)."""
    rng = np.random.default_rng(seed)
    r1, r2 = [], []
    l_tot = codes.size
    offs = np.array([c.offset for c in contigs])
    for i in range(n):
        isize = max(int(rng.normal(isize_mean, isize_std)), length + 10)
        pos = int(rng.integers(0, max(l_tot - isize, 1)))
        rid = int(np.searchsorted(offs, pos, side="right") - 1)
        left = codes[pos : pos + length].copy()
        right = codes[pos + isize - length : pos + isize].copy()
        s1 = _mutate(rng, left, err, indel, length)
        s2 = revcomp_codes(_mutate(rng, right, err, indel, length))
        name = f"sim_{i}_{rid}_{pos}_{pos + isize - length}"
        r1.append((name, decode(s1), "I" * len(s1)))
        r2.append((name, decode(s2), "I" * len(s2)))
    return r1, r2


def _mutate(rng, frag: np.ndarray, err: float, indel: float,
            length: int) -> np.ndarray:
    seq = list(frag)
    # substitutions
    for j in range(len(seq)):
        if rng.random() < err:
            seq[j] = (seq[j] + 1 + int(rng.integers(0, 3))) % 4
    # indels
    j = 0
    while j < len(seq):
        r = rng.random()
        if r < indel / 2 and len(seq) > length // 2:
            del seq[j]
        elif r < indel:
            seq.insert(j, int(rng.integers(0, 4)))
            j += 2
        else:
            j += 1
    return np.array(seq[:length], dtype=np.uint8)


def write_fastq(path: str, reads) -> None:
    with open(path, "w") as f:
        for name, seq, qual in reads:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")


def golden_fixture(d: str) -> tuple[str, str, str, str]:
    """The fixture tests/golden/*.sam were written from (the recipe of
    tests/test_golden_sam.py::_build_fixture), made with the port's own
    index builder and simulator: (ref, se.fq, r1.fq, r2.fq) in `d`."""
    import os

    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fasta import Contig

    codes = np.random.default_rng(42).integers(0, 4, 60000).astype(np.uint8)
    contigs = [Contig("gA", 40000, 0), Contig("gB", 20000, 40000)]
    ref = os.path.join(d, "golden_ref.fa")
    with open(ref, "w") as f:
        for c in contigs:
            f.write(f">{c.name}\n")
            seq = "".join("ACGT"[x] for x in
                          codes[c.offset:c.offset + c.length])
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")
    FMIndex.build(contigs, codes).save(ref)
    se = simulate_reads(codes, contigs, 300, length=150, err=0.015,
                        indel=0.002, seed=7)
    r1, r2 = simulate_pairs(codes, contigs, 100, length=125, isize_mean=320,
                            isize_std=40, err=0.01, seed=13)
    paths = [os.path.join(d, n) for n in ("se.fq", "r1.fq", "r2.fq")]
    for path, reads in zip(paths, (se, r1, r2)):
        write_fastq(path, reads)
    return (ref, *paths)


def ga_lanes(seed: int, n: int, Q: int = 192, T: int = 256, w0: int = 100):
    """(qD int8 [n, Q], tD int8 [n, T], qlen, tlen, w): lane r is of kind
    r % 8 = 0 mismatches only, 1/2/5 a few short indels, 3 one gap of
    20..60 bases, 4 an indel every ~5 bases (nseg > 24), 6 (r % 16 == 6) a
    one-base target, 7 (r % 16 == 7) a one-base query; kind 4's band is
    the cap 4 * w0, kinds 5 and 6 run at the floor |qlen - tlen| (or 1).
    Global-alignment lanes that hold the kernel (csrc/global_align.cu) and
    its plain version to each other and to the JAX package."""
    rng = np.random.default_rng(seed)
    qD = np.full((n, Q), 4, np.int8)
    tD = np.full((n, T), 4, np.int8)
    qlen = np.zeros(n, np.int32)
    tlen = np.zeros(n, np.int32)
    w = np.zeros(n, np.int32)
    for r in range(n):
        kind = r % 8
        ql = int(rng.integers(30, min(Q, 150) + 1))
        q = rng.integers(0, 4, ql)
        t = q.copy()
        mut = rng.random(ql) < rng.choice([0.0, 0.02, 0.1])
        t[mut] = rng.integers(0, 4, int(mut.sum()))
        if kind in (1, 2, 5):
            for _ in range(int(rng.integers(1, 4))):
                p = int(rng.integers(1, len(t) - 1))
                g = int(rng.integers(1, 6))
                t = (np.concatenate([t[:p], rng.integers(0, 4, g), t[p:]])
                     if rng.random() < 0.5
                     else np.concatenate([t[:p], t[p + g:]]))
        if kind == 3:
            p = int(rng.integers(5, len(t) - 5))
            g = int(rng.integers(20, 60))
            t = (np.concatenate([t[:p], rng.integers(0, 4, g), t[p:]])
                 if r % 16 == 3
                 else np.concatenate([t[:p], t[p + min(g, len(t) - p - 2):]]))
        if kind == 4:
            parts, p = [], 0
            while p < len(q):
                parts.append(q[p:p + 5])
                p += 5
                if rng.random() < 0.5:
                    parts.append(rng.integers(0, 4, 1))
                else:
                    p += 1
            t = np.concatenate(parts)
        if r % 16 == 6:
            t = t[:1]
        if r % 16 == 7:
            q, ql = q[:1], 1
        t = t[:T]
        if rng.random() < 0.1:
            q[rng.integers(0, ql)] = 4
        qD[r, :ql] = q
        tD[r, :len(t)] = t
        qlen[r], tlen[r] = ql, len(t)
        d = abs(ql - len(t))
        w[r] = [d + 3, d + 3, max(d + 3, 11), max(d + 3, 35), 4 * w0, d,
                max(d, 1), w0][kind]
    return qD, tD, qlen, tlen, w


def extend_edge_jobs(seed: int, Q: int = 192, T: int = 768):
    """(query [J, Q], qlen, target [J, T], tlen, w, h0, bonus), int32:
    extension jobs at the edges of ``ops.extend._extend_core``'s contract,
    to hold a kernel to the plain version.  Every combination of qlen in
    {0, 1, 31, 32, 33, 64, 65, 128, 129, Q}, tlen in {0, 1, qlen + 9, T} and
    w in {0, 1, 7, 100, 4 * Q} (the last >= qlen), each with one of seven
    contents by turn: the query is the target's head; a mutated head with
    an indel; a matching head then noise (a z-drop or a zero row ends it);
    an all-N query; an all-N target; one base repeated on both sides (ties
    for gscore); one base repeated, but the query starts with a mismatch
    and two N, so that from row 9 on (h0 >= 10) the row maximum, a new
    best, lies on two diagonals at once, columns i and i + 3 (ties for the
    row maximum's column).  h0 cycles through 1, 5, 60 and 200.  J = 1201
    is a multiple of no group or block size, and the jobs come in no order
    of size."""
    rng = np.random.default_rng(seed)
    qlens = sorted({0, 1, 31, 32, 33, 64, 65, 128, 129, Q} & set(range(Q + 1)))
    specs = [(ql, tl, w) for ql in qlens
             for tl in (0, 1, min(ql + 9, T), T) for w in (0, 1, 7, 100, 4 * Q)]
    specs = [specs[i] for i in rng.permutation(len(specs))]
    J = 1201
    query = rng.integers(0, 4, (J, Q)).astype(np.int32)
    target = rng.integers(0, 4, (J, T)).astype(np.int32)
    qlen, tlen, w = (np.zeros(J, np.int32) for _ in range(3))
    for r in range(J):
        qlen[r], tlen[r], w[r] = specs[r % len(specs)]
        n = min(Q, T)
        kind = (r // len(specs) + r) % 7
        if kind <= 2:
            query[r, :n] = target[r, :n]
        if kind == 1:
            mut = rng.random(Q) < 0.08
            query[r, mut] = rng.integers(0, 4, int(mut.sum()))
            p = int(rng.integers(0, max(Q - 8, 1)))
            query[r, p:Q - 3] = query[r, p + 3:].copy()
        elif kind == 2:
            cut = int(rng.integers(1, max(qlen[r], 2)))
            query[r, cut:] = rng.integers(0, 4, Q - cut)
        elif kind == 3:
            query[r] = 4
        elif kind == 4:
            target[r] = 4
        elif kind == 5:
            query[r] = target[r] = r % 4
        elif kind == 6:
            query[r] = target[r] = r % 4
            query[r, 0] = (r + 1) % 4      # -5 and twice -2 against a match:
            query[r, 1:3] = 4              # diagonal 0 loses what 3 pays
    h0 = np.array([1, 5, 60, 200], np.int32)[np.arange(J) % 4]
    return query, qlen, target, tlen, w, h0, np.full(J, 5, np.int32)


def localsw_edge_jobs(seed: int, Q: int = 192, T: int = 1024):
    """(query [J, Q], qlen, target [J, T], tlen, minsc, endsc), int32:
    local-SW jobs at the edges of ``ops.localsw.localsw_batch``'s contract.
    Every combination of qlen in {0, 1, 31, 32, 33, 150, Q}, tlen in {0, 1,
    T // 2 + 1, T} and (minsc, endsc) in {(0, never), (19, never), (19, 1:
    reached on row 0 wherever a base matches), (19, 30), (10 ** 6, never)},
    each with one of six contents by turn: a mutated copy of the query in
    the window; two exact copies far apart (a tie for te, the first wins,
    and a score2); noise; an all-N query; an all-N target; one base
    repeated on both sides (ties for qe).  J = 1123."""
    rng = np.random.default_rng(seed)
    never = 1 << 30
    qlens = sorted({0, 1, 31, 32, 33, min(150, Q), Q})
    specs = [(ql, tl, ms, es) for ql in qlens
             for tl in (0, 1, T // 2 + 1, T)
             for ms, es in ((0, never), (19, never), (19, 1), (19, 30),
                            (10 ** 6, never))]
    specs = [specs[i] for i in rng.permutation(len(specs))]
    J = 1123
    query = rng.integers(0, 4, (J, Q)).astype(np.int32)
    target = rng.integers(0, 4, (J, T)).astype(np.int32)
    qlen, tlen, minsc, endsc = (np.zeros(J, np.int32) for _ in range(4))
    for r in range(J):
        ql, tl, minsc[r], endsc[r] = specs[r % len(specs)]
        qlen[r], tlen[r] = ql, tl
        kind = (r // len(specs) + r) % 7
        if kind == 0 and tl > ql > 0:
            off = int(rng.integers(0, tl - ql))
            piece = query[r, :ql].copy()
            mut = rng.random(ql) < 0.05
            piece[mut] = rng.integers(0, 4, int(mut.sum()))
            target[r, off:off + ql] = piece
        elif kind == 1 and tl >= 4 * ql > 0:
            target[r, :ql] = query[r, :ql]
            target[r, tl - ql:tl] = query[r, :ql]
        elif kind == 3:
            query[r] = 4
        elif kind == 4:
            target[r] = 4
        elif kind == 5:
            query[r] = target[r] = r % 4
        elif kind == 6:
            query[r] = target[r] = r % 4
            query[r, 0] = (r + 1) % 4      # -5 and twice -2 against a match:
            query[r, 1:3] = 4              # diagonal 0 loses what 3 pays
    return query, qlen, target, tlen, minsc, endsc


def ga_edge_lanes(seed: int, Q: int = 192, T: int = 256):
    """(qD int8 [n, Q], tD int8 [n, T], rows int64 [M], qlen, tlen, w; the
    last three int32 [M], for lanes ``rows``): global-alignment lanes at
    the edges of ``ops.global_align.global_align_cigar_batch``'s contract,
    to hold a kernel to the plain version.  Every combination of qlen in
    {0, 1, 2, 31, 32, 33, 64, 65, 150, Q}, tlen in {0, 1, qlen, qlen + 40,
    T} and w in {-1, 0, 1, 3, 16, 17, 40, 64, 100, Q + T, 4 * (Q + T)}, so
    w = 0 with qlen == tlen, a band wider than the matrix, and bands that
    leave the corner (tlen-1, qlen-1) outside all occur, as do bands of
    every width class a kernel may tell apart.  Each lane has one of
    seven contents by turn: the target is the query; a mutated copy with
    short indels; the query after 40 bases of noise (a long leading
    deletion); the query before noise (a long trailing deletion); an indel
    every ~5 bases (more CIGAR segments than a pack of 24 holds); one base
    repeated on both sides (every tie); N codes in both.  M = 1103 lanes,
    in no order of size, picked from n = M + 7 buffer rows by a
    permutation; M is a multiple of no warp or block size."""
    rng = np.random.default_rng(seed)
    qlens = sorted({0, 1, 2, 31, 32, 33, 64, 65, min(150, Q), Q}
                   & set(range(Q + 1)))
    specs = [(ql, tl, w) for ql in qlens
             for tl in sorted({0, 1, min(ql, T), min(ql + 40, T), T})
             for w in (-1, 0, 1, 3, 16, 17, 40, 64, 100, Q + T, 4 * (Q + T))]
    specs = [specs[i] for i in rng.permutation(len(specs))]
    M = 1103
    n = M + 7
    qD = rng.integers(0, 4, (n, Q)).astype(np.int8)
    tD = rng.integers(0, 4, (n, T)).astype(np.int8)
    rows = rng.permutation(n)[:M].astype(np.int64)
    qlen, tlen, w = (np.zeros(M, np.int32) for _ in range(3))
    for r in range(M):
        ql, tl, w[r] = specs[r % len(specs)]
        qlen[r], tlen[r] = ql, tl
        q = qD[rows[r], :ql].astype(np.int64)
        kind = (r // len(specs) + r) % 7
        if kind == 0:
            t = q
        elif kind == 1:
            t = q.copy()
            mut = rng.random(ql) < 0.05
            t[mut] = rng.integers(0, 4, int(mut.sum()))
            for _ in range(3):
                p = int(rng.integers(0, len(t) + 1))
                g = int(rng.integers(1, 6))
                t = (np.concatenate([t[:p], rng.integers(0, 4, g), t[p:]])
                     if rng.random() < 0.5
                     else np.concatenate([t[:p], t[p + g:]]))
        elif kind == 2:
            t = np.concatenate([rng.integers(0, 4, 40), q])
        elif kind == 3:
            t = np.concatenate([q, rng.integers(0, 4, 40)])
        elif kind == 4:
            parts, p = [], 0
            while p < ql:
                parts.append(q[p:p + 5])
                p += 5
                if rng.random() < 0.5:
                    parts.append(rng.integers(0, 4, 1))
                else:
                    p += 1
            t = np.concatenate(parts) if parts else q
        elif kind == 5:
            qD[rows[r]] = tD[rows[r]] = r % 4
            continue
        else:
            t = q.copy()
            qD[rows[r], rng.random(Q) < 0.1] = 4
            t[rng.random(len(t)) < 0.1] = 4
        m = min(len(t), T)
        tD[rows[r], :m] = t[:m]
    return qD, tD, rows, qlen, tlen, w


def smem_edge_reference(seed: int, n: int = 24000) -> np.ndarray:
    """A small genome (uint8 codes) for ``smem_edge_reads``: random
    sequence with 40 copies of one 200 bp element at ~3 % divergence, so a
    read of that element has a high-copy interval at every length."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    elem = rng.integers(0, 4, 200).astype(np.uint8)
    for p in np.linspace(100, n - 400, 40).astype(int):
        e = elem.copy()
        m = rng.random(200) < 0.03
        e[m] = (e[m] + rng.integers(1, 4, int(m.sum()))) % 4
        codes[p:p + 200] = e
    return codes


def smem_edge_reads(seed: int, codes: np.ndarray, L: int = 160,
                    min_seed_len: int = 19):
    """(q int32 [B, L] padded with 4, lens int32 [B]): reads at the edges
    of the SMEM chains' contract (``ops.smem_chain``), cut from the genome
    `codes` of ``smem_edge_reference`` with 1 % of the bases changed.  By
    turn r % 8: 0 a 150 bp read of the high-copy element's neighbourhood,
    the only long chain of its group of four lanes (1-3 are reads of 8 to
    13 bases, whose chains take a tenth of its steps); 4 N at both ends and in two runs; 5 an empty read or one
    shorter than min_seed_len; 6 a read of the element alone (every lane
    of the warp a long BWD walk); 7 a full-width read of L bases, the last
    an N.  B = 203, a multiple of no group or block size."""
    rng = np.random.default_rng(seed)
    B = 203
    n = len(codes)
    starts = np.linspace(100, n - 400, 40).astype(int)
    q = np.full((B, L), 4, np.int32)
    lens = np.zeros(B, np.int32)
    for r in range(B):
        kind = r % 8
        s0 = int(starts[rng.integers(0, 40)])
        if kind == 0:
            pos, ln = s0 - int(rng.integers(0, 60)), min(150, L)
        elif kind in (1, 2, 3):
            pos = int(rng.integers(0, n - L))
            ln = int(rng.integers(8, 14))
        elif kind == 5:
            pos, ln = int(rng.integers(0, n - L)), (0, 5, min_seed_len - 1)[
                (r // 8) % 3]
        elif kind == 6:
            pos, ln = s0 + int(rng.integers(0, 50)), min(150, L)
        elif kind == 7:
            pos, ln = int(rng.integers(0, n - L)), L
        else:
            pos, ln = int(rng.integers(0, n - L)), min(150, L)
        read = codes[pos:pos + ln].astype(np.int32)
        mut = rng.random(ln) < 0.01
        read[mut] = rng.integers(0, 4, int(mut.sum()))
        if kind == 4:
            read[:3] = 4
            read[-2:] = 4
            read[40:44] = 4
            read[90] = 4
        if kind == 7:
            read[-1] = 4
        q[r, :ln] = read
        lens[r] = ln
    return q, lens


def smem_edge_round2(seed: int, lens: np.ndarray):
    """(rd, mid int32 [G], thr int64 [G], act bool [G]): round-2 lanes over
    the reads of ``smem_edge_reads``: read rows in no order and with
    repeats; mid at 0, at the last base, past the read's end, on N codes
    and anywhere; thresholds 1, 2, 5 and 1000 (nothing is taken); a fifth
    of the lanes inactive.  G = 3 * B + 5, a multiple of no group or block
    size."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    G = 3 * B + 5
    rd = rng.integers(0, B, G).astype(np.int32)
    ln = lens[rd]
    mid = (rng.random(G) * np.maximum(ln, 1)).astype(np.int32)
    mid[::7] = np.maximum(ln[::7] - 1, 0)
    mid[1::11] = 0
    mid[2::13] = ln[2::13]
    mid[3::17] = 41                     # inside kind 4's N run
    thr = np.array([1, 2, 5, 1000], np.int64)[rng.integers(0, 4, G)]
    act = rng.random(G) > 0.2
    return rd, mid, thr, act


SA_EDGE_ROWS = 3001   # a multiple of no warp, block or run size


def sa_edge_rows(idx, shift: int) -> np.ndarray:
    """int64 rows of the FM index `idx` at the edges of a sampled-SA lookup
    (``ops.fm.sa_lookup_sampled``) at 2^shift: rows whose walk is the
    longest (sa mod 2^shift = 2^shift - 1; up to 1,000 of them), the
    primary row (sa = 0) and its neighbours, rows 0 and N, rows at offsets
    0, 31, 32 and 63 of a 64-row block (the edges of the directory's and
    the checkpoints' words), then random rows with repeats, in no order,
    to ``SA_EDGE_ROWS`` rows (fewer only for an index of fewer rows)."""
    rng = np.random.default_rng(shift)
    sa = np.asarray(idx.sa, np.int64)
    n = sa.size                                  # rows 0 .. N
    intv = 1 << shift
    longest = np.flatnonzero(sa % intv == intv - 1)[:1000]
    p = int(idx.primary)
    ends = np.array([0, n - 1, p - 1, p, p + 1])
    base = 64 * rng.integers(0, (n + 63) // 64, 200)
    edges = (base[:, None] + np.array([0, 31, 32, 63])).reshape(-1)
    rows = np.concatenate([longest, ends, edges])
    rows = rows[(rows >= 0) & (rows < n)]
    fill = rng.integers(0, n, max(SA_EDGE_ROWS - rows.size, 0))
    rows = np.concatenate([rows, fill])[:SA_EDGE_ROWS]
    return rows[rng.permutation(rows.size)]


HIGH_WORD = (1 << 31) + 12_345   # >= 2^31, < 2^32: sets a low word's sign


def high_word_index(idx, shift: int, offset: int = HIGH_WORD) -> dict:
    """numpy arrays of a synthetic wide index made from the FM index `idx`
    (the fields of ``ops.fm.DeviceIndex`` and ``ops.fm.SampledSA`` at
    2^shift, wide dtypes): the occ counts of ``cp`` and the SA values
    (``sa`` and the samples ``vals``) carry `offset`, and ``L2`` carries
    ``-offset``, so that every LF step, ``L2[c] + occ``, lands on the row
    it lands on in `idx`.  Occ counts, ``occ4`` and ``ext_core``'s
    intermediate counts and the looked-up positions then lie at or above
    2^31 (below the 2^32 that a 1.2 Gbp text's rows reach), while every
    row stays a row of `idx`: ``sa_lookup_sampled`` of a row gives its SA
    value plus `offset`."""
    import torch

    from tpubwa_torch.ops.fm import DeviceIndex, build_sampled_sa

    di = DeviceIndex.from_host(idx, "cpu", wide=True)
    ss = build_sampled_sa(None, shift, True, idx=idx, device="cpu")
    cp = di.cp.numpy().copy()
    cp[:, 0:4] += offset
    return dict(cp=cp, sa=di.sa.numpy() + offset,
                pac_words=di.pac_words.numpy(),
                L2=di.L2.numpy() - offset, primary=di.primary,
                l_pac=di.l_pac, blocks=ss.blocks.numpy(),
                vals=(ss.vals.to(torch.int64) + offset).numpy())


def main() -> None:
    ap = argparse.ArgumentParser(description="simulate reads from a FASTA")
    ap.add_argument("ref")
    ap.add_argument("out_fq")
    ap.add_argument("--out-fq2", default=None, help="write pairs")
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--len", type=int, default=150, dest="length")
    ap.add_argument("--err", type=float, default=0.01)
    ap.add_argument("--indel", type=float, default=0.0005)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    contigs, codes, _ = read_fasta(args.ref)
    if args.out_fq2:
        r1, r2 = simulate_pairs(codes, contigs, args.n, args.length,
                                err=args.err, indel=args.indel,
                                seed=args.seed)
        write_fastq(args.out_fq, r1)
        write_fastq(args.out_fq2, r2)
    else:
        reads = simulate_reads(codes, contigs, args.n, args.length,
                               err=args.err, indel=args.indel,
                               seed=args.seed)
        write_fastq(args.out_fq, reads)


if __name__ == "__main__":
    main()
