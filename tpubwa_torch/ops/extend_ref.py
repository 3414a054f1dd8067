"""Scalar reference for banded affine-gap seed extension (NumPy; port of
``tpubwa.ops.extend_ref``).

Defines the framework's extension semantics — the algorithm of bwa's
ksw_extend2 (the reference's BandedPairWiseSW/getScores kernels implement the
same DP; SURVEY.md §2.1 "Banded Smith-Waterman" and §3.4).  Stated here in
the *full-band* formulation: each row i computes all cells in the band
[max(0, i-w), min(qlen, i+w+1)), with out-of-band cells pinned to 0.  The
reference's adaptive zero-trimming of rows is semantically neutral (trimmed
cells are exactly zero), except that the "reached end of query" global-score
update fires whenever the band touches the query end — a difference only
observable as gscore==0 vs gscore==-1, both "no to-end alignment".

Key recurrences (note gaps open from M, the match-path score, not from H —
this disallows adjacent insertion/deletion ops):

  M(i,j) = H(i-1,j-1) > 0 ? H(i-1,j-1) + S(t[i], q[j]) : 0
  E(i,j) = max(M(i-1,j) - o_del - e_del, E(i-1,j) - e_del, 0)
  F(i,j) = max(M(i,j-1) - o_ins - e_ins, F(i,j-1) - e_ins, 0)
  H(i,j) = max(M(i,j), E(i,j), F(i,j))

with boundary H(-1,j) = max(0, h0 - o_ins - (j+1)*e_ins), H(-1,-1) = h0,
H(i,-1) = max(0, h0 - o_del - (i+1)*e_del).

Termination: per-row max m == 0 -> stop; Z-drop; row-band max, last argmax.
Returns (score, qle, tle, gtle, gscore, max_off).

An oracle written apart from the batched plain version
(``ops.extend._extend_core``) and the kernels K1 and K1b: the tests and
``chip_smoke.py`` hold both to it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ExtendResult:
    score: int
    qle: int
    tle: int
    gtle: int
    gscore: int
    max_off: int


def clamp_band(w: int, qlen: int, mat_max: int, o_del: int, e_del: int,
               o_ins: int, e_ins: int, end_bonus: int) -> int:
    """ksw_extend2's adjustment of an oversized band to the max useful gap."""
    max_ins = int((qlen * mat_max + end_bonus - o_ins) / e_ins + 1.0)
    w = min(w, max(max_ins, 1))
    max_del = int((qlen * mat_max + end_bonus - o_del) / e_del + 1.0)
    return min(w, max(max_del, 1))


def extend_ref(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
               o_del: int, e_del: int, o_ins: int, e_ins: int, w: int,
               end_bonus: int, zdrop: int, h0: int) -> ExtendResult:
    """Scalar reference extension.  query/target: uint8 codes (0..4)."""
    qlen, tlen = len(query), len(target)
    assert h0 > 0
    if qlen == 0 or tlen == 0:
        return ExtendResult(h0, 0, 0, 0, -1, 0)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    w = clamp_band(w, qlen, int(mat.max()), o_del, e_del, o_ins, e_ins,
                   end_bonus)

    # H_prev[j+1] = H(i-1, j); index 0 is the boundary column H(i-1, -1)
    H_prev = np.zeros(qlen + 1, dtype=np.int64)
    H_prev[0] = h0
    for j in range(qlen):
        v = h0 - oe_ins - j * e_ins
        H_prev[j + 1] = v if v > 0 else 0
    E = np.zeros(qlen, dtype=np.int64)       # E(i, j)
    M_prev = np.zeros(qlen, dtype=np.int64)  # M(i-1, j)

    best = h0
    best_i = best_j = -1
    max_ie = -1
    gscore = -1
    max_off = 0

    for i in range(tlen):
        beg = max(0, i - w)
        end = min(qlen, i + w + 1)
        # E(i, j) from previous row
        if i > 0:
            E = np.maximum(np.maximum(M_prev - oe_del, E - e_del), 0)
        H_row = np.zeros(qlen + 1, dtype=np.int64)
        H_row[0] = max(0, h0 - o_del - e_del * (i + 1))
        M_row = np.zeros(qlen, dtype=np.int64)
        f = 0
        m = 0
        mj = -1
        for j in range(beg, end):
            hd = H_prev[j]  # H(i-1, j-1)
            M = hd + int(mat[target[i], query[j]]) if hd > 0 else 0
            M_row[j] = M
            h = max(M, E[j], f)
            H_row[j + 1] = h
            if h >= m:
                m = h
                mj = j
            t = max(M - oe_ins, 0)
            f = max(f - e_ins, t)
        if end == qlen:
            h_last = H_row[qlen]
            if h_last >= gscore:
                gscore = h_last
                max_ie = i
        if m == 0:
            break
        if m > best:
            best, best_i, best_j = m, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            di, dj = i - best_i, mj - best_j
            if di > dj:
                if best - m - (di - dj) * e_del > zdrop:
                    break
            else:
                if best - m - (dj - di) * e_ins > zdrop:
                    break
        H_prev = H_row
        M_prev = M_row

    return ExtendResult(
        score=int(best), qle=best_j + 1, tle=best_i + 1, gtle=max_ie + 1,
        gscore=int(gscore), max_off=int(max_off))
