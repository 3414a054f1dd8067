"""The plain reference: its DP against a scalar one, its SAM arithmetic,
and that it imports nothing of the program."""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import faults
from portbench.reference import check, dp

SC = {"a": 1, "b": 4, "o_del": 6, "e_del": 1, "o_ins": 6, "e_ins": 1,
      "pen_clip5": 5, "pen_clip3": 5, "T": 30}
NEG = -10 ** 9


def scalar_best(q, t, sc):
    """Gotoh over all alignments, clip-penalised ends, window free."""
    m, n = len(q), len(t)
    mat = dp.score_matrix(sc["a"], sc["b"]).numpy()
    H = [[NEG] * (n + 1) for _ in range(m + 1)]
    E = [[NEG] * (n + 1) for _ in range(m + 1)]
    F = [[NEG] * (n + 1) for _ in range(m + 1)]
    best = NEG
    for i in range(1, m + 1):
        start = 0 if i == 1 else -sc["pen_clip5"]
        for j in range(1, n + 1):
            s = int(mat[q[i - 1], t[j - 1]])
            d = max(H[i - 1][j - 1], start) + s
            F[i][j] = max(H[i - 1][j] - sc["o_ins"] - sc["e_ins"],
                          F[i - 1][j] - sc["e_ins"])
            E[i][j] = max(H[i][j - 1] - sc["o_del"] - sc["e_del"],
                          E[i][j - 1] - sc["e_del"])
            H[i][j] = max(d, E[i][j], F[i][j])
            best = max(best, H[i][j] - (sc["pen_clip3"] if i < m else 0))
    return best


def test_dp_equals_a_scalar_gotoh():
    rng = np.random.default_rng(0)
    qs, ts, lens, want = [], [], [], []
    for k in range(40):
        t = rng.integers(0, 4, 30)
        lo = int(rng.integers(0, 8))
        q = t[lo:lo + int(rng.integers(12, 20))].copy()
        for _ in range(int(rng.integers(0, 4))):       # substitutions
            q[rng.integers(0, q.size)] = rng.integers(0, 4)
        if k % 3 == 0:                                   # an indel
            p = int(rng.integers(1, q.size - 1))
            q = (np.delete(q, p) if k % 2 else
                 np.insert(q, p, rng.integers(0, 4)))
        qs.append(np.pad(q, (0, 24 - q.size), constant_values=4))
        ts.append(t)
        lens.append(q.size)
        want.append(scalar_best(list(q), list(t), SC))
    got = dp.best_clipped(torch.tensor(np.array(qs)), torch.tensor(lens),
                          torch.tensor(np.array(ts)), SC)
    assert got.tolist() == want


def test_cigar_score_and_end_room():
    ref = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1], dtype=np.uint8)
    # ACGT + one mismatch, 1 base deleted, 2 matches, then a soft clip
    seq = b"ACGTCGTTT"
    ops = check._ops("5M1D2M2S")
    s, nm = check.cigar_score(ops, seq, ref, 0, SC)
    assert (s, nm) == (4 - 4 - 7 + 2, 2)
    assert check._end_pens(ops, False, SC) == (5, 4)
    assert check._end_pens(ops, True, SC) == (5, 4)
    assert check._end_pens(check._ops("10M"), False, SC) == (0, 8)


def test_unanswered_counts_missing_duplicate_extra_and_order():
    exp = [("a", 0), ("b", 0), ("c", 0)]
    assert check.unanswered(exp, exp) == 0
    assert check.unanswered([("a", 0), ("c", 0)], exp) == 1
    assert check.unanswered([("a", 0), ("b", 0), ("b", 0), ("c", 0)],
                            exp) == 1
    assert check.unanswered(exp + [("z", 0)], exp) == 1
    assert check.unanswered([("b", 0), ("a", 0), ("c", 0)], exp) == 2


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference.check, portbench.reference.dp,"
            " portbench.gen.genomes, portbench.gen.reads;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = eval(out)
    assert not {"jax", "jaxlib", "flax", "tpubwa", "tpubwa_torch",
                "bench"} & set(tops)


def _rec(flag, pos, tlen, mapq=60, contig="c", xs=None, as_=140):
    tags = [f"AS:i:{as_}"] + ([f"XS:i:{xs}"] if xs is not None else [])
    return ["r", str(flag), contig, str(pos), str(mapq), "150M", "=", "1",
            str(tlen), "A" * 150, "I" * 150, *tags]


@pytest.mark.parametrize("f0,f1,why", [
    (_rec(99, 100, 400), _rec(147, 350, -400), None),
    (_rec(163, 350, -400), _rec(83, 100, 400), "forward end's TLEN -400"),
    (_rec(97, 100, 400), _rec(145, 350, -400), "no flag 2"),
    (_rec(99, 100, 400), _rec(131, 350, -400), "ends on one strand"),
    (_rec(99, 100, 400), _rec(151, 350, -400), "an end unmapped"),
    (_rec(99, 100, 400), _rec(147, 350, -400, contig="d"),
     "ends on two contigs"),
    (_rec(99, 100, 900), _rec(147, 850, -900), "forward end's TLEN 900"),
])
def test_a_pair_is_proper_by_bwa_rules(f0, f1, why):
    assert check._improper(f0, f1, 700) == why


@pytest.mark.parametrize("kind,field,want", [
    ("mapq0", 4, ["0", "0", "0"]),
    ("mapq60", 4, ["60", "3", "0"]),
    ("unpaired", 1, ["97", "4", "2048"]),
])
def test_sam_faults_alter_what_they_name(kind, field, want):
    recs = [_rec(99, 1, 0, mapq=7), _rec(4, 1, 0, mapq=3),
            _rec(2048 | 2, 1, 0, mapq=0)]
    text = "@HD\tVN:1.6\n" + "\n".join("\t".join(r) for r in recs) + "\n"
    out = faults.alter_sam(text, kind).split("\n")
    assert out[0] == "@HD\tVN:1.6" and out[-1] == ""
    assert [ln.split("\t")[field] for ln in out[1:-1]] == want
