"""The benchmark's frozen generators against the port's, at small sizes."""
from __future__ import annotations

import numpy as np
import pytest

from portbench.gen import genomes, reads


def test_repeat_genome_is_the_ports():
    from tpubwa_torch.utils.simgenome import repeat_genome

    a = genomes.repeat_genome(np.random.default_rng(42), 80_000)
    b = repeat_genome(np.random.default_rng(42), 80_000)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("length", [120_000, 120_003])
def test_realistic_genome_is_the_ports(length):
    from tpubwa_torch.utils import gensim

    a, ma = genomes.make_genome({"model": "realistic", "seed": 1234,
                                 "length": length})
    b, mb = gensim.realistic_genome(np.random.default_rng(1234), length)
    assert np.array_equal(a, b) and np.array_equal(ma, mb)
    assert ma.any()


def test_uniform_genome_is_the_bench_recipe():
    a, mask = genomes.make_genome({"model": "uniform", "seed": 42,
                                   "length": 50_000})
    b = np.random.default_rng(42).integers(0, 4, 50_000).astype(np.uint8)
    assert np.array_equal(a, b) and not mask.any()


def test_fasta_and_index_text_are_the_ports(tmp_path):
    from tpubwa_torch.io.fasta import read_fasta
    from tpubwa_torch.utils import gensim

    codes, mask = genomes.make_genome({"model": "realistic", "seed": 7,
                                       "length": 100_000})
    ours, theirs = tmp_path / "a.fa", tmp_path / "b.fa"
    genomes.write_fasta(str(ours), codes, mask, "c1")
    gensim.write_fasta(str(theirs), codes, mask, name="c1")
    assert ours.read_bytes() == theirs.read_bytes()
    contigs, text, holes = read_fasta(str(ours))
    assert np.array_equal(genomes.index_text(codes, mask), text)
    assert len(contigs) == 1 and holes.shape[0] > 0


class FixedDraws:
    """A Generator stand-in that hands out given arrays in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def random(self, size, dtype=None):
        return self.draws.pop(0).reshape(size)

    def integers(self, lo, hi, size, dtype=None):
        out = self.draws.pop(0)
        assert out.size == size and lo <= out.min() and out.max() < hi
        return out


def scalar_mutate(frag, sub, off, r, ins_base, indel, length):
    """The port's ``utils/sim.py::_mutate`` loop on given draws."""
    seq = list(frag)
    k = 0
    for j in range(len(seq)):
        if sub[j]:
            seq[j] = (seq[j] + off[k]) % 4
            k += 1
    j = i = 0
    while j < len(seq):
        x = r[i]
        if x < indel / 2 and len(seq) > length // 2:
            del seq[j]
        elif x < indel:
            seq.insert(j, ins_base[i])
            j += 2
        else:
            j += 1
        i += 1
    return np.array(seq[:length], dtype=np.uint8)


def test_mutate_is_the_ports_model_on_the_same_draws():
    rng = np.random.default_rng(3)
    n, L, err, indel = 64, 150, 0.05, 0.05
    frag = rng.integers(0, 4, (n, L)).astype(np.uint8)
    u_sub = rng.random((n, L)).astype(np.float32)
    sub = u_sub < err
    off = rng.integers(1, 4, int(sub.sum())).astype(np.uint8)
    r = rng.random((n, L)).astype(np.float32)
    ev_rows = np.flatnonzero((r < indel).any(axis=1))
    ins = (r[ev_rows] >= indel / 2) & (r[ev_rows] < indel)
    ins_vals = rng.integers(0, 4, int(ins.sum())).astype(np.uint8)
    got, lens = reads.mutate(FixedDraws([u_sub, off, r, ins_vals]), frag,
                             err, indel)
    ins_base = np.zeros((n, L), dtype=np.uint8)
    full = np.zeros((n, L), dtype=bool)
    full[ev_rows] = ins
    ins_base[full] = ins_vals
    k0 = np.concatenate([[0], np.cumsum(sub.sum(axis=1))])
    for i in range(n):
        want = scalar_mutate(frag[i], sub[i], off[k0[i]:k0[i + 1]], r[i],
                             ins_base[i], indel, L)
        assert lens[i] == want.size
        assert np.array_equal(got[i, :lens[i]], want)
        assert (got[i, lens[i]:] == 4).all()
    assert (lens < L).any()


@pytest.mark.parametrize("ends", [1, 2])
def test_error_free_reads_are_cut_from_their_origin(ends):
    text = np.random.default_rng(1).integers(0, 4, 30_000).astype(np.uint8)
    traffic = {"ends": ends, "batch_reads": 200, "read_len": 150, "err": 0.0,
               "indel": 0.0, "isize_mean": 400, "isize_std": 50,
               "mate_swap": 0.5}
    b = reads.make_batch(text, traffic, 2 ** 31 + 5, 0, 3)
    for e in range(ends):
        fwd = b.forward(e)
        for i in range(200):
            assert np.array_equal(fwd[i], text[b.pos[e, i]:b.pos[e, i] + 150])
    if ends == 2:
        assert set(np.unique(b.strand[0] + b.strand[1])) == {1}
        assert 0 < b.strand[0].mean() < 1          # mates swapped at times
        span = np.abs(b.pos[1] - b.pos[0]) + 150
        assert 250 < span.mean() < 550
    again = reads.make_batch(text, traffic, 2 ** 31 + 5, 0, 3)
    assert np.array_equal(again.codes, b.codes)


def test_error_rates_are_the_ports():
    from tpubwa_torch.io.fasta import Contig
    from tpubwa_torch.utils.sim import simulate_reads

    text = np.random.default_rng(2).integers(0, 4, 200_000).astype(np.uint8)
    traffic = {"ends": 1, "batch_reads": 4000, "read_len": 150,
               "err": 0.01, "indel": 0.002}
    b = reads.make_batch(text, traffic, 11, 0, 0)
    port = simulate_reads(text, [Contig("c", text.size, 0)], 1500,
                          err=0.01, indel=0.002, seed=11)

    def rates(seqs, starts):
        """(substitution rate of reads with no indel, share shortened by a
        deletion, share shifted by an insertion)."""
        ham = [(s != text[p:p + 150]).sum() if s.size == 150 else -1
               for s, p in zip(seqs, starts)]
        ham = np.array(ham)
        clean = ham[(ham >= 0) & (ham < 15)]
        return (clean.mean() / 150, (ham < 0).mean(), (ham >= 15).mean())

    ours = rates([b.forward(0)[i, :b.lens[0, i]] for i in range(4000)],
                 b.pos[0])
    from tpubwa_torch.utils.dna import encode, revcomp_codes

    theirs_seqs, theirs_pos = [], []
    for name, seq, _ in port:
        _, _, _, pos, strand = name.split("_")
        c = encode(seq)
        theirs_seqs.append(revcomp_codes(c) if int(strand) else c)
        theirs_pos.append(int(pos))
    theirs = rates(theirs_seqs, theirs_pos)
    # 1 % substitutions; 0.2 % indels: ~13 % of reads hold one, half of
    # them deletions (shorter reads), half insertions (shifted bases)
    assert abs(ours[0] - theirs[0]) < 0.002
    assert abs(ours[1] - theirs[1]) < 0.03
    assert abs(ours[2] - theirs[2]) < 0.03


def test_a_failing_read_2_share_changes_only_its_pairs():
    text = np.random.default_rng(3).integers(0, 4, 30_000).astype(np.uint8)
    traffic = {"ends": 2, "batch_reads": 2000, "read_len": 150, "err": 0.0,
               "indel": 0.0, "isize_mean": 400, "isize_std": 50,
               "mate_swap": 0.5}
    plain = reads.make_batch(text, traffic, 2 ** 31 + 9, 0, 1)
    same = reads.make_batch(text, dict(traffic, r2_bad_share=0.0), 2 ** 31 + 9,
                            0, 1)
    bad = reads.make_batch(text, dict(traffic, r2_bad_share=0.05,
                                      r2_bad_err=0.12), 2 ** 31 + 9, 0, 1)
    # a mix without the share draws nothing for it
    assert np.array_equal(plain.codes, same.codes)
    # read 1 and every position are those of the mix without it
    assert np.array_equal(plain.codes[0], bad.codes[0])
    assert np.array_equal(plain.pos, bad.pos)
    ham = (bad.forward(1) != plain.forward(1)).sum(axis=1)
    hit = ham > 0
    assert 0.03 < hit.mean() < 0.07
    assert 0.10 < ham[hit].mean() / 150 < 0.14      # each draw changes a base
