"""The port's seed chaining against the JAX package.

* ``tpubwa_torch.align.chain.chain_read`` + ``filter_chains`` against
  ``tpubwa.align.chain``'s on the same seeds, chain for chain;
* the port's native ``chain_filter_batch`` (``native/chain.cpp``, through
  ``chain_filter_batch_native``) against the port's Python version.

The cases are those of ``tests/test_chain_native.py``: random clustered
seeds across the strand boundary and two contigs, edge cases, tight
filter options, and the port's own device seeding of simulated reads.
"""
import numpy as np
import pytest
import torch

from tpubwa.align import chain as jchain
from tpubwa.config import MemOptions as JaxOptions
from tpubwa_torch.align import chain as tchain
from tpubwa_torch.config import MemOptions

torch.set_num_threads(1)


def _random_case():
    rng = np.random.default_rng(11)
    l_pac = 50_000
    offs = np.array([0, 30_000], dtype=np.int64)  # two contigs
    B = 200
    lens = np.full(B, 150, np.int64)
    l_rep = rng.integers(0, 100, B)
    rows = []
    for b in range(B):
        for _ in range(rng.integers(1, 4)):
            anchor = rng.integers(0, 2 * l_pac - 200)
            qs = np.sort(rng.integers(0, 130, rng.integers(1, 8)))
            for q in qs:
                jitter = rng.integers(-30, 30)
                ln = rng.integers(19, 40)
                rb = int(np.clip(anchor + q + jitter, 0, 2 * l_pac - ln))
                rows.append((b, rb, int(q), int(ln)))
    rows.sort()
    return {}, l_pac, offs, np.array(rows, np.int64), lens, l_rep


def _edge_case():
    rows = [
        # read 0: chainable pair + contained seed
        (0, 100, 0, 30), (0, 130, 30, 30), (0, 110, 10, 19),
        # read 1: seed bridging the strand boundary (rid -2 -> dropped)
        (1, 990, 0, 20),
        # read 2: two distant clusters -> two chains
        (2, 50, 0, 25), (2, 1500, 5, 25),
        # read 3 has no seeds; read 4 is shorter than min_seed_len
        (4, 10, 0, 19),
    ]
    return ({}, 1000, np.array([0], np.int64), np.array(rows, np.int64),
            np.array([150, 150, 150, 150, 10], np.int64),
            np.zeros(5, np.int64))


def _tight_case():
    rng = np.random.default_rng(7)
    l_pac = 20_000
    B = 100
    rows = []
    for b in range(B):
        for _ in range(rng.integers(2, 6)):
            anchor = rng.integers(0, 2 * l_pac - 200)
            for q in np.sort(rng.integers(0, 120, rng.integers(1, 5))):
                ln = rng.integers(19, 60)
                rb = int(np.clip(anchor + q, 0, 2 * l_pac - ln))
                rows.append((b, rb, int(q), int(ln)))
    rows.sort()
    knobs = dict(max_chain_extend=2, drop_ratio=0.9, mask_level=0.3,
                 min_chain_weight=20)
    return (knobs, l_pac, np.array([0], np.int64), np.array(rows, np.int64),
            np.full(B, 150, np.int64), np.zeros(B, np.int64))


def _real_case():
    """Seed rows of simulated reads from the port's own device seeding."""
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fasta import Contig
    from tpubwa_torch.io.fastq import Read, batch_reads
    from tpubwa_torch.utils.sim import simulate_reads

    codes = np.random.default_rng(3).integers(0, 4, 20000).astype(np.uint8)
    contigs = [Contig("c1", 20000, 0)]
    idx = FMIndex.build(contigs, codes)
    al = Aligner(idx, device="cpu")
    reads = simulate_reads(codes, contigs, 64, length=150, err=0.02,
                           indel=0.003, seed=9)
    batch = next(batch_reads([Read(*r) for r in reads], 64, 160))
    rows, l_rep = al.seed_batch(batch.codes, batch.lens)
    return ({}, idx.l_pac, al.contig_offsets, rows, batch.lens, l_rep)


CASES = {"random": _random_case, "edge": _edge_case, "tight": _tight_case,
         "real_seeding": _real_case}


def _python_chains(mod, opt, l_pac, offs, rows, lens, l_rep):
    out = []
    for b in range(len(lens)):
        if lens[b] < opt.min_seed_len:
            out.append([])
            continue
        seg = rows[rows[:, 0] == b]
        seeds = [mod.Seed(int(r[1]), int(r[2]), int(r[3]), int(r[3]))
                 for r in seg]
        chains = mod.chain_read(opt, l_pac, offs, seeds, int(lens[b]),
                                int(l_rep[b]))
        out.append(mod.filter_chains(opt, chains))
    return out


def _as_tuples(chains_per_read):
    return [[(c.pos, c.rid, c.w, c.kept, c.frac_rep,
              [(s.rbeg, s.qbeg, s.len, s.score) for s in c.seeds])
             for c in chains] for chains in chains_per_read]


@pytest.mark.parametrize("case", list(CASES))
def test_chain_read_filter_match_jax(case):
    """chain_read + filter_chains: every kept chain (anchor, contig,
    weight, kept class, frac_rep, seeds) equals the JAX package's."""
    knobs, l_pac, offs, rows, lens, l_rep = CASES[case]()
    want = _python_chains(jchain, JaxOptions(**knobs), l_pac, offs, rows,
                          lens, l_rep)
    got = _python_chains(tchain, MemOptions(**knobs), l_pac, offs, rows,
                         lens, l_rep)
    assert sum(map(len, want)) >= 3
    assert _as_tuples(got) == _as_tuples(want)


@pytest.mark.parametrize("case", list(CASES))
def test_native_chain_matches_python(case):
    """The native batch call's chains (contig, weight, seeds, frac_rep, in
    filter order) equal the port's Python chains."""
    knobs, l_pac, offs, rows, lens, l_rep = CASES[case]()
    opt = MemOptions(**knobs)
    py = _python_chains(tchain, opt, l_pac, offs, rows, lens, l_rep)
    B = len(lens)
    bounds = np.searchsorted(rows[:, 0], np.arange(B + 1))
    skip = (lens < opt.min_seed_len).astype(np.uint8)
    cb = tchain.chain_filter_batch_native(opt, l_pac, offs, rows, bounds,
                                          skip)
    nat = cb.to_lists(B, l_rep, lens)
    assert len(nat) == len(py)
    for b, (cp, cn) in enumerate(zip(py, nat)):
        assert [(c.rid, c.w, c.frac_rep,
                 [(s.rbeg, s.qbeg, s.len) for s in c.seeds]) for c in cp] \
            == [(c.rid, c.w, c.frac_rep,
                 [(s.rbeg, s.qbeg, s.len) for s in c.seeds]) for c in cn], b
