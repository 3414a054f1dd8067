"""The port's sampled suffix array against ``tpubwa.ops.fm``.

* ``build_sampled_sa`` gives the JAX build's ``blocks`` and ``vals``
  (shifts 2 and 4, narrow and wide).
* The plain ``sa_lookup_sampled`` equals the JAX one and the full SA over
  every row of tests/test_sampled_sa.py's 60 kb repeat genome, and on the
  edge rows of ``utils.sim.sa_edge_rows``; with a count of live rows, the
  rows past it are 0.
* ``seed_rows`` with a sampled SA equals the JAX ``seed_rows`` with one.
* The SE SAM with ``sa_sample_shift=4`` equals the JAX package's.

The JAX side of a wide case runs under jax x64, switched on and off
inside ``try``/``finally`` so that it cannot leak into another file.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig
from tpubwa.utils import sim
from tpubwa.utils.dna import decode

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """tests/test_sampled_sa.py's genome (repeat_genome, seed 99) and
    reads (seed 3), 96 of them."""
    from tpubwa.utils.gensim import repeat_genome

    d = tmp_path_factory.mktemp("t_sampled_sa")
    codes = repeat_genome(np.random.default_rng(99), 60_000)
    ref = str(d / "ref.fa")
    with open(ref, "w") as f:
        f.write(">c1\n" + decode(codes) + "\n")
    idx = FMIndex.from_fasta(ref)
    idx.save(ref)
    fq = str(d / "reads.fq")
    sim.write_fastq(fq, sim.simulate_reads(
        codes, [Contig("c1", 60_000, 0)], 96, length=150, err=0.02, seed=3))
    return ref, fq, idx


def _jax_state(idx, shift, wide):
    """numpy copies of the JAX DeviceIndex and SampledSA."""
    from tpubwa.ops.fm import DeviceIndex, build_sampled_sa

    if wide:
        jax.config.update("jax_enable_x64", True)
    try:
        di = DeviceIndex.from_host(idx, wide=wide)
        ss = build_sampled_sa(idx.sa, shift, wide=wide)
        return ({k: np.asarray(getattr(di, k)) for k in di._fields},
                {k: np.asarray(getattr(ss, k)) for k in ss._fields})
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("shift,wide", [(2, False), (4, False), (2, True),
                                        (4, True)])
def test_build_matches_jax(fixture, shift, wide):
    from tpubwa_torch.ops.fm import build_sampled_sa

    _, _, idx = fixture
    _, want = _jax_state(idx, shift, wide)
    for got in (build_sampled_sa(None, shift, wide, idx=idx, device="cpu"),
                build_sampled_sa(idx.sa, shift, wide, device="cpu")):
        for k in ("blocks", "vals"):
            g = getattr(got, k).numpy()
            assert g.dtype == want[k].dtype, k
            np.testing.assert_array_equal(g, want[k])
    if wide:   # some mask words have bit 31 set: stored negative
        assert (want["blocks"][:, 1:3] < 0).any()


def _jax_lookup(idx, shift, wide, rows):
    """(the JAX ``sa_lookup_sampled`` of `rows`, the port's DeviceIndex
    and SampledSA on the CPU, made from the JAX package's arrays)."""
    from tpubwa.ops.fm import (DeviceIndex as JaxDI, SampledSA as JaxSS,
                               sa_lookup_sampled as jax_lookup)
    from tpubwa_torch.ops.fm import DeviceIndex, SampledSA

    di_np, ss_np = _jax_state(idx, shift, wide)
    if wide:
        jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(jax_lookup(
            JaxDI(**{k: jnp.asarray(v) for k, v in di_np.items()}),
            JaxSS(**{k: jnp.asarray(v) for k, v in ss_np.items()}),
            jnp.asarray(rows), shift))
    finally:
        jax.config.update("jax_enable_x64", False)
    return (want, DeviceIndex.from_numpy(di_np, "cpu"),
            SampledSA.from_numpy(ss_np, "cpu"))


@pytest.mark.parametrize("shift,wide", [(2, False), (4, False), (4, True)])
def test_lookup_every_row_matches_jax_and_full_sa(fixture, shift, wide):
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core

    _, _, idx = fixture
    rows = np.arange(idx.sa_ls.shape[0],
                     dtype=np.int64 if wide else np.int32)
    want, di, ss = _jax_lookup(idx, shift, wide, rows)
    got = sa_lookup_sampled_core(di, ss, torch.as_tensor(rows), shift)
    assert got.dtype == (torch.int64 if wide else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), idx.sa)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("shift", [0, 1, 5])
def test_lookup_edge_rows_match_jax_and_full_sa(fixture, shift, wide):
    """``utils.sim.sa_edge_rows``: the longest walks, the primary row and
    its neighbours, rows 0 and N, the 64-row blocks' word edges, a count
    that is a multiple of no block size, and one row alone."""
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core
    from tpubwa_torch.utils.sim import SA_EDGE_ROWS, sa_edge_rows

    _, _, idx = fixture
    rows = sa_edge_rows(idx, shift).astype(np.int64 if wide else np.int32)
    n, intv = idx.sa.size, 1 << shift
    assert rows.size == SA_EDGE_ROWS and SA_EDGE_ROWS % 32
    assert {0, n - 1, idx.primary - 1, idx.primary,
            idx.primary + 1} <= set(rows.tolist())
    assert (idx.sa[rows] % intv == intv - 1).sum() >= min(
        1000, (idx.sa % intv == intv - 1).sum())
    assert set((rows & 63).tolist()) >= {0, 31, 32, 63}
    want, di, ss = _jax_lookup(idx, shift, wide, rows)
    got = sa_lookup_sampled_core(di, ss, torch.as_tensor(rows), shift)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), idx.sa[rows])
    one = sa_lookup_sampled_core(di, ss, torch.as_tensor(rows[:1]), shift)
    np.testing.assert_array_equal(one.numpy(), want[:1])


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_lookup_live_rows(fixture, wide):
    """With a count of live rows (a tensor, as ``seed_rows`` passes
    ``n_total``) the rows below it equal the JAX function and the rest are
    0; without one, every row is looked up."""
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core
    from tpubwa_torch.utils.sim import sa_edge_rows

    _, _, idx = fixture
    shift = 4
    rows = sa_edge_rows(idx, shift).astype(np.int64 if wide else np.int32)
    want, di, ss = _jax_lookup(idx, shift, wide, rows)
    r = torch.as_tensor(rows)
    np.testing.assert_array_equal(
        sa_lookup_sampled_core(di, ss, r, shift).numpy(), want)
    for live in (0, 1, 1000, rows.size, rows.size + 9):
        got = sa_lookup_sampled_core(
            di, ss, r, shift, n_live=torch.tensor(live, dtype=torch.int32)
        ).numpy()
        k = min(live, rows.size)
        np.testing.assert_array_equal(got[:k], want[:k])
        assert (got[k:] == 0).all()


def test_seed_rows_with_sampled_sa_matches_jax(fixture):
    from tpubwa.ops.fm import (DeviceIndex as JaxDI,
                               build_sampled_sa as jax_build)
    from tpubwa.ops.seeds import seed_rows as jax_seed_rows
    from tpubwa.ops.smem_chain import collect_smems_chain as jax_collect
    from tpubwa.utils.dna import encode
    from tpubwa_torch.ops.fm import DeviceIndex, build_sampled_sa
    from tpubwa_torch.ops.seeds import seed_rows
    from tpubwa_torch.ops.smem_chain import collect_smems_chain

    ref, fq, idx = fixture
    from tpubwa.io.fastq import read_fastq

    reads = list(read_fastq(fq))[:64]
    codes = np.full((64, 160), 4, np.int32)
    lens = np.zeros(64, np.int32)
    for i, r in enumerate(reads):
        c = encode(r.seq)
        codes[i, :len(c)] = c
        lens[i] = len(c)
    opt = MemOptions()
    kw = dict(min_seed_len=opt.min_seed_len, split_len=opt.split_len,
              split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
              out_cap=opt.max_smems_per_read)
    shift = 4
    jdi = JaxDI.from_host(idx, sa_stub=True)
    jsm = jax_collect(jdi, jnp.asarray(codes), jnp.asarray(lens), **kw)
    want = jax_seed_rows(jdi, jsm, max_occ=opt.max_occ,
                         per_read_cap=opt.max_seeds_per_read,
                         ss=jax_build(idx.sa, shift, wide=False),
                         sa_shift=shift)
    di = DeviceIndex.from_host(idx, "cpu", sa_stub=True)
    assert di.sa.shape == (1,)
    sm = collect_smems_chain(di, torch.as_tensor(codes),
                             torch.as_tensor(lens), **kw)
    got = seed_rows(di, sm, max_occ=opt.max_occ,
                    per_read_cap=opt.max_seeds_per_read,
                    ss=build_sampled_sa(None, shift, False, idx=idx,
                                        device="cpu"),
                    sa_shift=shift)
    n = int(want.n)
    assert int(got.n) == n > 100
    np.testing.assert_array_equal(got.packed[:n].numpy(),
                                  np.asarray(want.packed)[:n])
    np.testing.assert_array_equal(got.l_rep.numpy(), np.asarray(want.l_rep))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))


def test_se_sam_with_sa_shift_matches_jax(fixture):
    from tpubwa.align.pipeline import Aligner as JaxAligner
    from tpubwa.align.pipeline import run_se_pipeline as jax_run
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline

    ref, fq, idx = fixture
    opt = dict(batch_reads=96, sa_sample_shift=4)
    want = io.StringIO()
    jax_run(JaxAligner(idx, MemOptions(**opt)), fq, want)
    al = Aligner(idx, MemOptions(**opt), device="cpu")
    assert al.di.sa.shape == (1,) and al.ss is not None
    got = io.StringIO()
    run_se_pipeline(al, fq, got)
    assert got.getvalue().count("\n") >= 96
    assert got.getvalue() == want.getvalue()
