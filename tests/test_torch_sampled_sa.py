"""The port's sampled suffix array against ``tpubwa.ops.fm``.

* ``build_sampled_sa`` gives the JAX build's ``blocks`` and ``vals``
  (shifts 2 and 4, narrow and wide).
* The plain ``sa_lookup_sampled`` equals the JAX one and the full SA over
  every row of tests/test_sampled_sa.py's 60 kb repeat genome.
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
    for got in (build_sampled_sa(None, shift, wide, idx=idx),
                build_sampled_sa(idx.sa, shift, wide)):
        for k in ("blocks", "vals"):
            g = getattr(got, k).numpy()
            assert g.dtype == want[k].dtype, k
            np.testing.assert_array_equal(g, want[k])
    if wide:   # some mask words have bit 31 set: stored negative
        assert (want["blocks"][:, 1:3] < 0).any()


@pytest.mark.parametrize("shift,wide", [(2, False), (4, False), (4, True)])
def test_lookup_every_row_matches_jax_and_full_sa(fixture, shift, wide):
    from tpubwa.ops.fm import (DeviceIndex as JaxDI, SampledSA as JaxSS,
                               sa_lookup_sampled as jax_lookup)
    from tpubwa_torch.ops.fm import DeviceIndex, SampledSA
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core

    _, _, idx = fixture
    di_np, ss_np = _jax_state(idx, shift, wide)
    rows = np.arange(idx.sa_ls.shape[0],
                     dtype=np.int64 if wide else np.int32)
    if wide:
        jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(jax_lookup(
            JaxDI(**{k: jnp.asarray(v) for k, v in di_np.items()}),
            JaxSS(**{k: jnp.asarray(v) for k, v in ss_np.items()}),
            jnp.asarray(rows), shift))
    finally:
        jax.config.update("jax_enable_x64", False)
    di = DeviceIndex.from_numpy(di_np, "cpu")
    ss = SampledSA.from_numpy(ss_np, "cpu")
    got = sa_lookup_sampled_core(di, ss, torch.as_tensor(rows), shift)
    assert got.dtype == (torch.int64 if wide else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), idx.sa)


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
                    ss=build_sampled_sa(None, shift, False, idx=idx),
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
