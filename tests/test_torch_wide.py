"""The port's wide (>= 2^31) index layout against ``tpubwa``, forced on
small indexes as tests/test_wide_sharded.py does for the JAX package.

* ``DeviceIndex.from_host(wide=True)`` equals ``np.asarray`` of the JAX
  wide ``DeviceIndex`` field by field, also with a synthetic ``cp_hi``
  (as in ``test_cp_hi_roundtrip``) and under ``sa_stub``.
* Wide seeding equals the JAX wide seeding.
* SE and PE SAM on the forced wide layout (PE also with the sampled SA)
  equal the JAX package's, pinned in tests/golden/.

The JAX side runs under jax x64, switched on and off inside
``try``/``finally`` so that it cannot leak into another file.
"""
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_sam import GOLDEN_DIR, _build_fixture, _strip_pg  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def idx():
    """tests/test_wide_sharded.py's 30 kb index."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, 30000).astype(np.uint8)
    return FMIndex.build([Contig("c1", 30000, 0)], codes)


@pytest.mark.parametrize("case", ["full", "cp_hi", "sa_stub"])
def test_from_host_wide_matches_jax(idx, case):
    from tpubwa.ops.fm import DeviceIndex as JaxDI
    from tpubwa_torch.ops.fm import DeviceIndex

    ix = idx
    if case == "cp_hi":   # high count words as a >= 2^31 build has them
        ix = FMIndex.build([Contig("c1", 5000, 0)], np.random.default_rng(
            5).integers(0, 4, 5000).astype(np.uint8))
        ix.cp_hi = np.ones((ix.cp.shape[0], 4), np.int32)
    stub = case == "sa_stub"
    jax.config.update("jax_enable_x64", True)
    try:
        jdi = JaxDI.from_host(ix, wide=True, sa_stub=stub)
        want = {k: np.asarray(getattr(jdi, k)) for k in jdi._fields}
    finally:
        jax.config.update("jax_enable_x64", False)
    got = DeviceIndex.from_host(ix, "cpu", wide=True, sa_stub=stub)
    for k in ("cp", "sa", "L2"):
        g = getattr(got, k).numpy()
        assert g.dtype == np.int64 == want[k].dtype, k
        np.testing.assert_array_equal(g, want[k])
    np.testing.assert_array_equal(got.pac_words.numpy(),
                                  want["pac_words"].view(np.int32))
    assert (got.primary, got.l_pac) == (int(want["primary"]),
                                        int(want["l_pac"]))
    if case == "cp_hi":
        assert (got.cp[1:, 0:4] >= 1 << 32).all()
    # from_numpy carries the JAX state across unchanged
    other = DeviceIndex.from_numpy(want, "cpu")
    for k in ("cp", "sa", "pac_words", "L2"):
        assert torch.equal(getattr(other, k), getattr(got, k)), k


def test_wide_seeding_matches_jax(idx):
    from tpubwa.ops.fm import DeviceIndex as JaxDI
    from tpubwa.ops.seeds import seed_rows as jax_seed_rows
    from tpubwa.ops.smem_chain import collect_smems_chain as jax_collect
    from tpubwa.utils import sim
    from tpubwa.utils.dna import encode
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.ops.seeds import seed_rows
    from tpubwa_torch.ops.smem_chain import collect_smems_chain

    reads = sim.simulate_reads(idx.fetch_ref(0, idx.l_pac),
                               [Contig("c1", 30000, 0)], 64, length=100,
                               err=0.02, seed=3)
    codes = np.full((64, 128), 4, np.int32)
    lens = np.zeros(64, np.int32)
    for i, (_, seq, _) in enumerate(reads):
        c = encode(seq)
        codes[i, :len(c)] = c
        lens[i] = len(c)
    opt = MemOptions()
    kw = dict(min_seed_len=opt.min_seed_len, split_len=opt.split_len,
              split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
              out_cap=opt.max_smems_per_read)
    skw = dict(max_occ=opt.max_occ, per_read_cap=opt.max_seeds_per_read)
    jax.config.update("jax_enable_x64", True)
    try:
        jdi = JaxDI.from_host(idx, wide=True)
        jsm = jax_collect(jdi, jnp.asarray(codes), jnp.asarray(lens), **kw)
        jcs = jax_seed_rows(jdi, jsm, **skw)
        n = int(jcs.n)
        want_rows = np.asarray(jcs.packed)[:n]
        want_sm = [np.asarray(x) for x in jsm]
        want_rep = np.asarray(jcs.l_rep)
    finally:
        jax.config.update("jax_enable_x64", False)
    di = DeviceIndex.from_host(idx, "cpu", wide=True)
    sm = collect_smems_chain(di, torch.as_tensor(codes),
                             torch.as_tensor(lens), **kw)
    cs = seed_rows(di, sm, **skw)
    assert cs.packed.dtype == torch.int64
    assert int(cs.n) == n > 100
    np.testing.assert_array_equal(cs.packed[:n].numpy(), want_rows)
    np.testing.assert_array_equal(cs.l_rep.numpy(), want_rep)
    n_sm = sm.n.numpy()
    np.testing.assert_array_equal(n_sm, want_sm[5])
    used = np.arange(opt.max_smems_per_read)[None, :] < n_sm[:, None]
    g = np.stack([f.numpy() for f in sm[:5]], axis=-1)       # [B, M, 5]
    assert g.dtype == np.int64
    np.testing.assert_array_equal(g[used], np.stack(want_sm[:5], -1)[used])


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return _build_fixture(str(tmp_path_factory.mktemp("golden_wide")))


@pytest.mark.parametrize("kind,shift", [("se", 0), ("pe", 0), ("pe", 4)])
def test_wide_sam_matches_jax_golden(golden, kind, shift):
    """tests/golden/{se,pe}.sam are the JAX package's output on the
    golden fixture; the port on the forced wide layout writes them byte
    for byte (and so does the wide layout with the sampled SA)."""
    from tpubwa.io.sam import sam_header
    from tpubwa_torch.align.pair import align_pe_fastq
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline
    from tpubwa_torch.ops.fm import DeviceIndex, build_sampled_sa

    ref, se_fq, fq1, fq2 = golden
    idx = FMIndex.load(ref)
    al = Aligner(idx, MemOptions(batch_reads=64, sa_sample_shift=shift),
                 device="cpu")
    al.di = DeviceIndex.from_host(idx, "cpu", wide=True, sa_stub=bool(shift))
    if shift:
        al.ss = build_sampled_sa(None, shift, True, idx=idx, device="cpu")
    assert al.di.cp.dtype == al.di.sa.dtype == torch.int64
    out = io.StringIO()
    out.write(sam_header(idx.contigs, "test", "0"))
    if kind == "se":
        run_se_pipeline(al, se_fq, out)
    else:
        assert align_pe_fastq(al, fq1, fq2, out) == 0
    with open(os.path.join(GOLDEN_DIR, f"{kind}.sam")) as f:
        assert _strip_pg(out.getvalue()) == f.read()
