"""Values at and above 2^31 in the wide layout, port against ``tpubwa``.

``utils.sim.high_word_index`` makes a synthetic wide index from a small
one: occ counts and SA values carry 2^31 + 12,345 (the sign bit of their
low words set) and ``L2`` carries minus that, so LF steps land on real
rows.  On the same numpy arrays the port's plain ``occ4``, ``ext_core``,
``lf_step`` and ``sa_lookup_sampled`` (CPU) equal the JAX package's, and
each equals the function on the small index with the offset put back:
occ counts and looked-up positions are the small index's plus the offset,
``ext_core``'s intervals and ``lf_step``'s rows are the small index's.
``chip_smoke.py`` phase 11(g) runs K5 on such arrays on the card.  K2
does not run on them: it starts each interval at ``L2[c]``, which these
arrays lower by the offset, so its rows would be negative.  Phase 11(g)
runs K2 on the same index with every row moved up past 2^31 instead, and
``chip_big.py`` on the 1.2 Gbp index, whose rows pass 2^31.

The JAX side runs under jax x64, switched on and off inside
``try``/``finally`` so that it cannot leak into another file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubwa_torch.index.fmindex import FMIndex
from tpubwa_torch.io.fasta import Contig
from tpubwa_torch.ops import fm
from tpubwa_torch.utils.sim import HIGH_WORD, high_word_index

torch.set_num_threads(1)
SHIFT = 5


@pytest.fixture(scope="module")
def case():
    codes = np.random.default_rng(21).integers(0, 4, 30_000).astype(np.uint8)
    idx = FMIndex.build([Contig("c1", 30_000, 0)], codes)
    arrays = high_word_index(idx, SHIFT)
    return idx, arrays


def _jax_tables(arrays):
    from tpubwa.ops.fm import DeviceIndex as JaxDI
    from tpubwa.ops.fm import SampledSA as JaxSS

    di = JaxDI(cp=jnp.asarray(arrays["cp"]), sa=jnp.asarray(arrays["sa"]),
               pac_words=jnp.asarray(arrays["pac_words"].view(np.uint32)),
               L2=jnp.asarray(arrays["L2"]),
               primary=jnp.int64(arrays["primary"]),
               l_pac=jnp.int64(arrays["l_pac"]))
    return di, JaxSS(blocks=jnp.asarray(arrays["blocks"]),
                     vals=jnp.asarray(arrays["vals"]))


def _queries(idx, fn):
    """Inputs of `fn` (int64 numpy arrays) on the small index's rows."""
    rng = np.random.default_rng(4)
    n = idx.seq_len + 1                                  # rows 0 .. N
    if fn == "occ4":
        return (np.arange(n + 1, dtype=np.int64),)       # i in [0, N+1]
    if fn == "ext_core":
        kk = rng.integers(0, n, 20_000)
        s = rng.integers(0, n + 1 - kk)
        return kk, rng.integers(0, n + 1 - s), s
    rows = np.arange(n, dtype=np.int64)
    if fn == "lf_step":                                  # sa[r] > 0
        return (rows[idx.sa != 0],)
    return (rows,)


def _call(mod, fn, di, ss, args):
    if fn == "occ4":
        return mod.occ4(di.cp, di.primary, *args)
    if fn == "ext_core":
        return mod.ext_core(di, *args)
    if fn == "lf_step":
        return mod.lf_step(di, *args)
    return mod.sa_lookup_sampled(di, ss, *args, SHIFT)


@pytest.mark.parametrize("fn", ["occ4", "ext_core", "lf_step",
                                "sa_lookup_sampled"])
def test_high_words_match_jax(case, fn):
    import tpubwa.ops.fm as jfm

    idx, arrays = case
    assert (arrays["cp"][:, 0:4] >= 1 << 31).all()
    assert (arrays["cp"][:, 0:4] < 1 << 32).all()
    assert (arrays["vals"] >= 1 << 31).all()
    di = fm.DeviceIndex.from_numpy(arrays, "cpu")
    ss = fm.SampledSA.from_numpy(arrays, "cpu")
    args = _queries(idx, fn)
    got = _call(fm, fn, di, ss, [torch.as_tensor(a) for a in args])
    got = [t.numpy() for t in (got if isinstance(got, tuple) else (got,))]
    jax.config.update("jax_enable_x64", True)
    try:
        jdi, jss = _jax_tables(arrays)
        want = _call(jfm, fn, jdi, jss, [jnp.asarray(a) for a in args])
        want = [np.asarray(w) for w in (want if isinstance(want, tuple)
                                        else (want,))]
    finally:
        jax.config.update("jax_enable_x64", False)
    for g, w in zip(got, want):
        assert g.dtype == np.int64 == w.dtype
        np.testing.assert_array_equal(g, w)

    # the small index's answers, the offset put back where it shows
    small = fm.DeviceIndex.from_host(idx, "cpu", wide=True)
    sss = fm.build_sampled_sa(None, SHIFT, True, idx=idx, device="cpu")
    base = _call(fm, fn, small, sss, [torch.as_tensor(a) for a in args])
    base = [t.numpy() for t in (base if isinstance(base, tuple)
                                else (base,))]
    shift_by = {"occ4": [HIGH_WORD], "ext_core": [0, 0, 0],
                "lf_step": [0], "sa_lookup_sampled": [HIGH_WORD]}[fn]
    for g, b, d in zip(got, base, shift_by):
        np.testing.assert_array_equal(g, b + d)
    if fn == "occ4":
        assert got[0].min() >= 1 << 31
    if fn == "sa_lookup_sampled":
        np.testing.assert_array_equal(got[0], idx.sa + HIGH_WORD)
