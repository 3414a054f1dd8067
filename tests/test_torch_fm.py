"""The port's FM-index primitives against ``tpubwa.ops.fm``: occ4,
ext_core and set_intv on random rows (including the primary row and both
ends of the text), the reference-window gathers on both strands, and the
SWAR popcount."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dis():
    from tpubwa.ops.fm import DeviceIndex as JaxDI
    from tpubwa_torch.ops.fm import DeviceIndex

    rng = np.random.default_rng(42)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    idx = FMIndex.build([Contig("c1", 3000, 0)], codes)
    jdi = JaxDI.from_host(idx)
    tdi = DeviceIndex.from_host(idx, "cpu")
    return idx, jdi, tdi


def _rows(rng, idx, n):
    N = idx.seq_len
    p = idx.primary
    edge = np.array([0, 1, p - 1, p, p + 1, N - 1, N, N + 1])
    return np.concatenate([edge[(edge >= 0) & (edge <= N + 1)],
                           rng.integers(0, N + 2, n)]).astype(np.int32)


def test_from_numpy_equals_from_host(dis):
    from tpubwa_torch.ops.fm import DeviceIndex

    idx, jdi, tdi = dis
    other = DeviceIndex.from_numpy(
        {k: np.asarray(getattr(jdi, k)) for k in jdi._fields}, "cpu")
    for k in ("cp", "sa", "pac_words", "L2"):
        assert torch.equal(getattr(other, k), getattr(tdi, k)), k
    assert (other.primary, other.l_pac) == (tdi.primary, tdi.l_pac) == (
        idx.primary, idx.l_pac)


def test_popcount32():
    from tpubwa_torch.ops.fm import popcount32

    rng = np.random.default_rng(1)
    x = np.concatenate([[0, 1, 0xFFFFFFFF, 0x80000000, 0x55555555],
                        rng.integers(0, 1 << 32, 2000, dtype=np.uint64)])
    want = np.array([bin(int(v)).count("1") for v in x])
    got = popcount32(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_occ4_matches_jax(dis):
    from tpubwa.ops.fm import occ4 as jax_occ4
    from tpubwa_torch.ops.fm import occ4

    idx, jdi, tdi = dis
    i = _rows(np.random.default_rng(2), idx, 3000).reshape(-1, 8)
    want = np.asarray(jax_occ4(jdi.cp, jdi.primary, jnp.asarray(i)))
    got = occ4(tdi.cp, tdi.primary, torch.as_tensor(i)).numpy()
    np.testing.assert_array_equal(got, want)
    # and against the host index's scalar occ
    for r in i.reshape(-1)[:200]:
        assert [idx.occ_full(c, int(r)) for c in range(4)] == list(
            got.reshape(-1, 4)[list(i.reshape(-1)).index(r)])


def test_ext_core_and_set_intv_match_jax(dis):
    from tpubwa.ops.fm import ext_core as jax_ext, set_intv as jax_set
    from tpubwa_torch.ops.fm import ext_core, set_intv

    idx, jdi, tdi = dis
    rng = np.random.default_rng(3)
    N = idx.seq_len
    kk = _rows(rng, idx, 2000)
    kk = np.minimum(kk, N)
    s = rng.integers(0, 60, kk.size).astype(np.int32)
    s[::7] = 1
    s = np.minimum(s, N + 1 - kk).astype(np.int32)
    ll = rng.integers(0, N + 1, kk.size).astype(np.int32)
    want = jax_ext(jdi, jnp.asarray(kk), jnp.asarray(ll), jnp.asarray(s))
    got = ext_core(tdi, torch.as_tensor(kk), torch.as_tensor(ll),
                   torch.as_tensor(s))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    c = np.array([-1, 0, 1, 2, 3, 4, 5], np.int32)
    for w, g in zip(jax_set(jdi, jnp.asarray(c)),
                    set_intv(tdi, torch.as_tensor(c))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("T", [768, 37])
def test_ref_windows_match_jax(dis, T):
    from tpubwa.ops.fm import (ref_window_left as jax_left,
                               ref_window_right as jax_right)
    from tpubwa_torch.ops.fm import ref_window_left, ref_window_right

    idx, jdi, tdi = dis
    rng = np.random.default_rng(T)
    lp = idx.l_pac
    pos = np.concatenate([[0, 1, 15, 16, 17, lp - 1, lp, lp + 1,
                           2 * lp - 1, 2 * lp],
                          rng.integers(0, 2 * lp + 1, 500)]).astype(np.int64)
    for jf, tf in ((jax_left, ref_window_left),
                   (jax_right, ref_window_right)):
        want = np.asarray(jf(jdi, jnp.asarray(pos), T))
        got = tf(tdi, torch.as_tensor(pos), T).numpy()
        np.testing.assert_array_equal(got, want)
    if T % 16:
        return   # the phase shift leaves a garbage tail: T is 16k in use
    # strand-valid slots hold the real reference
    text = np.concatenate([idx.fetch_ref(0, lp), idx.fetch_ref(lp, 2 * lp)])
    got = ref_window_right(tdi, torch.as_tensor(pos), T).numpy()
    for r, p in enumerate(pos[:200]):
        end = lp if p < lp else 2 * lp
        n = int(min(T, end - p))
        np.testing.assert_array_equal(got[r, :n], text[p:p + n])
