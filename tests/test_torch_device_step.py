"""The port's fused device step and its pieces against the JAX package.

* ``device_align_step`` (SMEMs, ``smems_to_seeds`` at 64 slots, the
  longest seed of each read, its right window by ``fetch_ref_batch``, one
  ``extend_batch``) against ``tpubwa.parallel.mesh.device_align_step`` on
  the inputs of ``__graft_entry__._tiny_fixture`` (16 reads of 48 bp on a
  4 kb genome, made here the same way), in the narrow and the forced wide
  layout.  The JAX step does not run on its wide layout (its l_rep scan in
  ``tpubwa/ops/seeds.py:84`` carries int32 while the wide SMEMs' starts
  are int64), so the port's wide step and wide seed expansion are held to
  the JAX narrow results: the layout changes no value here;
* ``sharded_align_step`` over 4 CPU shards against one device;
* ``smems_to_seeds`` (with stride sampling, seed-cap overflow and l_rep),
  ``compact_seeds`` (and its rows against ``seed_rows``),
  ``fetch_ref_batch`` (positions out of range and on the reverse strand,
  narrow and wide) and ``backward_ext_all`` against the JAX functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubwa_torch.config import MemOptions
from tpubwa_torch.index.fmindex import FMIndex
from tpubwa_torch.io.fasta import Contig

torch.set_num_threads(1)

MAT = MemOptions().score_matrix()


def _tiny_fixture(b=16, l=48, ref_len=4000):
    """``__graft_entry__._tiny_fixture``'s index and reads."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, ref_len).astype(np.uint8)
    idx = FMIndex.build([Contig("c1", ref_len, 0)], codes)
    reads = np.zeros((b, l), dtype=np.int32)
    for i in range(b):
        p = int(rng.integers(0, ref_len - l))
        reads[i] = codes[p:p + l]
        if i % 3 == 1:  # errors, so that the DP path is live
            reads[i, l // 2] = (reads[i, l // 2] + 1) % 4
    return idx, reads, np.full(b, l, dtype=np.int32)


def _jax_di(idx, wide):
    from tpubwa.ops.fm import DeviceIndex as JaxDI

    return JaxDI.from_host(idx, wide=wide)


class _x64:
    """The JAX package's int64 layout needs its process-wide x64 mode."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        jax.config.update("jax_enable_x64", self.on)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


_want: dict = {}


def _jax_step():
    from tpubwa.parallel.mesh import device_align_step as jax_step

    if not _want:
        idx, reads, lens = _tiny_fixture()
        out = jax_step(_jax_di(idx, False), jnp.asarray(reads),
                       jnp.asarray(lens), jnp.asarray(MAT))
        _want["narrow"] = [np.asarray(x) for x in out]
    return _want["narrow"]


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_device_align_step_matches_jax(wide):
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.parallel.mesh import device_align_step

    idx, reads, lens = _tiny_fixture()
    di = DeviceIndex.from_host(idx, "cpu", wide=wide)
    got = device_align_step(di, torch.as_tensor(reads),
                            torch.as_tensor(lens), MAT)
    want = _jax_step()
    assert got[0].dtype == (torch.int64 if wide else torch.int32)
    for name, g, w in zip(("rbeg", "qbeg", "len", "valid", "score"), got,
                          want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (want[4] > 0).all() and len(set(want[4].tolist())) > 1


def test_sharded_align_step_matches_one_device():
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.parallel.mesh import (device_align_step, make_mesh,
                                            sharded_align_step)

    idx, reads, lens = _tiny_fixture()
    di = DeviceIndex.from_host(idx, "cpu")
    one = device_align_step(di, torch.as_tensor(reads),
                            torch.as_tensor(lens), MAT)
    # 16 reads over 4 shards, and 14 (the last shard shorter)
    for n in (16, 14):
        got = sharded_align_step(make_mesh(4, "cpu"), di, reads[:n],
                                 lens[:n], MAT)
        for g, w in zip(got, one):
            assert torch.equal(g, w[:n])


def test_device_align_step_argmax_takes_first_of_equals():
    """Reads X + N + Y of two 40-mers, X at two places of the genome:
    three seeds of length 40 tie, and the step extends from the first
    slot (``jnp.argmax``'s and ``torch.argmax``'s rule), exactly as the
    JAX step does."""
    from tpubwa.parallel.mesh import device_align_step as jax_step
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.parallel.mesh import device_align_step

    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 12_000).astype(np.uint8)
    reads = np.full((8, 81), 4, np.int32)
    for i in range(8):
        x, y = 300 + 400 * i, 7000 + 400 * i
        codes[x + 3400:x + 3440] = codes[x:x + 40]      # X twice
        reads[i, :40] = codes[x:x + 40]
        reads[i, 41:] = codes[y:y + 40]
    idx = FMIndex.build([Contig("c1", codes.size, 0)], codes)
    lens = np.full(8, 81, np.int32)
    got = device_align_step(DeviceIndex.from_host(idx, "cpu"),
                            torch.as_tensor(reads), torch.as_tensor(lens),
                            MAT)
    want = jax_step(_jax_di(idx, False), jnp.asarray(reads),
                    jnp.asarray(lens), jnp.asarray(MAT))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # X's two hits and Y's one are the longest; round 3's [0, 20) of X
    # comes first
    slen = torch.where(got[3], got[2], 0)
    assert ((slen == 40).sum(dim=1) == 3).all()
    assert (slen.max(dim=1).values == 40).all()


_smems: dict = {}


def _repeat_smems():
    """A repeat genome's index and the JAX package's SMEMs of 48 reads
    (narrow layout; made once)."""
    from tpubwa.ops.smem_chain import collect_smems_chain
    from tpubwa_torch.utils.dna import encode
    from tpubwa_torch.utils.gensim import repeat_genome
    from tpubwa_torch.utils.sim import simulate_reads

    if not _smems:
        codes = repeat_genome(np.random.default_rng(2), 40_000)
        contigs = [Contig("c1", codes.size, 0)]
        idx = FMIndex.build(contigs, codes)
        reads = simulate_reads(codes, contigs, 48, length=100, err=0.01,
                               seed=5)
        q = np.full((48, 112), 4, np.int32)
        lens = np.zeros(48, np.int32)
        for i, (_, seq, _) in enumerate(reads):
            q[i, :len(seq)] = encode(seq)
            lens[i] = len(seq)
        jdi = _jax_di(idx, False)
        _smems.update(idx=idx, jdi=jdi, sm=collect_smems_chain(
            jdi, jnp.asarray(q), jnp.asarray(lens)))
    return _smems["idx"], _smems["jdi"], _smems["sm"]


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_smems_to_seeds_and_compact_match_jax(wide):
    from tpubwa.ops.seeds import compact_seeds as jax_compact
    from tpubwa.ops.seeds import smems_to_seeds as jax_s2s
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.ops.seeds import (compact_seeds, seed_rows,
                                        smems_to_seeds)
    from tpubwa_torch.ops.smem import Smems

    idx, jdi, jsm = _repeat_smems()
    # the port's wide layout carries the intervals as int64
    sm = Smems(*(torch.as_tensor(np.array(f)) for f in jsm))
    if wide:
        sm = sm._replace(**{f: getattr(sm, f).long()
                            for f in ("k", "l", "s", "start", "end")})
    di = DeviceIndex.from_host(idx, "cpu", wide=wide)
    for max_occ, S in ((500, 64), (3, 8)):     # the step's; caps that bite
        jsb = jax_s2s(jdi, jsm, max_occ=max_occ, out_seeds=S)
        want = [np.asarray(f) for f in jsb]
        jcs = jax_compact(jsb)
        want_rows = np.asarray(jcs.packed)[:int(jcs.n)]
        sb = smems_to_seeds(di, sm, max_occ=max_occ, out_seeds=S)
        for name, g, w in zip(sb._fields, sb, want):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        cs = compact_seeds(sb)
        n = int(cs.n)
        np.testing.assert_array_equal(cs.packed[:n].numpy(), want_rows)
        assert not cs.packed[n:].any()
        if S == 8:
            assert sb.overflow.any() and (sb.l_rep > 0).any()
        else:
            # no read hit a cap: the rows are seed_rows' rows
            assert not sb.overflow.any()
            sr = seed_rows(di, sm, max_occ=max_occ, per_read_cap=S)
            assert torch.equal(cs.packed[:n], sr.packed[:int(sr.n)])
            assert torch.equal(cs.l_rep, sr.l_rep)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_fetch_ref_batch_matches_jax(wide):
    from tpubwa.ops.fm import fetch_ref_batch as jax_fetch
    from tpubwa_torch.ops.fm import DeviceIndex, fetch_ref_batch

    idx, _, _ = _tiny_fixture()
    n2 = 2 * idx.l_pac
    rng = np.random.default_rng(1)
    dt = np.int64 if wide else np.int32
    pos = np.concatenate([
        np.arange(-20, 20), np.arange(idx.l_pac - 20, idx.l_pac + 20),
        np.arange(n2 - 20, n2 + 20), rng.integers(-100, n2 + 100, 400),
    ]).astype(dt).reshape(-1, 20)
    with _x64(wide):
        want = np.asarray(jax_fetch(_jax_di(idx, wide), jnp.asarray(pos)))
    got = fetch_ref_batch(DeviceIndex.from_host(idx, "cpu", wide=wide),
                          torch.as_tensor(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    # the host's own reference on the strands, 4 out of range
    flat = pos.reshape(-1)
    ok = (flat >= 0) & (flat < n2)
    assert (got.numpy().reshape(-1)[~ok] == 4).all()
    host = np.array([idx.fetch_ref(int(p), int(p) + 1)[0] for p in flat[ok]])
    np.testing.assert_array_equal(got.numpy().reshape(-1)[ok], host)


@pytest.mark.parametrize("is_back", [True, False], ids=["back", "forward"])
def test_backward_ext_all_matches_jax(is_back):
    from tpubwa.ops.fm import BiInterval as JaxBi
    from tpubwa.ops.fm import backward_ext_all as jax_ext
    from tpubwa_torch.ops.fm import BiInterval, DeviceIndex, backward_ext_all

    idx, _, _ = _tiny_fixture()
    N = idx.seq_len
    rng = np.random.default_rng(6)
    k = rng.integers(0, N + 1, 300).astype(np.int32)
    s = np.minimum(rng.integers(0, 60, 300), N + 1 - k).astype(np.int32)
    l = np.minimum(rng.integers(0, N + 1, 300), N + 1 - s).astype(np.int32)
    k[:3] = [0, idx.primary, N]      # the sentinel row inside the interval
    s[:3] = [N + 1, 1, 1]
    l[:3] = [0, idx.primary, N]
    want = jax_ext(_jax_di(idx, False),
                   JaxBi(*(jnp.asarray(a) for a in (k, l, s))), is_back)
    got = backward_ext_all(DeviceIndex.from_host(idx, "cpu"),
                           BiInterval(*(torch.as_tensor(a)
                                        for a in (k, l, s))), is_back)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
