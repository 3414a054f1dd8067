"""The port's SMEM collection and seed expansion against the JAX package.

``collect_smems_chain``: slots < n of every Smems field, plus n and
overflow, on a random genome and on a repeat-structured one (bench.py's
``_repeat_genome`` recipe, small), including caps small enough to
overflow and several round-2 waves.  The port sorts with a stable sort
where the JAX package runs an unstable bitonic network, so tied
(start, end) keys must carry equal payloads.

``seed_rows``: packed[:n], n, l_rep and overflow, both packages fed the
same Smems.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig

torch.set_num_threads(1)

OPT = MemOptions()
B, L = 48, 160


def _repeat_genome(rng, ref_len):
    """bench.py's chr21-style recipe: segmental copies at ~2% divergence
    with an Alu-like element every ~3 kb."""
    n_seg, alu_len, alu_every = 8, 300, 3000
    seg_len = ref_len // n_seg
    base = rng.integers(0, 4, seg_len).astype(np.uint8)
    alu = rng.integers(0, 4, alu_len).astype(np.uint8)
    segs = []
    for _ in range(n_seg):
        seg = base.copy()
        mut = rng.random(seg_len) < 0.02
        seg[mut] = (seg[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        for p in range(alu_every, seg_len - alu_len, alu_every):
            a = alu.copy()
            m = rng.random(alu_len) < 0.10
            a[m] = (a[m] + rng.integers(1, 4, int(m.sum()))) % 4
            seg[p:p + alu_len] = a
        segs.append(seg)
    return np.concatenate(segs)[:ref_len]


def _setup(kind):
    from tpubwa.ops.fm import DeviceIndex as JaxDI
    from tpubwa.utils import sim
    from tpubwa.utils.dna import encode
    from tpubwa_torch.ops.fm import DeviceIndex

    rng = np.random.default_rng(7)
    n = 48_000
    codes = (rng.integers(0, 4, n).astype(np.uint8) if kind == "random"
             else _repeat_genome(rng, n))
    contigs = [Contig("c1", n, 0)]
    idx = FMIndex.build(contigs, codes)
    reads = sim.simulate_reads(codes, contigs, B, length=150, err=0.02,
                               indel=0.002, seed=3)
    q = np.full((B, L), 4, np.int32)
    lens = np.zeros(B, np.int32)
    for b, (_, seq, _) in enumerate(reads):
        ln = len(seq) - 5 * (b % 4)
        q[b, :ln] = encode(seq[:ln])
        lens[b] = ln
    q[5, 40:44] = 4                      # an N run
    lens[6] = 0                          # an empty row
    lens[7] = 12                         # shorter than min_seed_len
    return JaxDI.from_host(idx), DeviceIndex.from_host(idx, "cpu"), q, lens


@pytest.fixture(scope="module", params=["random", "repeat"])
def setup(request):
    return request.param, _setup(request.param)


CAPS = {"default": dict(out_cap=64, r2_cap=32, r2_lanes=None),
        "tiny": dict(out_cap=4, r2_cap=2, r2_lanes=16)}


@pytest.mark.parametrize("caps", ["default", "tiny"])
def test_collect_smems_chain_matches_jax(setup, caps):
    from tpubwa.ops.smem_chain import collect_smems_chain as jax_collect
    from tpubwa_torch.ops.smem_chain import collect_smems_chain

    kind, (jdi, tdi, q, lens) = setup
    kw = dict(min_seed_len=OPT.min_seed_len, split_len=OPT.split_len,
              split_width=OPT.split_width, max_mem_intv=OPT.max_mem_intv,
              **CAPS[caps])
    want = jax_collect(jdi, jnp.asarray(q), jnp.asarray(lens), **kw)
    got = collect_smems_chain(tdi, torch.as_tensor(q),
                              torch.as_tensor(lens), **kw)
    n = got.n.numpy()
    np.testing.assert_array_equal(n, np.asarray(want.n))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    used = np.arange(kw["out_cap"])[None, :] < n[:, None]
    g = np.stack([f.numpy() for f in got[:5]], axis=-1)     # [B, M, 5]
    w = np.stack([np.asarray(f) for f in want[:5]], axis=-1)
    np.testing.assert_array_equal(g[used], w[used])
    for b in range(B):               # ties in (start, end) carry equal rows
        rows = g[b, :n[b]]
        for r in rows:
            same = rows[(rows[:, 3] == r[3]) & (rows[:, 4] == r[4])]
            assert (same == same[0]).all()
    assert n.sum() > 0
    if caps == "tiny":
        assert got.overflow.numpy().any()


def test_seed_rows_matches_jax(setup):
    from tpubwa.ops.seeds import seed_rows as jax_seed_rows
    from tpubwa.ops.smem_chain import collect_smems_chain as jax_collect
    from tpubwa_torch.ops.seeds import seed_rows
    from tpubwa_torch.ops.smem import Smems

    kind, (jdi, tdi, q, lens) = setup
    sm = jax_collect(jdi, jnp.asarray(q), jnp.asarray(lens),
                     min_seed_len=OPT.min_seed_len, split_len=OPT.split_len,
                     split_width=OPT.split_width,
                     max_mem_intv=OPT.max_mem_intv)
    # (max_occ, per-read cap, rows per read): the last overflows the
    # global row buffer, whose rows past CAP are dropped
    for max_occ, cap, rpr in ((OPT.max_occ, OPT.max_seeds_per_read, 32),
                              (3, 5, 32), (OPT.max_occ, 64, 2)):
        want = jax_seed_rows(jdi, sm, max_occ=max_occ, per_read_cap=cap,
                             rows_per_read=rpr)
        got = seed_rows(tdi, Smems(*(torch.as_tensor(np.array(f))
                                     for f in sm)),
                        max_occ=max_occ, per_read_cap=cap,
                        rows_per_read=rpr)
        n = int(got.n)
        assert n == int(want.n) and n > 0
        np.testing.assert_array_equal(got.packed[:n].numpy(),
                                      np.asarray(want.packed)[:n])
        np.testing.assert_array_equal(got.l_rep.numpy(),
                                      np.asarray(want.l_rep))
        np.testing.assert_array_equal(got.overflow.numpy(),
                                      np.asarray(want.overflow))
        if rpr == 2:
            assert n == 2 * q.shape[0]        # the buffer is full


def _round2_lanes(q, lens):
    """Synthetic round-2 lanes over every read at spread middle positions
    (a seventh at the read's last base) and thresholds 1..4, a fifth of
    them inactive."""
    rng = np.random.default_rng(11)
    G = 4 * B
    rd = rng.integers(0, B, G).astype(np.int32)
    mid = rng.integers(0, L, G).astype(np.int32)
    mid[::7] = np.maximum(lens[rd[::7]] - 1, 0)
    thr = rng.integers(1, 5, G).astype(np.int32)
    act = rng.random(G) > 0.2
    return rd, mid, thr, act


@pytest.mark.parametrize("cap", [32, 1], ids=["cap32", "cap1-overflows"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("rnd", ["round2", "round3"])
def test_chain_rounds_match_jax(rnd, wide, cap):
    """The plain round-2 and round-3 chains (the references the CUDA
    kernel is held against) equal the JAX loops on whole buffers, on the
    narrow and the forced wide layout, also where ``cap`` overflows."""
    import jax

    from tpubwa.ops import smem_chain as jsc
    from tpubwa.ops.fm import DeviceIndex as JaxDI
    from tpubwa_torch.ops import smem_chain as tsc
    from tpubwa_torch.ops.fm import DeviceIndex

    _, _, q, lens = _setup("repeat")
    rng = np.random.default_rng(7)
    idx = FMIndex.build([Contig("c1", 48_000, 0)], _repeat_genome(rng, 48_000))
    tdi = DeviceIndex.from_host(idx, "cpu", wide=wide)
    idt = np.int64 if wide else np.int32
    rd, mid, thr, act = _round2_lanes(q, lens)
    tq, tl = torch.as_tensor(q), torch.as_tensor(lens)
    jax.config.update("jax_enable_x64", wide)
    try:
        jdi = JaxDI.from_host(idx, wide=wide)
        if rnd == "round2":
            want = jsc.smem_through_chain(
                jdi, jnp.asarray(q), jnp.asarray(lens), jnp.asarray(rd),
                jnp.asarray(mid), jnp.asarray(thr.astype(idt)),
                jnp.asarray(act), min_seed_len=OPT.min_seed_len, cap=cap)
        else:
            want = jsc.smem_round3_chain(
                jdi, jnp.asarray(q), jnp.asarray(lens),
                min_seed_len=OPT.min_seed_len,
                max_mem_intv=OPT.max_mem_intv, cap=cap)
        want = [np.asarray(f) for f in want]
    finally:
        jax.config.update("jax_enable_x64", False)
    if rnd == "round2":
        got = tsc.smem_through_chain(
            tdi, tq, tl, torch.as_tensor(rd), torch.as_tensor(mid),
            torch.as_tensor(thr.astype(idt)), torch.as_tensor(act),
            min_seed_len=OPT.min_seed_len, cap=cap)
    else:
        got = tsc.smem_round3_chain(tdi, tq, tl, min_seed_len=OPT.min_seed_len,
                                    max_mem_intv=OPT.max_mem_intv, cap=cap)
    assert got.k.dtype == (torch.int64 if wide else torch.int32)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got.n.sum()) > 20
    assert bool(got.overflow.any()) == (cap == 1)


@pytest.fixture(scope="module")
def edge():
    """``utils.sim``'s adversarial reads and round-2 lanes with their
    index (the set the card tests and chip_smoke.py hold K2 to)."""
    from tpubwa_torch.utils import sim

    codes = sim.smem_edge_reference(5)
    idx = FMIndex.build([Contig("c1", len(codes), 0)], codes)
    q, lens = sim.smem_edge_reads(6, codes)
    return idx, q, lens, sim.smem_edge_round2(7, lens)


@pytest.mark.parametrize("cap", [64, 1], ids=["cap64", "cap1-overflows"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("rnd", ["round1", "round2", "round3"])
def test_chain_rounds_match_jax_on_edge_reads(edge, rnd, wide, cap):
    """The plain chains on reads of one high-copy repeat, N at the ends
    and in runs, empty and too short reads, one long chain among short
    ones, B = 203 and G = 614, a cap of 1: whole buffers equal the JAX
    loops', narrow and wide."""
    import jax

    from tpubwa.ops import smem_chain as jsc
    from tpubwa.ops.fm import DeviceIndex as JaxDI
    from tpubwa_torch.ops import smem_chain as tsc
    from tpubwa_torch.ops import smem_chain_cuda as k2
    from tpubwa_torch.ops.fm import DeviceIndex

    idx, q, lens, (rd, mid, thr, act) = edge
    assert q.shape[0] % 16 and rd.shape[0] % 16
    assert (lens == 0).any() and ((lens > 0) & (lens < 19)).any()
    idt = np.int64 if wide else np.int32
    thr = thr.astype(idt)
    names = dict(round1="smem_round1_chain", round2="smem_through_chain",
                 round3="smem_round3_chain")
    cores = dict(round1=k2.smem_round1_core, round2=k2.smem_through_core,
                 round3=k2.smem_round3_core)
    extra = (rd, mid, thr, act) if rnd == "round2" else ()
    kw = dict(min_seed_len=OPT.min_seed_len, cap=cap)
    if rnd == "round3":
        kw["max_mem_intv"] = OPT.max_mem_intv
    jax.config.update("jax_enable_x64", wide)
    try:
        jdi = JaxDI.from_host(idx, wide=wide)
        want = getattr(jsc, names[rnd])(
            jdi, jnp.asarray(q), jnp.asarray(lens),
            *(jnp.asarray(a) for a in extra), **kw)
        want = [np.asarray(f) for f in want]
    finally:
        jax.config.update("jax_enable_x64", False)
    tdi = DeviceIndex.from_host(idx, "cpu", wide=wide)
    targs = (tdi, torch.as_tensor(q), torch.as_tensor(lens),
             *(torch.as_tensor(a) for a in extra))
    got = getattr(tsc, names[rnd])(*targs, **kw)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got.n.sum()) > 10
    assert bool(got.overflow.any()) == (cap == 1)
    # the wrapper takes the plain version for CPU tensors, launches nothing
    n0 = cores[rnd].launches
    again = cores[rnd](*targs, **kw)
    assert cores[rnd].launches == n0
    for g, w in zip(again, want):
        np.testing.assert_array_equal(g.numpy(), w)
