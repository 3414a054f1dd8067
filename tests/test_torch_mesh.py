"""The device mesh of the port (``tpubwa_torch.parallel.mesh``) on CPU
shards, held byte for byte to one device and to the JAX package.

* ``make_mesh``'s rules: a device list as given, N CPU shards, ``cuda``
  with fewer cards than the mesh refused (never the CPU in their place),
  ``cuda:k`` with N > 1 refused; the batch split.
* ``sa_lookup_sharded`` equals the SA itself, narrow and wide, and the
  JAX ``sa_lookup_sharded`` on the conftest's virtual CPU mesh (narrow:
  the JAX int64 layout needs its process-wide x64 mode), on rows that
  touch every shard's edges and the pad rows (which answer 0).
* ``seed_rows_mesh`` over 2, 3 and 4 shards equals one device and the JAX
  ``seed_rows``, on a batch whose repeat reads all sit in shard 0 and
  overflow the batch's row cap.
* ``tests/test_mesh_pipeline.py``'s fixture: the port's mesh records equal
  the JAX mesh's.
* Batches shorter than the mesh or not a multiple of it, and the batch of
  the seed-row case end to end.

The four legs of ``__graft_entry__.dryrun_multichip`` are in
``test_torch_mesh_legs.py`` (SE, sharded SA, wide + sharded SA) and
``test_torch_mesh_pe.py`` (PE), the serving modes on a mesh in
``test_torch_mesh_serving.py``: each file stays well under a minute.
"""
import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fasta import Contig
from tpubwa.io.fastq import Read, batch_reads

torch.set_num_threads(1)

CPU = torch.device("cpu")


# ------------------------------------------------------------ the mesh ----

@pytest.mark.parametrize("n,device,want", [
    (4, "cpu", [CPU] * 4),
    (None, "cpu,cpu,cpu", [CPU] * 3),
    (None, ["cpu", "cpu"], [CPU] * 2),
    (2, ("cpu", "cpu"), [CPU] * 2),
    (None, "cpu", [CPU]),
    (1, "cpu", [CPU]),
    (4, "cuda", "no CUDA device"),
    (2, ["cuda:0", "cuda:0"], "no CUDA device"),
    (2, "cuda:0", ValueError),
    (4, "cpu,cpu", ValueError),
], ids=["cpu-4", "list-string", "list", "list-sized", "one", "one-sized",
        "cuda-4-no-card", "cuda-list-no-card", "cuda-k-mesh",
        "list-mismatch"])
def test_make_mesh_rules(n, device, want):
    from tpubwa_torch.parallel.mesh import DevicesUnavailable, make_mesh

    if isinstance(want, list):
        assert list(make_mesh(n, device).devices) == want
    elif want is ValueError:
        with pytest.raises(ValueError):
            make_mesh(n, device)
    else:
        if torch.cuda.device_count() >= 4:
            pytest.skip("this machine has the cards")
        with pytest.raises(DevicesUnavailable, match=want):
            make_mesh(n, device)


def test_mesh_split_and_distinct():
    from tpubwa_torch.parallel.mesh import DeviceMesh

    m = DeviceMesh((CPU, torch.device("meta"), CPU))
    assert m.distinct == (CPU, torch.device("meta"))
    assert m.split(10) == [(0, 4), (4, 8), (8, 10)]
    assert m.split(2) == [(0, 1), (1, 2), (2, 2)]
    assert m.split(0) == [(0, 0)] * 3


# ---------------------------------------------------------- sharded SA ----

@pytest.fixture(scope="module")
def small_idx():
    codes = np.random.default_rng(4).integers(0, 4, 3001).astype(np.uint8)
    return FMIndex.build([Contig("c1", 3001, 0)], codes)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_sa_lookup_sharded_matches_jax(small_idx, n, wide):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpubwa.ops.fm import sa_lookup_sharded as jax_lookup
    from tpubwa.parallel.mesh import make_mesh as jax_mesh
    from tpubwa_torch.ops.fm import ShardedSA, sa_lookup_sharded

    sa = small_idx.sa
    ssa = ShardedSA.from_host(small_idx, [CPU] * n, wide)
    per = ssa.rows
    assert per == -(-len(sa) // n) and ssa.n_rows >= len(sa)
    assert all(s.dtype == (torch.int64 if wide else torch.int32)
               and s.shape == (per,) for s in ssa.shards)
    # every shard's first and last row, 0, n, the last real row, the pad
    # rows, and random rows: n requesters of 64 rows each
    edges = sorted({0, n, len(sa) - 1, *range(len(sa), ssa.n_rows),
                    *(d * per + e for d in range(n) for e in (-1, 0))}
                   - {-1})
    rng = np.random.default_rng(n)
    rows = np.concatenate([edges, rng.integers(0, len(sa), 64 * n
                                               - len(edges))])
    rows = rows.astype(np.int32)
    got = sa_lookup_sharded(ssa, list(torch.as_tensor(rows).chunk(n)))
    got = torch.cat(got).numpy()
    full = np.concatenate([sa, np.zeros(ssa.n_rows - len(sa), np.int64)])
    np.testing.assert_array_equal(got, full[rows])
    assert (got[rows >= len(sa)] == 0).all()

    if wide:        # the JAX package's int64 layout needs its x64 mode
        return
    mesh = jax_mesh(n)
    sa_j = jax.device_put(full.astype(np.int32),
                          NamedSharding(mesh, P("dp")))
    rows_j = jax.device_put(jnp.asarray(rows), NamedSharding(mesh, P("dp")))
    np.testing.assert_array_equal(
        got, np.asarray(jax_lookup(mesh, sa_j, rows_j)))


# ----------------------------------------------------------- seed rows ----

@pytest.fixture(scope="module")
def repeat_batch():
    """A 60 kb genome with one 100 bp element at 200 places of its first
    40 kb; 24 reads of which the first 8 are the element (128 seed rows
    each, against a cap of 24 x 32 = 768 for the batch) and the rest
    from the unique last 20 kb."""
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 60_000).astype(np.uint8)
    elem = rng.integers(0, 4, 100).astype(np.uint8)
    for p in rng.choice(390, 200, replace=False) * 100 + 50:
        codes[p:p + 100] = elem
    idx = FMIndex.build([Contig("r1", len(codes), 0)], codes)
    L = 112
    q = np.full((24, L), 4, np.int32)
    lens = np.full(24, 100, np.int32)
    q[:8, :100] = elem
    for i in range(8, 24):
        p = int(rng.integers(40_000, 59_000))
        q[i, :100] = rng.integers(0, 4, 100)
        q[i, :60] = codes[p:p + 60]
    return idx, q, lens


@pytest.mark.parametrize("n", [2, 3, 4])
def test_seed_rows_over_shards_match_one_device_and_jax(repeat_batch, n):
    from tpubwa.ops.fm import DeviceIndex as JaxDI
    from tpubwa.ops.seeds import seed_rows as jax_seed_rows
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.ops.seeds import seed_rows, seed_rows_mesh
    from tpubwa_torch.ops.smem import Smems
    from tpubwa_torch.ops.smem_chain import (collect_smems_chain,
                                             collect_smems_mesh)
    from tpubwa_torch.parallel.mesh import make_mesh

    idx, q, lens = repeat_batch
    opt = MemOptions()
    kw = dict(min_seed_len=opt.min_seed_len, split_len=opt.split_len,
              split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
              out_cap=opt.max_smems_per_read)
    skw = dict(max_occ=opt.max_occ, per_read_cap=opt.max_seeds_per_read)
    di = DeviceIndex.from_host(idx, CPU)
    qt, lt = torch.as_tensor(q), torch.as_tensor(lens)
    sm = collect_smems_chain(di, qt, lt, **kw)
    one = seed_rows(di, sm, **skw)
    n1 = int(one.n)
    assert n1 == 24 * 32 and bool(one.overflow[:8].any())

    parts = make_mesh(n, "cpu").split(24)
    sms = collect_smems_mesh([di] * n, [qt[a:b] for a, b in parts],
                             [lt[a:b] for a, b in parts], **kw)
    for s, (a, b) in zip(sms, parts):       # SMEMs are per read
        np.testing.assert_array_equal(s.k.numpy(), sm.k[a:b].numpy())
    css = seed_rows_mesh([di] * n, sms, **skw)
    rows = np.concatenate([c.packed[:int(c.n)].numpy() + [[a, 0, 0, 0]]
                           for c, (a, _) in zip(css, parts)])
    np.testing.assert_array_equal(rows, one.packed[:n1].numpy())
    for f in ("l_rep", "overflow"):
        np.testing.assert_array_equal(
            torch.cat([getattr(c, f) for c in css]).numpy(),
            getattr(one, f).numpy())
    # a shard's own cap (24 x 32 / n) would have dropped rows one device
    # keeps: shard 0 alone holds more than that
    assert int(css[0].n) > 24 * 32 // n

    jsm = Smems(*(np.asarray(f.numpy()) for f in sm))
    want = jax_seed_rows(JaxDI.from_host(idx), jsm, **skw)
    assert int(want.n) == n1
    np.testing.assert_array_equal(rows, np.asarray(want.packed)[:n1])
    np.testing.assert_array_equal(one.l_rep.numpy(), np.asarray(want.l_rep))
    np.testing.assert_array_equal(one.overflow.numpy(),
                                  np.asarray(want.overflow))


# ------------------------------------------- the JAX mesh's own fixture ----

def test_mesh_records_match_jax_mesh():
    """``tests/test_mesh_pipeline.py``'s fixture and comparison: the
    port's ``align_se_batch`` on four CPU shards equals the JAX Aligner's
    on the four-device virtual mesh."""
    from tpubwa.align.pipeline import Aligner as JaxAligner
    from tpubwa.parallel.mesh import make_mesh as jax_mesh
    from tpubwa.utils.sim import simulate_reads
    from tpubwa_torch.align.pipeline import Aligner

    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, 12000).astype(np.uint8)
    contigs = [Contig("m1", 12000, 0)]
    idx = FMIndex.build(contigs, codes)
    reads = [Read(*r) for r in simulate_reads(codes, contigs, 50, length=100,
                                              err=0.02, indel=0.002, seed=6)]
    opt = MemOptions(batch_reads=64, max_read_len=112)
    batch = next(batch_reads(reads, 64, opt.max_read_len))
    want = [r.line() for rl in JaxAligner(idx, opt, mesh=jax_mesh(4))
            .align_se_batch(batch, 0) for r in rl]
    assert want
    al = Aligner(idx, opt, device=["cpu"] * 4)
    got = [r.line() for rl in al.align_se_batch(batch, 0) for r in rl]
    assert got == want


# ------------------------------------------------------- short batches ----

def repeat_genome_fixture() -> dict:
    """``__graft_entry__.dryrun_multichip``'s fixture, at its size for
    N = 4: the 100 kb repeat genome (segmental copies and an Alu-like
    family), 128 reads and 32 pairs."""
    from tpubwa.utils.gensim import repeat_genome
    from tpubwa.utils.sim import simulate_pairs, simulate_reads

    rng = np.random.default_rng(3)
    codes = repeat_genome(rng, 100_000)
    contigs = [Contig("c1", 100_000, 0)]
    idx = FMIndex.build(contigs, codes)
    reads = [Read(*r) for r in simulate_reads(
        codes, contigs, 128, length=100, err=0.02, indel=0.002, seed=5)]
    opt = MemOptions(batch_reads=len(reads), max_read_len=128)
    batch = next(batch_reads(reads, len(reads), opt.max_read_len))
    r1, r2 = simulate_pairs(codes, contigs, 32, length=100, isize_mean=300,
                            isize_std=30, err=0.02, indel=0.002, seed=11)
    b1 = next(batch_reads([Read(*r) for r in r1], 32, opt.max_read_len))
    b2 = next(batch_reads([Read(*r) for r in r2], 32, opt.max_read_len))
    return dict(idx=idx, codes=codes, opt=opt, reads=reads, batch=batch,
                b1=b1, b2=b2)


def force_wide_sharded(al) -> None:
    """The wide (int64) layout with the SA sharded, forced on a small
    index as ``dryrun_multichip`` forces it (every shard on the first
    device)."""
    from tpubwa_torch.ops.fm import DeviceIndex, ShardedSA

    assert al.mesh.distinct == (al.device,)
    al.di = DeviceIndex.from_host(al.idx, al.device, wide=True,
                                  sa_stub=True)
    al.ssa = ShardedSA.from_host(al.idx, al.mesh.devices, wide=True)


@pytest.fixture(scope="module")
def genome():
    return repeat_genome_fixture()


@pytest.mark.parametrize("n_reads,n,size,starts", [
    (3, 4, 3, [0, 1, 2]), (13, 4, 13, [0, 4, 8, 12]), (7, 3, 7, [0, 3, 6]),
    (1, 2, 1, [0]), (13, 4, 40, [0, 4, 8, 12]), (2, 4, 64, [0, 1, 2])],
    ids=["B<N", "B%N", "B%N-3", "one-read", "padded", "padded-B<N"])
def test_short_and_uneven_batches(genome, n_reads, n, size, starts):
    """B < N leaves shards without reads (they launch nothing) and B % N
    != 0 a short last slice; a batch padded to its size splits its reads
    evenly and gives the padding to the last shard.  The SAM is one
    device's."""
    from tpubwa_torch.align.pipeline import Aligner

    batch = next(batch_reads(genome["reads"][:n_reads], size, 128))
    opt = genome["opt"]
    want = Aligner(genome["idx"], opt, device="cpu").align_se_text(batch, 0)
    al = Aligner(genome["idx"], opt, device=["cpu"] * n)
    h = al.seed_batch_dispatch(batch.codes, batch.lens)
    assert h.starts == starts
    assert sum(cs.l_rep.shape[0] for cs in h.seeds) == size
    assert al.align_se_text(batch, 0, seed_handle=h) == want
    assert want.count("\n") >= n_reads


def test_repeat_overflow_batch_end_to_end(repeat_batch):
    """The batch of ``test_seed_rows_over_shards_match_one_device_and_jax``
    through the whole pipeline on three shards: the SAM and the overflow
    count are one device's."""
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.utils.dna import decode

    idx, q, lens = repeat_batch
    reads = [Read(f"r{i}", decode(q[i, :lens[i]]), "I" * int(lens[i]))
             for i in range(len(lens))]
    batch = next(batch_reads(reads, len(reads), 112))
    opt = MemOptions(batch_reads=len(reads), max_read_len=112)
    one = Aligner(idx, opt, device="cpu")
    mesh = Aligner(idx, opt, device="cpu,cpu,cpu")
    assert mesh.align_se_text(batch, 0) == one.align_se_text(batch, 0)
    assert mesh.n_overflow == one.n_overflow > 0


