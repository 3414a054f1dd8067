"""The CUDA kernels against their plain PyTorch versions, on the card.

K1 (csrc/extend.cu) and K1b (csrc/extend_b.cu) against ``_extend_core``
(up to Q 256, the wide bucket's query window), K4 (csrc/localsw.cu)
against ``localsw_batch`` (up to Q 256, T 2,048: the wide bucket's
rescue pads), K5 (csrc/sa_sampled.cu) against ``sa_lookup_sampled``, K2
(csrc/smem_chain.cu; three rounds, int32 and int64) against the plain
chains, K3 (csrc/global_align.cu; pack and step rows; up to Q 256, T 384,
the wide bucket's SAM windows) against ``_ga_rows_plain`` and
``global_align_cigar_batch``, exact on every field, and each wrapper's
launch counter (K1, K1b and K4 also on the adversarial job sets of
``utils.sim``, with scores beyond 16 bits among them, K5 on its edge rows
and with counts of live rows); a ``-t 4`` SE run equal to ``-t 1``; and a
device mesh (two shards on one card, or a shard on each card) equal to
one device, the SA copied or sharded.  Needs a CUDA
card and nvcc (the kernels are compiled on first use); skipped where
torch sees no GPU.  Imports neither jax nor the JAX package, so it runs on
a machine without them:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from tpubwa_torch.config import MemOptions

OPT = MemOptions()
KW = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins, e_ins=OPT.e_ins,
          zdrop=OPT.zdrop, mat_max=OPT.a)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _jobs(rng, J, Q, T):
    target = rng.integers(0, 4, (J, T)).astype(np.int32)
    query = target[:, :Q].copy()
    mut = rng.random((J, Q)) < 0.05
    query[mut] = rng.integers(0, 4, int(mut.sum()))
    query[rng.random((J, Q)) < 0.01] = 4
    qlen = rng.integers(0, Q + 1, J).astype(np.int32)
    tlen = rng.integers(0, T + 1, J).astype(np.int32)
    w = rng.choice([3, 20, 100], J).astype(np.int32)
    h0 = rng.integers(1, 60, J).astype(np.int32)
    bonus = np.full(J, OPT.pen_clip5, np.int32)
    return query, qlen, target, tlen, w, h0, bonus


def _check_extend(core, cuda, J, Q, T):
    from tpubwa_torch.ops.extend import _extend_core

    rng = np.random.default_rng(J)
    q, ql, t, tl, w, h0, bonus = (torch.as_tensor(a, device=cuda)
                                  for a in _jobs(rng, J, Q, T))
    mat = torch.as_tensor(OPT.score_matrix(), device=cuda)
    n0 = core.launches
    got = core(q, ql, t, tl, mat, w, h0, bonus, **KW)
    torch.cuda.synchronize()
    assert core.launches == n0 + 1
    want = _extend_core(q, ql, t, tl, mat, w, h0, bonus, **KW)
    for g, p in zip(got, want):
        assert torch.equal(g.cpu(), p.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("J,Q,T", [(1, 8, 8), (300, 64, 96),
                                   (2048, 192, 768), (2049, 256, 768)])
def test_kernel_matches_plain_on_card(cuda, J, Q, T):
    from tpubwa_torch.ops.extend_cuda import extend_core

    _check_extend(extend_core, cuda, J, Q, T)


@pytest.mark.cuda
@pytest.mark.parametrize("J,Q,T", [(1, 8, 8), (301, 70, 96),
                                   (2048, 192, 768), (2049, 256, 768)])
def test_warp_kernel_matches_plain_on_card(cuda, J, Q, T):
    from tpubwa_torch.ops.extend_cuda import extend_core_b

    _check_extend(extend_core_b, cuda, J, Q, T)


@pytest.mark.cuda
@pytest.mark.parametrize("J,Q,T", [(1, 8, 8), (300, 100, 256),
                                   (1024, 192, 1024), (513, 256, 2048)])
def test_localsw_kernel_matches_plain_on_card(cuda, J, Q, T):
    from tpubwa_torch.ops.localsw import localsw_batch
    from tpubwa_torch.ops.localsw_cuda import localsw_core

    rng = np.random.default_rng(J)
    t = rng.integers(0, 4, (J, T)).astype(np.int32)
    q = np.roll(t, -int(rng.integers(0, T)), axis=1)[:, :Q].copy()
    mut = rng.random((J, Q)) < 0.05
    q[mut] = rng.integers(0, 4, int(mut.sum()))
    q[rng.random((J, Q)) < 0.01] = 4
    qlen = rng.integers(0, Q + 1, J).astype(np.int32)
    tlen = rng.integers(0, T + 1, J).astype(np.int32)
    minsc = rng.integers(0, 40, J).astype(np.int32)
    endsc = np.where(rng.random(J) < 0.3, rng.integers(1, 60, J),
                     1 << 30).astype(np.int32)
    args = [torch.as_tensor(a, device=cuda) for a in
            (q, qlen, t, tlen, OPT.score_matrix(), minsc, endsc)]
    kw = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
              e_ins=OPT.e_ins)
    n0 = localsw_core.launches
    got = localsw_core(*args, **kw)
    torch.cuda.synchronize()
    assert localsw_core.launches == n0 + 1
    want = localsw_batch(*args, **kw)
    for g, p in zip(got, want):
        assert torch.equal(g.cpu(), p.cpu())


# K1 and K4 on the adversarial job sets of utils.sim (qlen 0, 1, 31, 32,
# 33, Q; tlen 0, 1, T; w 0 and >= qlen; all-N; ties; z-drops; endsc on row
# 0 and never), J a multiple of no group or block size

def _edge_extend(case):
    from tpubwa_torch.utils.sim import extend_edge_jobs

    kw = dict(KW)
    sl = slice(None)
    Q, T = 192, 768
    if case == "zdrop8":
        kw["zdrop"] = 8
    elif case == "no_zdrop":
        kw["zdrop"] = 0
    elif case == "small_q":
        Q, T = 40, 64
    elif case == "wide_q":
        Q, T = 256, 300
    elif case == "one_job":
        sl = slice(11, 12)
    elif case == "skewed_gaps":
        kw.update(o_del=4, e_del=2, o_ins=7, e_ins=1, zdrop=20)
    jobs = [a[sl] for a in extend_edge_jobs(len(case), Q, T)]
    if case == "mostly_dead":       # the retry launch: qlen zeroed
        jobs[1] = np.where(np.arange(len(jobs[1])) % 37 == 0, jobs[1], 0
                           ).astype(np.int32)
    elif case == "beyond_16_bits":  # scores that no 16-bit lane holds
        jobs[5] = jobs[5] * 5000
    elif case == "beyond_23_bits":  # K1b's (H << 8 | j) key does not hold
        jobs[5] = jobs[5] * 50000   # the h0 = 200 jobs: two reductions
    return jobs, kw


@pytest.mark.cuda
@pytest.mark.parametrize("core_name", ["extend_core", "extend_core_b"],
                         ids=["K1", "K1b"])
@pytest.mark.parametrize("case", ["default", "zdrop8", "no_zdrop", "small_q",
                                  "wide_q", "one_job", "mostly_dead",
                                  "skewed_gaps", "beyond_16_bits",
                                  "beyond_23_bits"])
def test_kernel_matches_plain_on_edge_jobs(cuda, case, core_name):
    from tpubwa_torch.ops import extend_cuda
    from tpubwa_torch.ops.extend import _extend_core

    extend_core = getattr(extend_cuda, core_name)
    jobs, kw = _edge_extend(case)
    q, ql, t, tl, w, h0, bonus = (torch.as_tensor(a, device=cuda)
                                  for a in jobs)
    mat = torch.as_tensor(OPT.score_matrix(), device=cuda)
    n0 = extend_core.launches
    got = extend_core(q, ql, t, tl, mat, w, h0, bonus, **kw)
    torch.cuda.synchronize()
    assert extend_core.launches == n0 + 1
    want = _extend_core(q, ql, t, tl, mat, w, h0, bonus, **kw)
    for name, g, p in zip(want._fields, got, want):
        assert torch.equal(g.cpu(), p.cpu()), name
    if case.startswith("beyond"):
        assert int(got.score.max()) > (1 << 23 if "23" in case else 1 << 16)
    if case == "zdrop8":
        assert bool(((got.tle < tl) & (got.score > h0)).any())
    # the same jobs as bytes, and as column slices of one int32 buffer
    # (both are read where they lie), give the same
    buf = torch.cat([q, t, q], dim=1)
    for qq, tt in ((q.to(torch.uint8), t.to(torch.uint8)),
                   (buf[:, :q.shape[1]], buf[:, q.shape[1]:-q.shape[1]])):
        again = extend_core(qq, ql, tt, tl, mat, w, h0, bonus, **kw)
        for name, g, p in zip(want._fields, again, want):
            assert torch.equal(g.cpu(), p.cpu()), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "skewed_gaps", "mostly_dead"])
def test_prep_kernel_matches_plain_on_card(cuda, case):
    """K1's prep kernel (band clamp and sort keys) against
    ``clamp_band_batch`` and ``job_keys``."""
    from tpubwa_torch.ops.extend import clamp_band_batch
    from tpubwa_torch.ops.extend_cuda import job_keys, job_keys_core

    jobs, kw = _edge_extend(case)
    _, ql, _, tl, w, _, bonus = (torch.as_tensor(a, device=cuda)
                                 for a in jobs)
    w = torch.where(torch.arange(len(w), device=cuda) % 5 == 0, -w, w)
    bonus = bonus + torch.arange(len(w), device=cuda, dtype=torch.int32) % 9
    gaps = {k: v for k, v in kw.items() if k != "zdrop"}
    Q, T = jobs[0].shape[1] - 7, jobs[2].shape[1] - 7   # lengths get cut
    wc, keys = job_keys_core(ql, tl, w, bonus, Q, T, **gaps)
    want_wc = clamp_band_batch(w, ql, gaps["mat_max"], gaps["o_del"],
                               gaps["e_del"], gaps["o_ins"], gaps["e_ins"],
                               bonus)
    assert torch.equal(wc, want_wc)
    assert torch.equal(keys, job_keys(ql, tl, want_wc, Q, T))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "t256", "small_q", "wide_q",
                                  "one_job", "skewed_gaps",
                                  "beyond_16_bits"])
def test_localsw_kernel_matches_plain_on_edge_jobs(cuda, case):
    from tpubwa_torch.ops.localsw import localsw_batch
    from tpubwa_torch.ops.localsw_cuda import localsw_core
    from tpubwa_torch.utils.sim import localsw_edge_jobs

    kw = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
              e_ins=OPT.e_ins)
    Q, T = {"t256": (192, 256), "small_q": (40, 96),
            "wide_q": (256, 300)}.get(case, (192, 1024))
    jobs = list(localsw_edge_jobs(len(case), Q, T))
    mat = OPT.score_matrix()
    if case == "one_job":
        jobs = [a[13:14] for a in jobs]
    elif case == "skewed_gaps":
        kw.update(o_del=4, e_del=2, o_ins=7, e_ins=1)
    elif case == "beyond_16_bits":   # every score and penalty x 1000
        mat = mat * 1000
        kw = {k: v * 1000 for k, v in kw.items()}
        jobs[4] = np.minimum(jobs[4], 1 << 20) * 1000
        jobs[5] = np.where(jobs[5] < 1 << 20, jobs[5] * 1000, jobs[5])
    args = [torch.as_tensor(a, device=cuda) for a in
            (*jobs[:4], mat, *jobs[4:])]
    n0 = localsw_core.launches
    got = localsw_core(*args, **kw)
    torch.cuda.synchronize()
    assert localsw_core.launches == n0 + 1
    want = localsw_batch(*args, **kw)
    for name, g, p in zip(want._fields, got, want):
        assert torch.equal(g.cpu(), p.cpu()), name
    if case == "beyond_16_bits":
        assert int(got.score.max()) > 1 << 16
    if case == "default":
        assert int((got.score2 > 0).sum()) > 5
    # bytes, and column slices of one int32 buffer, are read where they lie
    q, t = args[0], args[2]
    buf = torch.cat([q, t, q[:, :4]], dim=1)
    for qq, tt in ((q.to(torch.uint8), t.to(torch.uint8)),
                   (buf[:, :q.shape[1]], buf[:, q.shape[1]:-4])):
        again = localsw_core(qq, args[1], tt, *args[3:], **kw)
        for name, g, p in zip(want._fields, again, want):
            assert torch.equal(g.cpu(), p.cpu()), name


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("shift", [2, 4, 5])
def test_sa_sampled_kernel_matches_plain_on_card(cuda, shift, wide):
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fasta import Contig
    from tpubwa_torch.ops.fm import (DeviceIndex, build_sampled_sa,
                                     sa_lookup_sampled)
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core

    rng = np.random.default_rng(shift)
    codes = rng.integers(0, 4, 50_000).astype(np.uint8)
    idx = FMIndex.build([Contig("c1", 50_000, 0)], codes)
    di = DeviceIndex.from_host(idx, cuda, wide=wide, sa_stub=True)
    ss = build_sampled_sa(None, shift, wide, idx=idx, device=cuda)
    n = idx.sa_ls.shape[0]
    rows = np.concatenate([[0, n - 1, idx.primary],
                           rng.integers(0, n, 20_000)])
    r = torch.as_tensor(rows.astype(np.int64 if wide else np.int32),
                        device=cuda)
    n0 = sa_lookup_sampled_core.launches
    got = sa_lookup_sampled_core(di, ss, r, shift)
    torch.cuda.synchronize()
    assert sa_lookup_sampled_core.launches == n0 + 1
    assert got.dtype == r.dtype
    want = sa_lookup_sampled(di, ss, r, shift)
    assert torch.equal(got.cpu(), want.cpu())
    np.testing.assert_array_equal(got.cpu().numpy(), idx.sa[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
def test_sa_sampled_kernel_matches_plain_on_edge_rows(cuda, wide):
    """K5 on ``utils.sim.sa_edge_rows`` (the longest walks, the primary row
    and its neighbours, rows 0 and N, the blocks' word edges, 3,001 rows),
    at shifts 0, 1 and 5, one row alone, in each of its four modes, and
    with counts of live rows: below the count the full SA, past it 0."""
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fasta import Contig
    from tpubwa_torch.ops.fm import (DeviceIndex, build_sampled_sa,
                                     sa_lookup_sampled)
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core
    from tpubwa_torch.utils.sim import sa_edge_rows
    from tpubwa_torch.utils.simgenome import repeat_genome

    n = 40_000
    codes = repeat_genome(np.random.default_rng(9), n)
    idx = FMIndex.build([Contig("c1", n, 0)], codes)
    di = DeviceIndex.from_host(idx, cuda, wide=wide, sa_stub=True)
    dt = torch.int64 if wide else torch.int32
    for shift in (0, 1, 5):
        ss = build_sampled_sa(None, shift, wide, idx=idx, device=cuda)
        rows = sa_edge_rows(idx, shift)
        r = torch.as_tensor(rows, device=cuda).to(dt)
        for sel in (slice(None), slice(0, 1)):
            got = sa_lookup_sampled_core(di, ss, r[sel], shift)
            torch.cuda.synchronize()
            assert got.dtype == dt
            assert torch.equal(got.cpu(), sa_lookup_sampled(
                di, ss, r[sel], shift).cpu())
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          idx.sa[rows[sel]])
        for live in (0, 1, 33, 1000, rows.size, rows.size + 9):
            n_live = torch.tensor(live, dtype=torch.int32, device=cuda)
            n0 = sa_lookup_sampled_core.launches
            got = sa_lookup_sampled_core(di, ss, r, shift, n_live=n_live)
            torch.cuda.synchronize()
            assert sa_lookup_sampled_core.launches == n0 + 1
            k = min(live, rows.size)
            assert torch.equal(got.cpu(), sa_lookup_sampled(
                di, ss, r, shift, n_live=n_live).cpu())
            np.testing.assert_array_equal(got[:k].cpu().numpy(),
                                          idx.sa[rows[:k]])
            assert bool((got[k:] == 0).all())


def _chain_setup(cuda, wide, n=48_000, B=96, L=160):
    """A repeat-structured index on the card and a read batch with an N
    run, an empty row, a row shorter than a seed and a full-width row."""
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fasta import Contig
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.utils import sim
    from tpubwa_torch.utils.dna import encode
    from tpubwa_torch.utils.simgenome import repeat_genome

    codes = repeat_genome(np.random.default_rng(7), n)
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
    q[5, 40:44] = 4
    lens[6] = 0
    lens[7] = 12
    q[10] = np.resize(q[10, :lens[10]], L)
    lens[10] = L
    di = DeviceIndex.from_host(idx, cuda, wide=wide)
    return (di, torch.as_tensor(q, device=cuda),
            torch.as_tensor(lens, device=cuda))


def _same_smems(got, want):
    for name, g, p in zip(want._fields, got, want):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        assert torch.equal(g.cpu(), p.cpu()), name


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("rnd", ["round1", "round2", "round3"])
def test_smem_chain_kernel_matches_plain_on_card(cuda, rnd, wide):
    """K2 against the plain chains on whole buffers (k, l, s, start, end,
    n, overflow), at the default cap and at one that overflows."""
    from tpubwa_torch.ops import smem_chain as plain
    from tpubwa_torch.ops import smem_chain_cuda as k2

    di, q, lens = _chain_setup(cuda, wide)
    idt = torch.int64 if wide else torch.int32
    B, L = q.shape
    for cap in (32, 2):
        if rnd == "round1":
            core, args = k2.smem_round1_core, (di, q, lens)
            kw = dict(min_seed_len=19, cap=cap)
            ref = plain.smem_round1_chain
        elif rnd == "round3":
            core, args = k2.smem_round3_core, (di, q, lens)
            kw = dict(min_seed_len=19, max_mem_intv=20, cap=cap)
            ref = plain.smem_round3_chain
        else:
            rng = np.random.default_rng(11)
            G = 4 * B
            rd = rng.integers(0, B, G).astype(np.int32)
            mid = rng.integers(0, L, G).astype(np.int32)
            thr = rng.integers(1, 5, G)
            act = rng.random(G) > 0.2
            core = k2.smem_through_core
            args = (di, q, lens, torch.as_tensor(rd, device=cuda),
                    torch.as_tensor(mid, device=cuda),
                    torch.as_tensor(thr, device=cuda).to(idt),
                    torch.as_tensor(act, device=cuda))
            kw = dict(min_seed_len=19, cap=cap)
            ref = plain.smem_through_chain
        n0 = core.launches
        steps = torch.zeros(args[3].shape[0] if rnd == "round2" else B,
                            dtype=torch.int32, device=cuda)
        got = core(*args, **kw, steps_out=steps)
        torch.cuda.synchronize()
        assert core.launches == n0 + 1
        want = ref(*args, **kw)
        _same_smems(got, want)
        assert int(got.n.sum()) > 20 and int(steps.sum()) > 1000
        assert bool(got.overflow.any()) == (cap == 2)
    # no lanes: empty buffers and no launch
    n0 = core.launches
    if rnd == "round2":
        empty = core(di, q, lens, *(a[:0] for a in args[3:]), **kw)
    else:
        empty = core(di, q[:0], lens[:0], **kw)
    assert tuple(empty.k.shape) == (0, 2) and tuple(empty.n.shape) == (0,)
    assert core.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
def test_collect_smems_on_card_matches_cpu(cuda, wide):
    """The whole three-round collection through K2 equals the plain
    versions' on the CPU."""
    from tpubwa_torch.ops import smem_chain_cuda as k2
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.ops.smem_chain import collect_smems_chain

    di, q, lens = _chain_setup(cuda, wide)
    cpu_di = DeviceIndex(*(t.cpu() if torch.is_tensor(t) else t for t in di))
    n0 = (k2.smem_round1_core.launches, k2.smem_through_core.launches,
          k2.smem_round3_core.launches)
    got = collect_smems_chain(di, q, lens, r2_lanes=64)
    want = collect_smems_chain(cpu_di, q.cpu(), lens.cpu(), r2_lanes=64)
    _same_smems(got, want)
    assert k2.smem_round1_core.launches == n0[0] + 1
    assert k2.smem_through_core.launches > n0[1]
    assert k2.smem_round3_core.launches == n0[2] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("gaps", [dict(o_del=6, e_del=1, o_ins=6, e_ins=1),
                                  dict(o_del=4, e_del=2, o_ins=7, e_ins=1)],
                         ids=["default", "skewed"])
def test_global_align_kernel_matches_plain_on_card(cuda, gaps):
    """K3's pack against ``_ga_rows_plain`` and its step rows against
    ``global_align_cigar_batch``, on ``utils.sim.ga_lanes`` (long
    gaps, nseg > GA_K, one-base target and query, band at cap and
    floor), more lanes than persistent blocks."""
    from tpubwa_torch.align.flatsam import GA_K, _ga_rows, _ga_rows_plain
    from tpubwa_torch.ops import global_align_cuda as k3
    from tpubwa_torch.ops.global_align import global_align_cigar_batch
    from tpubwa_torch.utils.sim import ga_lanes as make_lanes

    n = 6000
    qD, tD, qlen, tlen, w = make_lanes(5, n)
    rows = np.random.default_rng(0).permutation(n)[:n - 7].astype(np.int64)
    dev = [torch.as_tensor(a, device=cuda)
           for a in (qD, tD, rows, qlen[rows], tlen[rows], w[rows],
                     OPT.score_matrix())]
    n0 = k3.ga_pack.launches
    got = _ga_rows(*dev, **gaps)
    torch.cuda.synchronize()
    assert k3.ga_pack.launches == n0 + 1
    want = _ga_rows_plain(*dev, **gaps, ga_k=GA_K)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want.cpu())
    assert int((want[:, 1] > GA_K).sum()) > 10

    empty = _ga_rows(dev[0], dev[1], dev[2][:0], dev[3][:0], dev[4][:0],
                     dev[5][:0], dev[6], **gaps)
    assert tuple(empty.shape) == (0, 2 + GA_K)
    assert k3.ga_pack.launches == n0 + 1          # no launch for no lanes

    m = 512                                       # the executor's entry
    sub = rows[:m]
    args = [torch.as_tensor(a, device=cuda) for a in (
        qD[sub].astype(np.int32), qlen[sub], tD[sub].astype(np.int32),
        tlen[sub], OPT.score_matrix(), w[sub])]
    n0 = k3.global_align_cigar_core.launches
    got = k3.global_align_cigar_core(*args, **gaps)
    torch.cuda.synchronize()
    assert k3.global_align_cigar_core.launches == n0 + 1
    want = global_align_cigar_batch(*args, **gaps)
    assert torch.equal(got.score.cpu(), want.score.cpu())
    assert torch.equal(got.steps.cpu(), want.steps.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("cap", [64, 1], ids=["cap64", "cap1-overflows"])
def test_smem_chain_kernel_matches_plain_on_edge_reads(cuda, cap, wide):
    """K2's three rounds on ``utils.sim.smem_edge_reads``: reads of one
    high-copy repeat, N at the ends and in runs, empty and too short
    reads, one long chain among short ones in a warp, B = 203 and
    G = 614 (multiples of no group or block size), at a cap of 1, where
    every emitting lane overflows."""
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fasta import Contig
    from tpubwa_torch.ops import smem_chain as plain
    from tpubwa_torch.ops import smem_chain_cuda as k2
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.utils import sim

    codes = sim.smem_edge_reference(5)
    idx = FMIndex.build([Contig("c1", len(codes), 0)], codes)
    di = DeviceIndex.from_host(idx, cuda, wide=wide)
    idt = torch.int64 if wide else torch.int32
    qh, lh = sim.smem_edge_reads(6, codes)
    q, lens = torch.as_tensor(qh, device=cuda), torch.as_tensor(lh,
                                                                device=cuda)
    rd, mid, thr, act = (torch.as_tensor(a, device=cuda)
                         for a in sim.smem_edge_round2(7, lh))
    B, G = q.shape[0], rd.shape[0]
    assert B % 16 and G % 16
    calls = [
        (k2.smem_round1_core, plain.smem_round1_chain, (di, q, lens),
         dict(min_seed_len=19, cap=cap), B),
        (k2.smem_through_core, plain.smem_through_chain,
         (di, q, lens, rd, mid, thr.to(idt), act),
         dict(min_seed_len=19, cap=cap), G),
        (k2.smem_round3_core, plain.smem_round3_chain, (di, q, lens),
         dict(min_seed_len=19, max_mem_intv=20, cap=cap), B),
        (k2.smem_round3_core, plain.smem_round3_chain, (di, q, lens),
         dict(min_seed_len=19, max_mem_intv=3, cap=cap), B),
    ]
    for core, ref, args, kw, lanes in calls:
        steps = torch.zeros(lanes, dtype=torch.int32, device=cuda)
        got = core(*args, **kw, steps_out=steps)
        torch.cuda.synchronize()
        _same_smems(got, ref(*args, **kw))
        assert int(got.n.sum()) > 10
        assert bool(got.overflow.any()) == (cap == 1)
        if lanes == B:
            # the long chain of a group of four lanes takes ten times the
            # steps of the short reads beside it
            st = steps.cpu().numpy()
            short = np.isin(np.arange(B) % 8, (1, 2, 3))
            assert st[0::8].min() >= 10 * np.median(st[short])
            assert st[lh == 0].max() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(192, 256), (64, 128), (320, 512),
                                   (256, 384)],
                         ids=["192x256", "64x128", "320x512", "256x384"])
@pytest.mark.parametrize("gaps", [dict(o_del=6, e_del=1, o_ins=6, e_ins=1),
                                  dict(o_del=4, e_del=2, o_ins=7, e_ins=1)],
                         ids=["default", "skewed"])
def test_global_align_kernel_matches_plain_on_edge_lanes(cuda, gaps, shape):
    """K3's two outputs on ``utils.sim.ga_edge_lanes``: w = -1, 0 and
    >= Q + T, the corner outside the band, qlen and tlen 0 and 1,
    nseg > GA_K, long leading and trailing deletions, M = 1103 (a
    multiple of no warp or block size) and M = 1; at 192x256, 320x512
    and 256x384 (the wide bucket's flat SAM windows, whose full-matrix
    store needs more than 48 KB of shared memory a block) the second
    launch takes the wide lanes, at 64x128 there is none."""
    from tpubwa_torch.align.flatsam import GA_K, _ga_rows, _ga_rows_plain
    from tpubwa_torch.ops import global_align_cuda as k3
    from tpubwa_torch.ops.global_align import global_align_cigar_batch
    from tpubwa_torch.utils.sim import ga_edge_lanes

    Q, T = shape
    qD, tD, rows, qlen, tlen, w = ga_edge_lanes(1, Q, T)
    mat = OPT.score_matrix()
    dev = [torch.as_tensor(a, device=cuda)
           for a in (qD, tD, rows, qlen, tlen, w, mat)]
    for sel in (slice(None), slice(17, 18)):
        args = dev[:2] + [a[sel] for a in dev[2:6]] + dev[6:]
        got = _ga_rows(*args, **gaps)
        torch.cuda.synchronize()
        want = _ga_rows_plain(*args, **gaps, ga_k=GA_K)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.cpu(), want.cpu())
    assert int((want[:, 1] > GA_K).sum()) >= 0
    sub = rows
    args = [torch.as_tensor(a, device=cuda) for a in (
        qD[sub].astype(np.int32), qlen, tD[sub].astype(np.int32), tlen, mat,
        w)]
    got = k3.global_align_cigar_core(*args, **gaps)
    torch.cuda.synchronize()
    want = global_align_cigar_batch(*args, **gaps)
    assert torch.equal(got.score.cpu(), want.score.cpu())
    assert torch.equal(got.steps.cpu(), want.steps.cpu())


@pytest.mark.cuda
def test_global_align_kernel_refuses_what_it_cannot_take(cuda):
    """A query wider than 320 columns or a pack of more than 64 segments
    raises; nothing falls back to the plain version."""
    from tpubwa_torch.ops import global_align_cuda as k3

    z = torch.zeros((2, 384), dtype=torch.int8, device=cuda)
    one = torch.ones(2, dtype=torch.int32, device=cuda)
    rows = torch.arange(2, device=cuda)
    kw = dict(o_del=6, e_del=1, o_ins=6, e_ins=1)
    with pytest.raises(ValueError, match="Q=384"):
        k3.ga_pack(z, z, rows, one, one, one, OPT.score_matrix(), **kw,
                   ga_k=24)
    with pytest.raises(ValueError, match="ga_k"):
        k3.ga_pack(z[:, :64], z, rows, one, one, one, OPT.score_matrix(),
                   **kw, ga_k=65)


@pytest.mark.cuda
def test_threads_se_matches_single_on_card(cuda, tmp_path):
    import io

    from tpubwa_torch.align.pipeline import align_fastq
    from tpubwa_torch.utils.sim import golden_fixture

    ref, se_fq, _, _ = golden_fixture(str(tmp_path))
    texts = []
    for threads in (1, 4):
        out = io.StringIO()
        assert align_fastq(ref, se_fq, None, out, device="cuda",
                           batch_reads=32, threads=threads) == 0
        texts.append(out.getvalue())
    assert texts[0] == texts[1]


@pytest.mark.cuda
@pytest.mark.parametrize("shard_sa", [False, True], ids=["copied-sa",
                                                         "sharded-sa"])
@pytest.mark.parametrize("cards", ["one-card", "every-card"])
def test_mesh_matches_single_on_card(cuda, tmp_path, cards, shard_sa):
    """A mesh of two shards on ``cuda:0``, or one shard on each visible
    card (skipped with fewer than two), SE and PE of the golden fixture
    with the SA copied or sharded, writes the one-device SAM and launches
    K2's first round once a shard and batch."""
    import dataclasses
    import io

    from tpubwa_torch.align.pair import align_pe_fastq
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.ops import smem_chain_cuda
    from tpubwa_torch.utils.sim import golden_fixture

    n_cards = torch.cuda.device_count()
    if cards == "every-card" and n_cards < 2:
        pytest.skip("needs two or more cards")
    mesh = (["cuda:0"] * 2 if cards == "one-card"
            else [f"cuda:{i}" for i in range(n_cards)])
    ref, se_fq, fq1, fq2 = golden_fixture(str(tmp_path))
    idx = FMIndex.load(ref)
    opt = MemOptions(batch_reads=64)
    texts = []
    for device, o in (("cuda", opt), (mesh, dataclasses.replace(
            opt, shard_sa=shard_sa))):
        al = Aligner(idx, o, device=device)
        n0 = smem_chain_cuda.smem_round1_core.launches
        se, pe = io.StringIO(), io.StringIO()
        run_se_pipeline(al, se_fq, se)
        k2 = smem_chain_cuda.smem_round1_core.launches - n0
        assert align_pe_fastq(al, fq1, fq2, pe) == 0
        texts.append((se.getvalue(), k2, pe.getvalue()))
    (se1, k1, pe1), (se2, k2, pe2) = texts
    assert se1 == se2 and pe1 == pe2
    assert k2 == len(mesh) * k1 > 0
