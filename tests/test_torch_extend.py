"""The port's extension DP against the JAX package.

The plain ``extend_core`` (what the wrapper runs on the CPU, and what the
CUDA kernel is held to on the card) must equal, exactly on every lane:
``tpubwa.ops.extend._extend_core``, the K1 Pallas kernel
(``_extend_core_pallas``, transposed layout) and the K1b Pallas kernel
(``_extend_core_pallas_b``), both in interpret mode.  The job programs
``extend_jobs_left/right`` must equal the JAX ``[8|7, J]`` outputs on the
same descriptors.
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
MAT = OPT.score_matrix()


def _lanes(seed, B=64, Q=32, T=48):
    """Extension lanes with real alignments (query = mutated target
    prefix, some with an indel), N codes, empty lanes and every band."""
    rng = np.random.default_rng(seed)
    q = np.full((B, Q), 4, np.int32)
    t = rng.integers(0, 4, (B, T)).astype(np.int32)
    qlen = rng.integers(1, Q + 1, B).astype(np.int32)
    tlen = rng.integers(1, T + 1, B).astype(np.int32)
    for b in range(B):
        qq = t[b, :Q].copy()
        mm = rng.random(Q) < rng.choice([0.02, 0.1, 0.5])
        qq[mm] = (qq[mm] + 1) % 4
        if b % 5 == 0:
            p = int(rng.integers(1, Q - 3))
            qq = np.concatenate([qq[:p], qq[p + 2:], qq[:2]])
        if b % 7 == 0:       # a matching head, then noise: z-drop lanes
            qq[Q // 3:] = rng.integers(0, 4, Q - Q // 3)
        q[b] = qq
    q[rng.random((B, Q)) < 0.03] = 4
    t[rng.random((B, T)) < 0.03] = 4
    qlen[0] = 0
    tlen[1] = 0
    qlen[2] = tlen[2] = 0
    w = rng.choice([1, 3, 10, 100], B).astype(np.int32)
    h0 = rng.integers(1, 60, B).astype(np.int32)
    h0[3::9] = 200
    bonus = np.full(B, OPT.pen_clip5, np.int32)
    return q, qlen, t, tlen, w, h0, bonus


def _kw(zdrop):
    return dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
                e_ins=OPT.e_ins, zdrop=zdrop, mat_max=OPT.a)


def _rows(res):
    return np.stack([np.asarray(f).astype(np.int64) for f in res])


@pytest.mark.parametrize("zdrop", [100, 8, 0])
def test_plain_core_equals_jax_and_both_pallas_kernels(zdrop):
    from tpubwa.ops.extend import extend_batch
    from tpubwa.ops.extend_pallas import (_extend_core_pallas,
                                          _extend_core_pallas_b)
    from tpubwa_torch.ops.extend_cuda import extend_core

    q, qlen, t, tlen, w, h0, bonus = _lanes(zdrop)
    kw = _kw(zdrop)
    j = [jnp.asarray(a) for a in (q, qlen, t, tlen, MAT, w, h0, bonus)]
    want = _rows(extend_batch(*j, **kw))
    k1 = _rows(_extend_core_pallas(*j, **kw, interpret=True))
    k1b = _rows(_extend_core_pallas_b(*j, **kw, interpret=True))
    n0 = extend_core.launches
    got = _rows(extend_core(*(torch.as_tensor(a) for a in
                              (q, qlen, t, tlen, MAT, w, h0, bonus)), **kw))
    assert extend_core.launches == n0      # CPU tensors: plain version
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, k1)
    np.testing.assert_array_equal(got, k1b)
    # the lanes exercise what they are meant to
    assert (got[0] == h0)[qlen * tlen == 0].all()
    assert (got[4] == -1)[qlen * tlen == 0].all()
    if zdrop == 8:
        assert ((got[2] < tlen) & (got[0] > h0)).any()


def test_band_clamp_matches_jax():
    from tpubwa.ops.extend import clamp_band_batch as jax_clamp
    from tpubwa_torch.ops.extend import clamp_band_batch

    rng = np.random.default_rng(3)
    w = rng.integers(0, 300, 500).astype(np.int32)
    qlen = rng.integers(0, 200, 500).astype(np.int32)
    bonus = rng.integers(0, 10, 500).astype(np.int32)
    args = (OPT.a, OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins)
    want = np.asarray(jax_clamp(jnp.asarray(w), jnp.asarray(qlen), *args,
                                jnp.asarray(bonus)))
    got = clamp_band_batch(torch.as_tensor(w), torch.as_tensor(qlen), *args,
                           torch.as_tensor(bonus)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(21)
    L = 6000
    codes = rng.integers(0, 4, L).astype(np.uint8)
    idx = FMIndex.build([Contig("c1", L, 0)], codes)
    return idx, codes


def _descriptors(idx, codes, seed, J=96, B=16, Lr=150):
    """Valid job descriptors on both strands (windows stay on one
    strand, as native ext_prepare clamps them) and a read batch."""
    from tpubwa.utils.dna import revcomp_codes

    rng = np.random.default_rng(seed)
    l_pac = idx.l_pac
    text = np.concatenate([codes, revcomp_codes(codes)])
    reads = np.full((B, 160), 4, np.int32)
    lens = np.full(B, Lr, np.int32)
    lens[3] = 90
    starts = rng.integers(0, 2 * l_pac - Lr, B)
    for b in range(B):
        r = text[starts[b]:starts[b] + lens[b]].astype(np.int32).copy()
        mm = rng.random(r.size) < 0.03
        r[mm] = (r[mm] + 1) % 4
        reads[b, :lens[b]] = r
    rd = rng.integers(0, B, J).astype(np.int32)
    slen = rng.integers(19, 40, J).astype(np.int32)
    qbeg = np.minimum(rng.integers(0, Lr - 19, J), lens[rd] - slen
                      ).astype(np.int32)
    rev = rng.random(J) < 0.5
    lo = np.where(rev, l_pac, 0)
    hi = np.where(rev, 2 * l_pac, l_pac)
    rbeg = (lo + rng.integers(0, l_pac - 60, J)).astype(np.int64)
    rbeg = np.minimum(rbeg, hi - slen)
    rmax0 = np.maximum(lo, rbeg - rng.integers(0, 900, J))
    rmax1 = np.minimum(hi, rbeg + slen + rng.integers(0, 900, J))
    h0 = (slen * OPT.a).astype(np.int32)
    h0[::11] = 0
    return reads, lens, rd, qbeg, slen, rbeg, rmax0, rmax1, h0


def test_extend_jobs_left_right_match_jax(genome):
    from tpubwa.ops.extend_flat import (extend_jobs_left as jax_left,
                                        extend_jobs_right as jax_right)
    from tpubwa.ops.fm import DeviceIndex as JaxDI
    from tpubwa_torch.ops.extend_flat import (extend_jobs,
                                              extend_jobs_left,
                                              extend_jobs_right)
    from tpubwa_torch.ops.fm import DeviceIndex

    idx, codes = genome
    reads, lens, rd, qbeg, slen, rbeg, rmax0, rmax1, h0 = _descriptors(
        idx, codes, 5)
    jdi = JaxDI.from_host(idx)
    tdi = DeviceIndex.from_host(idx, "cpu")
    kw = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
              e_ins=OPT.e_ins, zdrop=OPT.zdrop, mat_max=OPT.a, w0=OPT.w)
    J = jnp.asarray
    want_l = np.asarray(jax_left(
        jdi, J(reads), J(lens), J(rd), J(qbeg), J(rbeg), J(rmax0), J(h0),
        J(MAT), pen_clip5=OPT.pen_clip5, **kw)).astype(np.int32)
    want_r = np.asarray(jax_right(
        jdi, J(reads), J(lens), J(rd), J(qbeg), J(slen), J(rbeg), J(rmax1),
        J(want_l[7]), J(MAT), pen_clip3=OPT.pen_clip3, **kw)
    ).astype(np.int32)
    T = torch.as_tensor
    got_l = extend_jobs_left(
        tdi, T(reads), T(lens), T(rd), T(qbeg), T(rbeg), T(rmax0), T(h0),
        T(MAT), pen_clip5=OPT.pen_clip5, **kw).numpy()
    got_r = extend_jobs_right(
        tdi, T(reads), T(lens), T(rd), T(qbeg), T(slen), T(rbeg), T(rmax1),
        T(got_l[7]), T(MAT), pen_clip3=OPT.pen_clip3, **kw).numpy()
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_r, want_r)
    fused = extend_jobs(
        tdi, T(reads), T(lens), T(rd), T(qbeg), T(slen), T(rbeg), T(rmax0),
        T(rmax1), T(h0), T(MAT), pen_clip5=OPT.pen_clip5,
        pen_clip3=OPT.pen_clip3, **kw).numpy()
    np.testing.assert_array_equal(
        fused, np.concatenate([want_l[:6], want_r[:6], want_l[6:7],
                               want_r[6:7]]))


def test_retry_band_path_matches_jax():
    """Narrow starting band: lanes whose max_off crosses 3/4 of it rerun
    at double band (bwa's MAX_BAND_TRY), through the shared _with_retry."""
    from tpubwa.ops.extend import extend_seed_batch
    from tpubwa_torch.ops.extend import _extend_core
    from tpubwa_torch.ops.extend_flat import _with_retry

    q, qlen, t, tlen, _, h0, bonus = _lanes(11)
    # half the lanes align off the diagonal (query = target shifted by
    # 1..3): their best cell lies max_off >= 1 = 3/4 of the band away
    B, Q = q.shape
    for b in range(0, B, 2):
        off = 1 + b % 3
        q[b] = t[b, off:off + Q]
        qlen[b], tlen[b], h0[b] = Q, t.shape[1], 30
    w0 = np.full(B, 2, np.int32)
    kw = _kw(OPT.zdrop)
    J = jnp.asarray
    want = extend_seed_batch(J(q), J(qlen), J(t), J(tlen), J(q), J(qlen * 0),
                             J(t), J(tlen), J(MAT), J(w0), J(h0), J(bonus),
                             J(bonus), **kw)
    T = torch.as_tensor
    got, aw = _with_retry(_extend_core, T(q), T(qlen), T(t), T(tlen),
                          T(MAT), T(w0), T(h0), T(bonus), -1, kw)
    np.testing.assert_array_equal(_rows(got), _rows(want.left))
    np.testing.assert_array_equal(aw.numpy(), np.asarray(want.aw0))
    assert (aw.numpy() == 4).any()


# ------------ what K1's and K1b's wrapper does around the kernels ----

def _edge(zdrop, Q=40, T=64):
    from tpubwa_torch.utils.sim import extend_edge_jobs

    return extend_edge_jobs(zdrop, Q, T)


@pytest.mark.parametrize("zdrop", [100, 8])
def test_edge_jobs_plain_equals_jax(zdrop):
    """The adversarial job set (qlen 0/1/31/32/33/Q, tlen 0/1/T, w 0 and
    >= qlen, all-N, ties, z-drops) on the plain version and the JAX one."""
    from tpubwa.ops.extend import extend_batch
    from tpubwa_torch.ops.extend import _extend_core

    q, qlen, t, tlen, w, h0, bonus = _edge(zdrop)
    kw = _kw(zdrop)
    want = _rows(extend_batch(*(jnp.asarray(a) for a in (
        q, qlen, t, tlen, MAT, w, h0, bonus)), **kw))
    got = _rows(_extend_core(*(torch.as_tensor(a) for a in (
        q, qlen, t, tlen, MAT, w, h0, bonus)), **kw))
    np.testing.assert_array_equal(got, want)
    dead = (qlen == 0) | (tlen == 0)
    assert dead.any() and (got[0] == h0)[dead].all()
    assert (got[2] < tlen)[~dead].any()          # some job ends early
    assert (got[3] > 0).any() and (got[4] == -1)[dead].all()


@pytest.mark.parametrize("seed", [0, 1])
def test_job_order_plain_scatter_equals_plain(seed):
    """K1 runs the jobs in ``job_order``'s order and writes each result to
    its job's slot: ordering, the plain version, then the scatter must be
    the plain version (and the JAX function), dead lanes and ties
    included; the keys put long jobs first, dead ones last, and every job
    into a size class that holds its qlen."""
    from tpubwa.ops.extend import extend_batch
    from tpubwa_torch.ops.extend import _extend_core, clamp_band_batch
    from tpubwa_torch.ops.extend_cuda import (KEY_SHIFT, SIZE_CLASSES,
                                              job_keys, job_keys_core,
                                              job_order, size_class)

    q, qlen, t, tlen, w, h0, bonus = _edge(seed) if seed else _lanes(4)
    qlen[5:9] = qlen[5]                            # equal keys
    tlen[5:9] = tlen[5]
    Q, T = q.shape[1], t.shape[1]
    kw = _kw(OPT.zdrop)
    T_ = torch.as_tensor
    args = [T_(a) for a in (q, qlen, t, tlen, MAT, w, h0, bonus)]
    want = _rows(_extend_core(*args, **kw))
    wc = clamp_band_batch(T_(w), T_(qlen), OPT.a, OPT.o_del, OPT.e_del,
                          OPT.o_ins, OPT.e_ins, T_(bonus))
    keys = job_keys(T_(qlen), T_(tlen), wc, Q, T)
    gaps = {k: v for k, v in kw.items() if k != "zdrop"}
    wc2, keys2 = job_keys_core(T_(qlen), T_(tlen), T_(w), T_(bonus), Q, T,
                               **gaps)
    assert torch.equal(wc2, wc) and torch.equal(keys2, keys)
    skeys, o = job_order(keys)
    assert skeys.dtype == torch.int32 and o.dtype == torch.int64
    assert sorted(o.tolist()) == list(range(len(qlen)))
    assert torch.equal(skeys, keys[o])
    assert bool((skeys[:-1] >= skeys[1:]).all())
    dead = (qlen == 0) | (tlen == 0)
    n_live = int((~dead).sum())
    assert not dead[o.numpy()[:n_live]].any() and dead[o.numpy()[n_live:]].all()
    assert (keys.numpy()[~dead] >> KEY_SHIFT == qlen[~dead]).all()

    cls = size_class(skeys).numpy()
    assert (np.diff(cls) >= 0).all()               # classes are contiguous
    assert (cls[n_live:] == len(SIZE_CLASSES)).all()
    for c, (_, lanes, cols) in enumerate(SIZE_CLASSES):
        assert (qlen[o.numpy()][cls == c] <= lanes * cols).all()

    perm = [a[o] if a.dim() and a.shape[0] == len(qlen) else a for a in args]
    res = _extend_core(*perm, **kw)
    got = np.empty_like(want)
    got[:, o.numpy()] = _rows(res)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _rows(extend_batch(
        *(jnp.asarray(a) for a in (q, qlen, t, tlen, MAT, w, h0, bonus)),
        **kw)))


def test_size_classes_hold_every_qlen():
    from tpubwa_torch.ops.extend_cuda import (KEY_SHIFT, MAX_Q, SIZE_CLASSES,
                                              job_keys, size_class)

    qlen = torch.arange(0, MAX_Q + 40, dtype=torch.int32)
    one = torch.ones_like(qlen)
    keys = job_keys(qlen, 500 * one, 100 * one, MAX_Q, 768)
    cls = size_class(keys).tolist()
    cap = [lanes * cols for _, lanes, cols in SIZE_CLASSES]
    for ql, k, c in zip(qlen.tolist(), keys.tolist(), cls):
        if ql == 0:
            assert k == 0 and c == len(SIZE_CLASSES)
        else:
            assert k >> KEY_SHIFT == min(ql, MAX_Q) <= cap[c]
            assert c == len(SIZE_CLASSES) - 1 or k >> KEY_SHIFT > cap[c + 1]
    # tlen 0, or a negative length, is a dead job whatever its qlen
    assert job_keys(qlen, 0 * one, one, MAX_Q, 768).max() == 0
    assert job_keys(-qlen, one, one, MAX_Q, 768).max() == 0
    # rows never spill into the qlen bits
    big = job_keys(qlen, (1 << 20) * one, (1 << 20) * one, MAX_Q, 1 << 20)
    assert torch.equal(big >> KEY_SHIFT, qlen.clamp(max=MAX_Q))


def test_codes_are_read_as_given():
    """uint8 and int32 codes with unit stride along a row go to the kernel
    as they are, a column slice included; anything else is copied to
    contiguous int32 with the same values."""
    from tpubwa_torch.ops.extend_cuda import as_code_pair, as_codes

    buf = torch.as_tensor(np.random.default_rng(0).integers(
        0, 5, (7, 30)).astype(np.int32))
    view = buf[:, 3:19]                            # rows 30 ints apart
    assert as_codes(view) is view and as_codes(buf) is buf
    b8 = buf.to(torch.uint8)
    assert as_codes(b8) is b8 and as_codes(b8[:, 2:9]) is not None
    assert as_codes(b8[:, 2:9]).stride(0) == 30
    assert as_codes(buf[:1, ::2]).shape == (1, 15)
    for odd in (buf[:, ::2], buf.T, buf.to(torch.int64), buf.to(torch.int8)):
        got = as_codes(odd)
        assert got.dtype == torch.int32 and got.is_contiguous()
        assert torch.equal(got, odd.to(torch.int32))
    # a kernel instance reads one code type: a mixed pair becomes int32
    qc, tc = as_code_pair(b8[:, :9], view)
    assert qc.dtype == tc.dtype == torch.int32 and tc is view
    assert torch.equal(qc, buf[:, :9])
    qc, tc = as_code_pair(b8[:, :9], b8[:, 9:])
    assert qc.dtype == tc.dtype == torch.uint8 and qc.stride(0) == 30


@pytest.mark.parametrize("kernel", ["extend", "extend_b"])
def test_kernel_wrapper_refuses_what_the_kernel_cannot_hold(kernel):
    """K1's and K1b's launch path checks its inputs before it builds
    anything: a query wider than its largest group, a matrix that is not
    5 x 5, and per-job vectors of the wrong length raise; so does an
    ablation variant of K1b at a width it is not built for."""
    from tpubwa_torch.ops.extend_cuda import MAX_Q, _launch

    def call(Q=8, J=4, mat=MAT, n=None, variant=None):
        n = J if n is None else n
        z = torch.zeros(n, dtype=torch.int32)
        return _launch(kernel, torch.zeros((J, Q), dtype=torch.int32), z,
                       torch.zeros((J, 9), dtype=torch.int32), z, mat, z,
                       z, z, **_kw(100), variant=variant)

    with pytest.raises(ValueError, match="Q="):
        call(Q=MAX_Q + 1)
    with pytest.raises(ValueError, match="5x5"):
        call(mat=np.zeros(24, np.int32))
    with pytest.raises(ValueError, match="qlen"):
        call(n=3)
    if kernel == "extend_b":
        with pytest.raises(ValueError, match="ablation"):
            call(Q=100, variant=1)


@pytest.mark.parametrize("codes", ["int32", "bytes", "slices"])
def test_k1b_takes_k1s_jobs_codes_and_scores(codes):
    """K1b is launched with what K1 is (``kernel_args``): the band clamp
    and sort keys of ``job_keys_core``, ``job_order``'s order (the kernel
    finds the size classes in the sorted keys), the codes where they lie
    (bytes, or column slices of a wider int32 buffer, at their strides),
    and the matrix as a tensor on the jobs' device (no host read).  The
    order, the plain version and the scatter give the plain result; every
    job's qlen fits the columns of its class."""
    from tpubwa_torch.ops.extend import _extend_core, clamp_band_batch
    from tpubwa_torch.ops.extend_cuda import (SIZE_CLASSES, job_keys,
                                              job_order, kernel_args,
                                              size_class)

    q, qlen, t, tlen, w, h0, bonus = _edge(5)
    T_ = torch.as_tensor
    qt, tt = T_(q), T_(t)
    if codes == "bytes":
        qt, tt = qt.to(torch.uint8), tt.to(torch.uint8)
    elif codes == "slices":
        buf = torch.cat([qt, tt, qt], dim=1)
        qt, tt = buf[:, :q.shape[1]], buf[:, q.shape[1]:-q.shape[1]]
    kw = _kw(OPT.zdrop)
    gaps = {k: v for k, v in kw.items() if k != "zdrop"}
    args = [qt, T_(qlen), tt, T_(tlen), MAT, T_(w), T_(h0), T_(bonus)]
    tensors, ints = kernel_args(*args, **gaps)
    qc, tc, ql, tl, wc, hh, skeys, order, start, mat, out = tensors
    assert qc is qt and tc is tt                   # read where they lie
    J, Q, T = len(qlen), q.shape[1], t.shape[1]
    assert ints == (J, Q, T, qt.stride(0), tt.stride(0), qt.element_size())
    assert torch.is_tensor(mat) and mat.dtype == torch.int32
    assert torch.equal(mat, T_(MAT).reshape(-1).to(torch.int32))
    want_wc = clamp_band_batch(T_(w), T_(qlen), OPT.a, OPT.o_del,
                               OPT.e_del, OPT.o_ins, OPT.e_ins, T_(bonus))
    assert torch.equal(wc, want_wc)
    want_keys, want_order = job_order(job_keys(T_(qlen), T_(tlen), want_wc,
                                               Q, T))
    assert torch.equal(skeys, want_keys) and torch.equal(order, want_order)
    assert start.numel() == len(SIZE_CLASSES) + 2 and out.shape == (6, J)
    cls = size_class(skeys).numpy()
    for c, (_, lanes, cols) in enumerate(SIZE_CLASSES):
        assert (qlen[order.numpy()][cls == c] <= lanes * cols).all()
    want = _rows(_extend_core(*args, **kw))
    perm = [a[order] if torch.is_tensor(a) and a.dim() and a.shape[0] == J
            else a for a in args]
    got = np.empty_like(want)
    got[:, order.numpy()] = _rows(_extend_core(*perm, **kw))
    np.testing.assert_array_equal(got, want)
