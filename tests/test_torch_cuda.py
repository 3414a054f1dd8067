"""The CUDA kernels against their plain PyTorch versions, on the card.

K1 (csrc/extend.cu) and K1b (csrc/extend_b.cu) against ``_extend_core``,
K4 (csrc/localsw.cu) against ``localsw_batch``, K5 (csrc/sa_sampled.cu)
against ``sa_lookup_sampled``, exact on every field, and each wrapper's
launch counter; and a ``-t 4`` SE run equal to ``-t 1`` on the golden
fixture.  Needs a CUDA card and nvcc (the kernels
are compiled on first use); skipped where torch sees no GPU.  Imports no
jax, so it runs on a machine without it:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions

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
                                   (2048, 192, 768)])
def test_kernel_matches_plain_on_card(cuda, J, Q, T):
    from tpubwa_torch.ops.extend_cuda import extend_core

    _check_extend(extend_core, cuda, J, Q, T)


@pytest.mark.cuda
@pytest.mark.parametrize("J,Q,T", [(1, 8, 8), (301, 70, 96),
                                   (2048, 192, 768)])
def test_warp_kernel_matches_plain_on_card(cuda, J, Q, T):
    from tpubwa_torch.ops.extend_cuda import extend_core_b

    _check_extend(extend_core_b, cuda, J, Q, T)


@pytest.mark.cuda
@pytest.mark.parametrize("J,Q,T", [(1, 8, 8), (300, 100, 256),
                                   (1024, 192, 1024)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("shift", [2, 4, 5])
def test_sa_sampled_kernel_matches_plain_on_card(cuda, shift, wide):
    from tpubwa.index.fmindex import FMIndex
    from tpubwa.io.fasta import Contig
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
def test_threads_se_matches_single_on_card(cuda, tmp_path):
    import io
    import os
    import sys

    from tpubwa_torch.align.pipeline import align_fastq

    sys.path.insert(0, os.path.dirname(__file__))
    from test_golden_sam import _build_fixture

    ref, se_fq, _, _ = _build_fixture(str(tmp_path))
    texts = []
    for threads in (1, 4):
        out = io.StringIO()
        assert align_fastq(ref, se_fq, None, out, device="cuda",
                           batch_reads=32, threads=threads) == 0
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
