"""The CUDA kernels against their plain PyTorch versions, on the card.

K1 (csrc/extend.cu) and K1b (csrc/extend_b.cu) against ``_extend_core``,
K4 (csrc/localsw.cu) against ``localsw_batch``, exact on every field, and
each wrapper's launch counter.  Needs a CUDA card and nvcc (the kernels
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
