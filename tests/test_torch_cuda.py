"""The extension CUDA kernel against its plain PyTorch version, on the card.

Needs a CUDA card and nvcc (the kernel is compiled from
tpubwa_torch/csrc/extend.cu on first use); skipped where torch sees no
GPU.  Imports no jax, so it runs on a machine without it:

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


@pytest.mark.cuda
@pytest.mark.parametrize("J,Q,T", [(1, 8, 8), (300, 64, 96),
                                   (2048, 192, 768)])
def test_kernel_matches_plain_on_card(cuda, J, Q, T):
    from tpubwa_torch.ops.extend import _extend_core
    from tpubwa_torch.ops.extend_cuda import extend_core

    rng = np.random.default_rng(J)
    q, ql, t, tl, w, h0, bonus = (torch.as_tensor(a, device=cuda)
                                  for a in _jobs(rng, J, Q, T))
    mat = torch.as_tensor(OPT.score_matrix(), device=cuda)
    n0 = extend_core.launches
    got = extend_core(q, ql, t, tl, mat, w, h0, bonus, **KW)
    torch.cuda.synchronize()
    assert extend_core.launches == n0 + 1
    want = _extend_core(q, ql, t, tl, mat, w, h0, bonus, **KW)
    for g, p in zip(got, want):
        assert torch.equal(g.cpu(), p.cpu())
