"""Mate-rescue local SW as a hand-written CUDA kernel (``csrc/localsw.cu``).

Replaces the XLA scan ``tpubwa.ops.localsw.localsw_batch``.  The source
is built by ``ops.cuda_build`` at first use and loaded with ctypes.

The kernel gives a warp to a job and walks the rows as a wavefront with
the DP state in registers; it reads the codes as they are given
(``as_codes``: uint8 or int32, rows at their own stride) and holds at most
8 query columns a lane, so Q <= ``MAX_Q``.

``localsw_core`` has ``ops.localsw.localsw_batch``'s contract.  For
tensors on the CPU it runs that plain version; for CUDA tensors it
launches the kernel or raises.  ``localsw_core.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from tpubwa_torch.ops import cuda_build
from tpubwa_torch.ops.extend_cuda import as_code_pair
from tpubwa_torch.ops.localsw import LocalSWResult, localsw_batch

MAX_Q = 256     # a lane holds ceil(qlen / 32) <= 8 columns
# a block keeps 4 x T row maxima (ints) and 4 x T target bytes in its
# 227 KB of shared memory
MAX_T = 13000

_fn = None


def build() -> str:
    """Build (unless built) and load the kernel; returns nvcc's report
    for a fresh build, "" otherwise."""
    global _fn
    with cuda_build.lock("localsw"):
        if _fn is not None:
            return ""
        lib, report = cuda_build.build("localsw")
        fn = lib.tpubwa_localsw_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        _fn = fn
        return report


def _launch(query, qlen, target, tlen, mat, minsc, endsc, *, o_del, e_del,
            o_ins, e_ins) -> LocalSWResult:
    dev = query.device
    J, Q = query.shape
    T = target.shape[1]
    if target.shape[0] != J or target.device != dev:
        raise ValueError(f"target {tuple(target.shape)} on {target.device}"
                         f" does not match query [{J}, Q] on {dev}")
    for name, v in (("qlen", qlen), ("tlen", tlen), ("minsc", minsc),
                    ("endsc", endsc)):
        if v.shape != (J,) or v.device != dev:
            raise ValueError(f"{name}: expected shape ({J},) on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
    if not (1 <= Q <= MAX_Q and 1 <= T <= MAX_T):
        raise ValueError(f"local SW: Q={Q}, T={T}: needs 1 <= Q <= {MAX_Q} "
                         "(a lane holds at most 8 columns) and 1 <= T <= "
                         f"{MAX_T} (row maxima and the target wait in shared "
                         "memory)")
    I32 = torch.int32
    m = torch.as_tensor(mat, device=dev).reshape(-1).to(I32).contiguous()
    if m.numel() != 25:
        raise ValueError(f"mat: expected a 5x5 matrix, got {m.numel()} "
                         "values")
    build()
    qc, tc = as_code_pair(query, target)
    ins = [qc, tc] + [a.to(I32).contiguous()
                      for a in (qlen, tlen, minsc, endsc)]
    out = torch.empty((4, J), dtype=I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fn(*(a.data_ptr() for a in ins), m.data_ptr(), out.data_ptr(),
                 J, Q, T, qc.stride(0), tc.stride(0), qc.element_size(),
                 o_del, e_del, o_ins, e_ins, stream)
    if rc != 0:
        raise RuntimeError(f"local SW kernel launch failed: CUDA error {rc}")
    return LocalSWResult(*out.unbind(0))


def localsw_core(query: torch.Tensor, qlen: torch.Tensor,
                 target: torch.Tensor, tlen: torch.Tensor, mat,
                 minsc: torch.Tensor, endsc: torch.Tensor, *, o_del: int,
                 e_del: int, o_ins: int, e_ins: int) -> LocalSWResult:
    """Batched local SW (``ops.localsw.localsw_batch``'s contract): the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins)
    if query.device.type == "cpu":
        return localsw_batch(query, qlen, target, tlen, mat, minsc, endsc,
                             **kw)
    if query.device.type != "cuda":
        raise ValueError(f"no local SW kernel for device {query.device}")
    res = _launch(query, qlen, target, tlen, mat, minsc, endsc, **kw)
    cuda_build.count_launch(localsw_core)
    return res


localsw_core.launches = 0
