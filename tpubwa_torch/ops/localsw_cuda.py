"""Mate-rescue local SW as a hand-written CUDA kernel (``csrc/localsw.cu``).

Replaces the XLA scan ``tpubwa.ops.localsw.localsw_batch``.  The source
is built by ``ops.cuda_build`` at first use and loaded with ctypes.

``localsw_core`` has ``ops.localsw.localsw_batch``'s contract.  For
tensors on the CPU it runs that plain version; for CUDA tensors it
launches the kernel or raises.  ``localsw_core.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from tpubwa_torch.ops import cuda_build
from tpubwa_torch.ops.localsw import LocalSWResult, localsw_batch

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
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
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
    build()
    I32 = torch.int32
    ins = [a.to(I32).contiguous() for a in (query, target, qlen, tlen,
                                            minsc, endsc)]
    m = torch.as_tensor(mat, device=dev).reshape(-1).to(I32).contiguous()
    if m.numel() != 25:
        raise ValueError(f"mat: expected a 5x5 matrix, got {m.numel()} "
                         "values")
    rowmax = torch.empty((T, J), dtype=I32, device=dev)
    out = torch.empty((4, J), dtype=I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fn(*(a.data_ptr() for a in ins), m.data_ptr(),
                 rowmax.data_ptr(), out.data_ptr(), J, Q, T, o_del, e_del,
                 o_ins, e_ins, stream)
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
