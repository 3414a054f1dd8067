"""The sampled-SA LF-walk as a hand-written CUDA kernel
(``csrc/sa_sampled.cu``, K5).

Replaces the XLA loop ``tpubwa.ops.fm.sa_lookup_sampled``.  The source is
built by ``ops.cuda_build`` at first use and loaded with ctypes; one
library holds the int32 (narrow) and int64 (wide) instantiations.

``sa_lookup_sampled_core`` has ``ops.fm.sa_lookup_sampled``'s contract,
with its optional count of live rows (a device tensor: the caller does
not wait for it, and rows at or past it come back 0).  For tensors on the
CPU it runs that plain version; for CUDA tensors it launches the kernel
or raises.  ``sa_lookup_sampled_core.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from tpubwa_torch.ops import cuda_build
from tpubwa_torch.ops.fm import DeviceIndex, SampledSA, sa_lookup_sampled

_fn = None


def build() -> str:
    """Build (unless built) and load the kernel; returns nvcc's report
    for a fresh build, "" otherwise."""
    global _fn
    with cuda_build.lock("sa_sampled"):
        if _fn is not None:
            return ""
        lib, report = cuda_build.build("sa_sampled")
        fn = lib.tpubwa_sa_sampled_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        _fn = fn
        return report


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous and starting on a 16-byte boundary (the kernel reads
    table rows as 16-byte vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(di: DeviceIndex, ss: SampledSA, rows: torch.Tensor, shift: int,
            n_live: torch.Tensor | None) -> torch.Tensor:
    dt = rows.dtype
    if dt not in (torch.int32, torch.int64):
        raise ValueError(f"rows: expected int32 or int64, got {dt}")
    if rows.numel() >= 1 << 31:
        raise ValueError(f"{rows.numel()} rows: a call takes fewer than "
                         "2^31")
    tabs = dict(cp=di.cp, L2=di.L2, blocks=ss.blocks, vals=ss.vals)
    for name, v in tabs.items():
        if v.dtype != dt or v.device != rows.device:
            raise ValueError(f"{name}: expected {dt} on {rows.device} like "
                             f"the rows, got {v.dtype} on {v.device}")
    if tuple(ss.blocks.shape[1:]) != (4,) or tuple(di.cp.shape[1:]) != (8,):
        raise ValueError(f"blocks {tuple(ss.blocks.shape)} / cp "
                         f"{tuple(di.cp.shape)}: expected rows of 4 / 8")
    if not 0 <= shift <= 30:
        raise ValueError(f"shift {shift} out of range [0, 30]")
    if ss.vals.numel() == 0:
        raise ValueError("empty sampled SA")
    live = None
    if n_live is not None:
        if n_live.numel() != 1 or n_live.device != rows.device:
            raise ValueError(f"n_live: expected one value on {rows.device}, "
                             f"got {tuple(n_live.shape)} on {n_live.device}")
        live = n_live.reshape(1).to(torch.int64)    # a device op, no sync
    build()
    r = rows.contiguous()
    t = {k: _aligned(v) for k, v in tabs.items()}
    out = torch.empty_like(r)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        rc = _fn(r.data_ptr(), t["cp"].data_ptr(), t["blocks"].data_ptr(),
                 t["vals"].data_ptr(), t["L2"].data_ptr(), out.data_ptr(),
                 None if live is None else live.data_ptr(), r.numel(),
                 di.primary, t["vals"].numel(), 1 << shift,
                 int(dt == torch.int64), stream)
    if rc != 0:
        raise RuntimeError(f"sampled-SA kernel launch failed: CUDA error "
                           f"{rc}")
    return out


def sa_lookup_sampled_core(di: DeviceIndex, ss: SampledSA,
                           rows: torch.Tensor, shift: int,
                           n_live: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Suffix positions of rows via the sampled SA
    (``ops.fm.sa_lookup_sampled``'s contract, ``n_live`` included: rows
    at or past that count are 0): the plain version for CPU tensors, K5
    for CUDA tensors."""
    if rows.device.type == "cpu":
        return sa_lookup_sampled(di, ss, rows, shift, n_live)
    if rows.device.type != "cuda":
        raise ValueError(f"no sampled-SA kernel for device {rows.device}")
    res = _launch(di, ss, rows, shift, n_live)
    cuda_build.count_launch(sa_lookup_sampled_core)
    return res


sa_lookup_sampled_core.launches = 0
