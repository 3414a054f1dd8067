"""Banded global alignment with traceback and CIGAR packing as a
hand-written CUDA kernel (``csrc/global_align.cu``, K3).

Replaces the XLA scans ``tpubwa.ops.global_align.global_align_batch`` /
``global_align_cigar_batch`` and the run-length pack of
``tpubwa.align.flatsam._ga_rows``.  The source is built by
``ops.cuda_build`` at first use and loaded with ctypes.

``global_align_cigar_core`` has ``ops.global_align
.global_align_cigar_batch``'s contract: for tensors on the CPU it runs
that plain version; for CUDA tensors it launches the kernel or raises.
``ga_pack`` is the kernel's other output, the int16 segment pack of
``align.flatsam._ga_rows`` over row-selected window buffers; it takes CUDA
tensors only (``_ga_rows`` keeps the plain version for CPU tensors).
Each counts its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from tpubwa_torch.ops import cuda_build
from tpubwa_torch.ops.global_align import (GlobalCigarResult,
                                           global_align_cigar_batch)

I32 = torch.int32
# persistent one-warp blocks per SM: bounds the direction-byte scratch
# (blocks * T * Q bytes) whatever the batch
BLOCKS_PER_SM = 16
_fn = None


def build() -> str:
    """Build (unless built) and load the kernel; returns nvcc's report
    for a fresh build, "" otherwise."""
    global _fn
    with cuda_build.lock("global_align"):
        if _fn is not None:
            return ""
        lib, report = cuda_build.build("global_align")
        fn = lib.tpubwa_global_align_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        _fn = fn
        return report


def _launch(qD, tD, rows, qlen, tlen, w, mat, Q: int, T: int, gaps: dict,
            ga_k: int, want_steps: bool):
    """One kernel launch over lanes ``rows`` of the int8 window buffers;
    returns the pack, or (score, steps)."""
    dev = qD.device
    if dev.type != "cuda":
        raise ValueError(f"no global-alignment kernel for device {dev}")
    M = rows.shape[0]
    for name, v, width in (("query", qD, Q), ("target", tD, T)):
        if (v.dim() != 2 or v.dtype != torch.int8 or v.shape[1] < width
                or v.device != dev or v.stride(1) != 1):
            raise ValueError(
                f"{name} windows: expected int8 [N, >= {width}] with unit "
                f"column stride on {dev}, got {v.dtype} {tuple(v.shape)}")
    if tD.shape[0] != qD.shape[0]:
        raise ValueError("query and target windows differ in rows")
    for name, v in (("rows", rows), ("qlen", qlen), ("tlen", tlen),
                    ("w", w)):
        if v.shape != (M,) or v.device != dev:
            raise ValueError(f"{name}: expected shape ({M},) on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
    m = torch.as_tensor(mat, device=dev).reshape(-1).to(I32).contiguous()
    if m.numel() != 25:
        raise ValueError(f"mat: expected a 5x5 matrix, got {m.numel()} "
                         "values")
    if want_steps:
        score = torch.empty(M, dtype=I32, device=dev)
        steps = torch.full((M, T + Q), 3, dtype=torch.uint8, device=dev)
        pack = None
    else:
        pack = torch.empty((M, 2 + ga_k), dtype=torch.int16, device=dev)
        score = steps = None
    if M == 0:
        return (score, steps) if want_steps else pack
    build()
    blocks = min(M, BLOCKS_PER_SM
                 * torch.cuda.get_device_properties(dev).multi_processor_count)
    zbuf = torch.empty((blocks, T, Q), dtype=torch.uint8, device=dev)
    ins = [rows.to(torch.int64).contiguous()] + [
        a.to(I32).contiguous() for a in (qlen, tlen, w)]

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = _fn(qD.data_ptr(), tD.data_ptr(), *(a.data_ptr() for a in ins),
                 m.data_ptr(), zbuf.data_ptr(), ptr(pack), ptr(steps),
                 ptr(score), M, Q, T, qD.stride(0), tD.stride(0),
                 gaps["o_del"], gaps["e_del"], gaps["o_ins"], gaps["e_ins"],
                 ga_k, int(want_steps), blocks,
                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"global-alignment kernel launch failed: CUDA "
                           f"error {rc}")
    return (score, steps) if want_steps else pack


def ga_pack(qD: torch.Tensor, tD: torch.Tensor, rows: torch.Tensor,
            qlen: torch.Tensor, tlen: torch.Tensor, w: torch.Tensor, mat, *,
            o_del: int, e_del: int, o_ins: int, e_ins: int,
            ga_k: int) -> torch.Tensor:
    """``align.flatsam._ga_rows``'s pack for CUDA tensors: lanes ``rows``
    of the int8 window buffers qD [N, Q] / tD [N, T], read in place ->
    int16 [M, 2 + ga_k] (score, nseg, segments in CIGAR order)."""
    res = _launch(qD, tD, rows, qlen, tlen, w, mat, qD.shape[1], tD.shape[1],
                  dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins),
                  ga_k, want_steps=False)
    if rows.shape[0]:
        cuda_build.count_launch(ga_pack)
    return res


def global_align_cigar_core(query, qlen, target, tlen, mat, w, *, o_del: int,
                            e_del: int, o_ins: int,
                            e_ins: int) -> GlobalCigarResult:
    """Batched global alignment with traceback
    (``global_align_cigar_batch``'s contract): the plain version for CPU
    tensors, K3 for CUDA tensors."""
    gaps = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins)
    if query.device.type == "cpu":
        return global_align_cigar_batch(query, qlen, target, tlen, mat, w,
                                        **gaps)
    B, Q = query.shape
    rows = torch.arange(B, dtype=torch.int64, device=query.device)
    score, steps = _launch(query.to(torch.int8), target.to(torch.int8), rows,
                           qlen, tlen, w, mat, Q, target.shape[1], gaps, 0,
                           want_steps=True)
    if B:
        cuda_build.count_launch(global_align_cigar_core)
    return GlobalCigarResult(score=score, steps=steps)


ga_pack.launches = 0
global_align_cigar_core.launches = 0
