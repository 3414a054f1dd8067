"""Banded global alignment with traceback and CIGAR packing as a
hand-written CUDA kernel (``csrc/global_align.cu``, K3).

Replaces the XLA scans ``tpubwa.ops.global_align.global_align_batch`` /
``global_align_cigar_batch`` and the run-length pack of
``tpubwa.align.flatsam._ga_rows``.  The source is built by
``ops.cuda_build`` at first use and loaded with ctypes.

A call is two kernel launches over one counter of lanes: four-warp blocks
whose warps each hold the direction bits of a narrow band in shared
memory take most lanes, and hand the rest (bands wider than 128 cells, or
more bits than their store) to one-warp blocks with the store of a full
matrix; ``launch_plan`` sizes both from the window widths.  There is no
scratch in device memory beyond the counters and that list of lanes.

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
# What the kernel's source fixes and the wrapper sizes its launches by.
MAX_Q = 320             # 32 threads x 10 cells a row
NARROW_WARPS = 4        # warps a block of the first launch
NARROW_BW = 128         # widest band (stored cells a row) it takes
# direction bytes a warp of the first launch has: with the codes of a
# Q=192, T=256 call a block takes 31.6 KB of shared memory, 7 blocks an SM
NARROW_STORE = 7168
MAX_PACK = 64           # largest ga_k
CODES_EXTRA = MAX_PACK * 4   # a warp's reversed segments
SMEM_PER_SM = 227 * 1024     # shared memory the blocks of an SM share
MAX_WARPS_PER_SM = 64
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
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 14
                       + [ctypes.c_void_p])
        _fn = fn
        return report


def launch_plan(M: int, Q: int, T: int, sms: int) -> dict:
    """How a call of M lanes at padded widths Q, T is laid on a card of
    `sms` SMs: ``store`` direction bytes for each warp of the first
    launch (four warps a block, lanes from a counter), ``blocks_narrow``
    of its blocks, and ``blocks_wide`` one-warp blocks of the second
    launch, each with the store of a full matrix (0: no second launch,
    because a warp of the first holds any lane of this call)."""
    codes = ((Q + T + 3) & ~3) + CODES_EXTRA
    full = (T * ((Q + 1) // 2) + 3) & ~3
    one = full <= NARROW_STORE and Q <= NARROW_BW
    store = full if one else NARROW_STORE
    narrow_bytes = 128 + NARROW_WARPS * (store + codes)
    wide_bytes = 128 + full + codes
    per_sm = max(1, min(SMEM_PER_SM // narrow_bytes,
                        MAX_WARPS_PER_SM // NARROW_WARPS))
    wide_per_sm = max(1, min(SMEM_PER_SM // wide_bytes, 16))
    return dict(
        store=store,
        blocks_narrow=max(1, min(-(-M // NARROW_WARPS), per_sm * sms)),
        blocks_wide=0 if one else max(1, min(M, wide_per_sm * sms)),
        narrow_bytes=narrow_bytes, wide_bytes=wide_bytes)


def _launch(qD, tD, rows, qlen, tlen, w, mat, Q: int, T: int, gaps: dict,
            ga_k: int, want_steps: bool):
    """One call of the kernel over lanes ``rows`` of the int8 window
    buffers; returns the pack, or (score, steps)."""
    dev = qD.device
    if dev.type != "cuda":
        raise ValueError(f"no global-alignment kernel for device {dev}")
    M = rows.shape[0]
    if not 1 <= Q <= MAX_Q or T < 1:
        raise ValueError(f"window widths Q={Q}, T={T}: the kernel takes "
                         f"1 <= Q <= {MAX_Q} and T >= 1")
    if not 0 <= ga_k <= MAX_PACK:
        raise ValueError(f"ga_k {ga_k}: expected 0..{MAX_PACK}")
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
    plan = launch_plan(
        M, Q, T, torch.cuda.get_device_properties(dev).multi_processor_count)
    # the lane counters (zero) and the list of lanes for the second launch
    scratch = torch.zeros(3 + M, dtype=I32, device=dev)
    ins = [rows.to(torch.int64).contiguous()] + [
        a.to(I32).contiguous() for a in (qlen, tlen, w)]

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = _fn(qD.data_ptr(), tD.data_ptr(), *(a.data_ptr() for a in ins),
                 m.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 12,
                 ptr(pack), ptr(steps), ptr(score), M, Q, T, qD.stride(0),
                 tD.stride(0), gaps["o_del"], gaps["e_del"], gaps["o_ins"],
                 gaps["e_ins"], ga_k, int(want_steps), plan["store"],
                 plan["blocks_narrow"], plan["blocks_wide"],
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
