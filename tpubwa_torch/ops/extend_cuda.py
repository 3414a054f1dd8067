"""The seed-extension DP as hand-written CUDA kernels.

Two kernels compute ``ops.extend._extend_core``'s function bit for bit:

* K1, ``csrc/extend.cu``: one thread per job (port of the Pallas kernel
  ``tpubwa.ops.extend_pallas._kernel_t``, the transposed layout);
* K1b, ``csrc/extend_b.cu``: one warp per job, a job's row spread across
  the lanes (port of ``_kernel``, the round-4 [B, Q] layout).  Its
  ablation variants (``VARIANTS``, the port of
  ``scripts/ablate_kernel_r5.py``) are for timing only.

Each source is built by ``ops.cuda_build`` at first use and loaded with
ctypes.  ``extend_core`` and ``extend_core_b`` have ``_extend_core``'s
contract: for tensors on the CPU they run that plain version; for CUDA
tensors they launch their kernel or raise.  Each counts its launches in
its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from tpubwa_torch.ops import cuda_build
from tpubwa_torch.ops.extend import (ExtendBatchResult, _extend_core,
                                     clamp_band_batch, score_values)

# kernel name -> (C entry point, int arguments after the 7 pointers)
_ENTRY = {"extend": ("tpubwa_extend_launch", 11),
          "extend_b": ("tpubwa_extend_b_launch", 12)}
# K1b's ablation variants (scripts/ablate_kernel_r5.py), as OR-ed flags:
# no_cummax 1, no_mj 2, no_m 4, no_hlast 8, no_zdrop 16.  Q = 192 only.
VARIANTS = {"full": 0, "no_cummax": 1, "no_mj": 2, "no_m+mj": 6,
            "no_hlast": 8, "no_zdrop": 16, "no_all_red": 31}
MAX_Q_B = 256   # K1b holds ceil(Q/32) <= 8 columns per lane

_fns: dict = {}


def build(name: str = "extend") -> str:
    """Build (unless built) and load kernel `name` ("extend" or
    "extend_b").  Returns nvcc's register/shared-memory report for a
    fresh build, "" otherwise."""
    with cuda_build.lock(name):
        if name in _fns:
            return ""
        lib, report = cuda_build.build(name)
        entry, n_int = _ENTRY[name]
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        _fns[name] = fn
        return report


def _launch(name, query, qlen, target, tlen, mat, w, h0, end_bonus, *,
            o_del, e_del, o_ins, e_ins, zdrop, mat_max,
            variant: int | None = None) -> ExtendBatchResult:
    dev = query.device
    J, Q = query.shape
    T = target.shape[1]
    if target.shape[0] != J:
        raise ValueError(f"target rows {target.shape[0]} != jobs {J}")
    for vname, v in (("qlen", qlen), ("tlen", tlen), ("w", w), ("h0", h0),
                     ("end_bonus", end_bonus)):
        if v.shape != (J,) or v.device != dev:
            raise ValueError(f"{vname}: expected shape ({J},) on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
    if target.device != dev:
        raise ValueError(f"target on {target.device}, query on {dev}")
    build(name)
    I32 = torch.int32
    wc = clamp_band_batch(w.to(I32), qlen.to(I32), mat_max, o_del, e_del,
                          o_ins, e_ins, end_bonus.to(I32))
    ins = [a.to(I32).contiguous() for a in (query, target, qlen, tlen, wc,
                                            h0)]
    out = torch.empty((6, J), dtype=I32, device=dev)
    s_match, s_mis, s_n = score_values(mat)
    extra = () if variant is None else (variant,)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fns[name](
            *(a.data_ptr() for a in ins), out.data_ptr(), J, Q, T, s_match,
            s_mis, s_n, o_del, e_del, o_ins, e_ins, zdrop, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return ExtendBatchResult(*out.unbind(0))


def extend_core(query: torch.Tensor, qlen: torch.Tensor,
                target: torch.Tensor, tlen: torch.Tensor, mat,
                w: torch.Tensor, h0: torch.Tensor, end_bonus: torch.Tensor,
                *, o_del: int, e_del: int, o_ins: int, e_ins: int,
                zdrop: int, mat_max: int) -> ExtendBatchResult:
    """Batched ksw_extend2 (``ops.extend._extend_core``'s contract): the
    plain version for CPU tensors, K1 for CUDA tensors."""
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, mat_max=mat_max)
    if query.device.type == "cpu":
        return _extend_core(query, qlen, target, tlen, mat, w, h0,
                            end_bonus, **kw)
    if query.device.type != "cuda":
        raise ValueError(f"no extension kernel for device {query.device}")
    res = _launch("extend", query, qlen, target, tlen, mat, w, h0,
                  end_bonus, **kw)
    cuda_build.count_launch(extend_core)
    return res


def _check_b(query) -> None:
    if query.shape[1] > MAX_Q_B:
        raise ValueError(f"extend_b: Q={query.shape[1]} > {MAX_Q_B} "
                         "(a lane holds at most 8 columns)")


def extend_core_b(query: torch.Tensor, qlen: torch.Tensor,
                  target: torch.Tensor, tlen: torch.Tensor, mat,
                  w: torch.Tensor, h0: torch.Tensor, end_bonus: torch.Tensor,
                  *, o_del: int, e_del: int, o_ins: int, e_ins: int,
                  zdrop: int, mat_max: int) -> ExtendBatchResult:
    """Batched ksw_extend2 (``ops.extend._extend_core``'s contract): the
    plain version for CPU tensors, K1b (a warp per job) for CUDA
    tensors."""
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, mat_max=mat_max)
    if query.device.type == "cpu":
        return _extend_core(query, qlen, target, tlen, mat, w, h0,
                            end_bonus, **kw)
    if query.device.type != "cuda":
        raise ValueError(f"no extension kernel for device {query.device}")
    _check_b(query)
    res = _launch("extend_b", query, qlen, target, tlen, mat, w, h0,
                  end_bonus, variant=0, **kw)
    cuda_build.count_launch(extend_core_b)
    return res


def extend_b_variant(variant: str, query, qlen, target, tlen, mat, w, h0,
                     end_bonus, **kw) -> ExtendBatchResult:
    """K1b with blocks cut out (``VARIANTS``; CUDA tensors, Q = 192):
    timing only — every variant but "full" gives wrong results by
    design.  Counted in its own ``launches``, not in
    ``extend_core_b.launches``."""
    if query.device.type != "cuda":
        raise ValueError("extend_b_variant runs on CUDA tensors only")
    _check_b(query)
    res = _launch("extend_b", query, qlen, target, tlen, mat, w, h0,
                  end_bonus, variant=VARIANTS[variant], **kw)
    cuda_build.count_launch(extend_b_variant)
    return res


extend_core.launches = 0
extend_core_b.launches = 0
extend_b_variant.launches = 0
