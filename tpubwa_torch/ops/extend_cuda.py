"""The seed-extension DP as a hand-written CUDA kernel (``csrc/extend.cu``).

Port of the Pallas kernel ``tpubwa.ops.extend_pallas._kernel_t``.  The
source is compiled with nvcc for sm_90a into ``build/tpubwa_torch/`` at
first use, keyed by a hash of the source, and loaded with ctypes.

``extend_core`` has ``ops.extend._extend_core``'s contract.  For tensors
on the CPU it runs that plain version; for CUDA tensors it launches the
kernel or raises.  ``extend_core.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from tpubwa_torch.ops.extend import (ExtendBatchResult, _extend_core,
                                     clamp_band_batch, score_values)

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "extend.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpubwa_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the extension kernel must be built from "
                       f"{_SRC}")


def build() -> str:
    """Compile (unless a build of this exact source exists) and load the
    kernel library.  Returns nvcc's register/shared-memory report for a
    fresh build, "" when the build already existed."""
    global _lib
    if _lib is not None:
        return ""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libtpubwa_extend_{tag}.so"
    report = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
        os.replace(tmp, so)
        report = proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.tpubwa_extend_launch.restype = ctypes.c_int
    lib.tpubwa_extend_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    _lib = lib
    return report


def _launch(query, qlen, target, tlen, mat, w, h0, end_bonus, *, o_del,
            e_del, o_ins, e_ins, zdrop, mat_max) -> ExtendBatchResult:
    dev = query.device
    J, Q = query.shape
    T = target.shape[1]
    if target.shape[0] != J:
        raise ValueError(f"target rows {target.shape[0]} != jobs {J}")
    for name, v in (("qlen", qlen), ("tlen", tlen), ("w", w), ("h0", h0),
                    ("end_bonus", end_bonus)):
        if v.shape != (J,) or v.device != dev:
            raise ValueError(f"{name}: expected shape ({J},) on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
    if target.device != dev:
        raise ValueError(f"target on {target.device}, query on {dev}")
    build()
    I32 = torch.int32
    wc = clamp_band_batch(w.to(I32), qlen.to(I32), mat_max, o_del, e_del,
                          o_ins, e_ins, end_bonus.to(I32))
    ins = [a.to(I32).contiguous() for a in (query, target, qlen, tlen, wc,
                                            h0)]
    out = torch.empty((6, J), dtype=I32, device=dev)
    s_match, s_mis, s_n = score_values(mat)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib.tpubwa_extend_launch(
            *(a.data_ptr() for a in ins), out.data_ptr(), J, Q, T, s_match,
            s_mis, s_n, o_del, e_del, o_ins, e_ins, zdrop, stream)
    if rc != 0:
        raise RuntimeError(f"extension kernel launch failed: CUDA error {rc}")
    extend_core.launches += 1
    return ExtendBatchResult(*out.unbind(0))


def extend_core(query: torch.Tensor, qlen: torch.Tensor,
                target: torch.Tensor, tlen: torch.Tensor, mat,
                w: torch.Tensor, h0: torch.Tensor, end_bonus: torch.Tensor,
                *, o_del: int, e_del: int, o_ins: int, e_ins: int,
                zdrop: int, mat_max: int) -> ExtendBatchResult:
    """Batched ksw_extend2 (``ops.extend._extend_core``'s contract): the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, mat_max=mat_max)
    if query.device.type == "cpu":
        return _extend_core(query, qlen, target, tlen, mat, w, h0,
                            end_bonus, **kw)
    if query.device.type != "cuda":
        raise ValueError(f"no extension kernel for device {query.device}")
    return _launch(query, qlen, target, tlen, mat, w, h0, end_bonus, **kw)


extend_core.launches = 0
