"""The SMEM chain walks as a hand-written CUDA kernel
(``csrc/smem_chain.cu``, K2).

Replaces the three XLA while_loops of ``tpubwa.ops.smem_chain``.  The
source is built by ``ops.cuda_build`` at first use and loaded with ctypes;
one library holds the int32 (narrow) and int64 (wide) instantiations of
the three rounds.

``smem_round1_core``, ``smem_through_core`` and ``smem_round3_core`` have
the contracts of ``ops.smem_chain.smem_round1_chain``,
``smem_through_chain`` and ``smem_round3_chain``.  For tensors on the CPU
they run those plain versions; for CUDA tensors they launch the kernel or
raise.  Each counts its kernel launches in its ``launches`` attribute.
``steps_out`` (CUDA only) receives the number of extension steps each
lane took.
"""
from __future__ import annotations

import ctypes

import torch

from tpubwa_torch.ops import cuda_build
from tpubwa_torch.ops.fm import DeviceIndex
from tpubwa_torch.ops.smem import Smems
from tpubwa_torch.ops.smem_chain import (smem_round1_chain,
                                         smem_round3_chain,
                                         smem_through_chain)

I32 = torch.int32
_fns = None


def build() -> str:
    """Build (unless built) and load the kernel; returns nvcc's report
    for a fresh build, "" otherwise."""
    global _fns
    with cuda_build.lock("smem_chain"):
        if _fns is not None:
            return ""
        lib, report = cuda_build.build("smem_chain")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        head = [p, p, i64, p, p]       # cp, L2, primary, q, lens
        tail = [p, p, p, p, i, p]      # m5, mn, ovf, steps, wide, stream
        sigs = {
            "tpubwa_smem_round1_launch": head + [i] * 4 + tail,
            "tpubwa_smem_round2_launch": head + [p] * 4 + [i] * 4 + tail,
            "tpubwa_smem_round3_launch": head + [i] * 5 + tail,
        }
        fns = {}
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            fns[name] = fn
        _fns = fns
        return report


def _check(di: DeviceIndex, q: torch.Tensor, lens: torch.Tensor, cap: int):
    """Validate what every round takes; returns (index dtype, contiguous
    cp, L2, q, lens)."""
    dev = q.device
    idt = di.L2.dtype
    if idt not in (torch.int32, torch.int64):
        raise ValueError(f"index dtype {idt}: expected int32 or int64")
    if di.cp.dtype != idt or di.cp.dim() != 2 or di.cp.shape[1] != 8:
        raise ValueError(f"cp: expected {idt} [nblocks, 8], got "
                         f"{di.cp.dtype} {tuple(di.cp.shape)}")
    if di.L2.shape != (5,):
        raise ValueError(f"L2: expected shape (5,), got {tuple(di.L2.shape)}")
    for name, v in (("cp", di.cp), ("L2", di.L2), ("lens", lens)):
        if v.device != dev:
            raise ValueError(f"{name} on {v.device}, reads on {dev}")
    if q.dim() != 2 or lens.shape != (q.shape[0],):
        raise ValueError(f"reads {tuple(q.shape)} / lens {tuple(lens.shape)}"
                         ": expected [B, L] and [B]")
    if cap < 1:
        raise ValueError(f"cap {cap}: expected >= 1")
    return (idt, di.cp.contiguous(), di.L2.contiguous(),
            q.to(I32).contiguous(), lens.to(I32).contiguous())


def _outputs(n: int, cap: int, idt, dev, steps_out):
    m5 = torch.zeros((n, cap, 5), dtype=idt, device=dev)
    mn = torch.zeros(n, dtype=I32, device=dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    if steps_out is not None and (
            steps_out.shape != (n,) or steps_out.dtype != I32
            or steps_out.device != dev or not steps_out.is_contiguous()):
        raise ValueError(f"steps_out: expected contiguous int32 [{n}] on "
                         f"{dev}")
    return m5, mn, ovf, (0 if steps_out is None else steps_out.data_ptr())


def _result(rc: int, m5, mn, ovf) -> Smems:
    if rc != 0:
        raise RuntimeError(f"SMEM chain kernel launch failed: CUDA error "
                           f"{rc}")
    return Smems(k=m5[..., 0], l=m5[..., 1], s=m5[..., 2], start=m5[..., 3],
                 end=m5[..., 4], n=mn, overflow=ovf)


def _need_cuda(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no SMEM chain kernel for device {q.device}")


def smem_round1_core(di: DeviceIndex, q: torch.Tensor, lens: torch.Tensor,
                     min_seed_len: int = 19, cap: int = 64,
                     steps_out: torch.Tensor | None = None) -> Smems:
    """Round-1 chains (``smem_round1_chain``'s contract): the plain
    version for CPU tensors, K2 for CUDA tensors."""
    if q.device.type == "cpu":
        return smem_round1_chain(di, q, lens, min_seed_len=min_seed_len,
                                 cap=cap)
    _need_cuda(q)
    idt, cp, L2, qc, lc = _check(di, q, lens, cap)
    B, L = qc.shape
    m5, mn, ovf, steps = _outputs(B, cap, idt, q.device, steps_out)
    if B == 0:                       # no lanes: no build, no launch
        return _result(0, m5, mn, ovf)
    build()
    with torch.cuda.device(q.device):
        rc = _fns["tpubwa_smem_round1_launch"](
            cp.data_ptr(), L2.data_ptr(), di.primary, qc.data_ptr(),
            lc.data_ptr(), B, L, min_seed_len, cap, m5.data_ptr(),
            mn.data_ptr(), ovf.data_ptr(), steps,
            int(idt == torch.int64),
            torch.cuda.current_stream(q.device).cuda_stream)
    res = _result(rc, m5, mn, ovf)
    cuda_build.count_launch(smem_round1_core)
    return res


def smem_through_core(di: DeviceIndex, q: torch.Tensor, lens: torch.Tensor,
                      rd: torch.Tensor, mid: torch.Tensor, thr: torch.Tensor,
                      act: torch.Tensor, min_seed_len: int = 19,
                      cap: int = 32,
                      steps_out: torch.Tensor | None = None) -> Smems:
    """Round-2 chains (``smem_through_chain``'s contract): the plain
    version for CPU tensors, K2 for CUDA tensors.  The kernel reads the
    read row ``q[rd]`` in place."""
    if q.device.type == "cpu":
        return smem_through_chain(di, q, lens, rd, mid, thr, act,
                                  min_seed_len=min_seed_len, cap=cap)
    _need_cuda(q)
    idt, cp, L2, qc, lc = _check(di, q, lens, cap)
    G = rd.shape[0]
    for name, v in (("rd", rd), ("mid", mid), ("thr", thr), ("act", act)):
        if v.shape != (G,) or v.device != q.device:
            raise ValueError(f"{name}: expected shape ({G},) on {q.device}, "
                             f"got {tuple(v.shape)} on {v.device}")
    if act.dtype != torch.bool:
        raise ValueError(f"act: expected bool, got {act.dtype}")
    B, L = qc.shape
    m5, mn, ovf, steps = _outputs(G, cap, idt, q.device, steps_out)
    if G == 0:                       # no lanes: no build, no launch
        return _result(0, m5, mn, ovf)
    build()
    rd_c = rd.to(I32).contiguous()
    mid_c = mid.to(I32).contiguous()
    thr_c = thr.to(idt).contiguous()
    act_c = act.contiguous()
    with torch.cuda.device(q.device):
        rc = _fns["tpubwa_smem_round2_launch"](
            cp.data_ptr(), L2.data_ptr(), di.primary, qc.data_ptr(),
            lc.data_ptr(), rd_c.data_ptr(), mid_c.data_ptr(),
            thr_c.data_ptr(), act_c.data_ptr(), G, L, min_seed_len, cap,
            m5.data_ptr(), mn.data_ptr(), ovf.data_ptr(), steps,
            int(idt == torch.int64),
            torch.cuda.current_stream(q.device).cuda_stream)
    res = _result(rc, m5, mn, ovf)
    cuda_build.count_launch(smem_through_core)
    return res


def smem_round3_core(di: DeviceIndex, q: torch.Tensor, lens: torch.Tensor,
                     min_seed_len: int = 19, max_mem_intv: int = 20,
                     cap: int = 64,
                     steps_out: torch.Tensor | None = None) -> Smems:
    """Round-3 chains (``smem_round3_chain``'s contract): the plain
    version for CPU tensors, K2 for CUDA tensors."""
    if q.device.type == "cpu":
        return smem_round3_chain(di, q, lens, min_seed_len=min_seed_len,
                                 max_mem_intv=max_mem_intv, cap=cap)
    _need_cuda(q)
    idt, cp, L2, qc, lc = _check(di, q, lens, cap)
    B, L = qc.shape
    m5, mn, ovf, steps = _outputs(B, cap, idt, q.device, steps_out)
    if B == 0:                       # no lanes: no build, no launch
        return _result(0, m5, mn, ovf)
    build()
    with torch.cuda.device(q.device):
        rc = _fns["tpubwa_smem_round3_launch"](
            cp.data_ptr(), L2.data_ptr(), di.primary, qc.data_ptr(),
            lc.data_ptr(), B, L, min_seed_len, max_mem_intv, cap,
            m5.data_ptr(), mn.data_ptr(), ovf.data_ptr(), steps,
            int(idt == torch.int64),
            torch.cuda.current_stream(q.device).cuda_stream)
    res = _result(rc, m5, mn, ovf)
    cuda_build.count_launch(smem_round3_core)
    return res


smem_round1_core.launches = 0
smem_through_core.launches = 0
smem_round3_core.launches = 0
