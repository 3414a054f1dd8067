"""The seed-extension DP as hand-written CUDA kernels.

Two kernels compute ``ops.extend._extend_core``'s function bit for bit:

* K1, ``csrc/extend.cu``: a group of 8, 16 or 32 lanes per job, sized by
  the job's qlen, on jobs ordered longest first (port of the Pallas
  kernel ``tpubwa.ops.extend_pallas._kernel_t``, the transposed layout).
  What surrounds the kernel has plain versions that the CPU tests reach:
  ``job_keys_core`` (the band clamp and the sort keys: ``clamp_band_batch``
  and ``job_keys`` on the CPU, one small kernel of the same source on the
  card), ``job_order`` (the ordering; the kernel reads it and writes each
  result to its job's own slot, so nothing is permuted in memory),
  ``size_class`` (the classes the kernel derives from the sorted keys)
  and ``as_codes`` (which code tensors are read as they are);
* K1b, ``csrc/extend_b.cu``: the same jobs, keys, order and size classes
  (``kernel_args`` gives both kernels the same arguments), but a job's
  whole row at a time, spread across its group of lanes, with F from a
  max-scan across them (port of ``_kernel``, the round-4 [B, Q] layout).
  Its ablation variants (``VARIANTS``, the port of
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
                                     clamp_band_batch)

I32 = torch.int32

# source -> ((name in _fns, C entry point, pointer arguments, int
# arguments), ...)
_ENTRY = {"extend": (("extend", "tpubwa_extend_launch", 11, 11),
                     ("extend_prep", "tpubwa_extend_prep", 6, 8)),
          "extend_b": (("extend_b", "tpubwa_extend_b_launch", 11, 12),)}
# K1b's ablation variants (scripts/ablate_kernel_r5.py), as OR-ed flags:
# no_cummax 1, no_mj 2, no_m 4, no_hlast 8, no_zdrop 16; for the widths
# ABLATE_Q only (the script's Q = 192: six columns a lane)
VARIANTS = {"full": 0, "no_cummax": 1, "no_mj": 2, "no_m+mj": 6,
            "no_hlast": 8, "no_zdrop": 16, "no_all_red": 31}
ABLATE_Q = (161, 192)
MAX_Q = 256     # K1's and K1b's largest group holds 32 x 8 columns
# K1's size classes, longest first: (qlen above, lanes a job, columns a lane)
SIZE_CLASSES = ((128, 32, 8), (64, 32, 4), (32, 16, 4), (0, 8, 4))
KEY_SHIFT = 16  # key = qlen << 16 | rows; 0 for a job with nothing to do

_fns: dict = {}


def build(name: str = "extend") -> str:
    """Build (unless built) and load kernel `name` ("extend" or
    "extend_b").  Returns nvcc's register/shared-memory report for a
    fresh build, "" otherwise."""
    with cuda_build.lock(name):
        if name in _fns:
            return ""
        lib, report = cuda_build.build(name)
        for key, entry, n_ptr, n_int in _ENTRY[name]:
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
            _fns[key] = fn
        return report


def job_keys(qlen: torch.Tensor, tlen: torch.Tensor, w: torch.Tensor,
             Q: int, T: int) -> torch.Tensor:
    """int32 [J] sort keys of extension jobs (w already band-clamped):
    ``qlen << 16 | rows`` with rows = min(tlen, qlen + w), the rows the
    job can visit before its band leaves the query, for a job with qlen
    and tlen > 0 (lengths cut to Q and T as the kernel cuts them); 0 for a
    dead job.  A larger key is a longer job."""
    ql = qlen.to(I32).clamp(max=Q)
    tl = tlen.to(I32).clamp(max=T)
    rows = torch.minimum(tl, ql + w.to(I32)).clamp(0, (1 << KEY_SHIFT) - 1)
    return torch.where((ql > 0) & (tl > 0), (ql << KEY_SHIFT) | rows, 0)


def job_order(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the keys in descending order, int64 [J] the job at each sorted
    position): longest jobs first, dead jobs last.  Device ops only."""
    return torch.sort(keys, descending=True)


def size_class(keys: torch.Tensor) -> torch.Tensor:
    """The class (row of ``SIZE_CLASSES``, or ``len(SIZE_CLASSES)`` for a
    dead job) that K1 gives each key."""
    ql = keys >> KEY_SHIFT
    cls = torch.full_like(keys, len(SIZE_CLASSES))
    for c in reversed(range(len(SIZE_CLASSES))):
        above = SIZE_CLASSES[c][0]
        cls = torch.where(ql > above if above else ql >= 1, c, cls)
    return cls


def as_codes(codes: torch.Tensor) -> torch.Tensor:
    """[J, n] base codes as K1 and K4 read them: uint8 or int32 with unit
    stride along a row are taken as given, rows any distance apart (a
    column slice of a wider buffer is not copied); anything else is
    copied to contiguous int32."""
    if (codes.dtype in (torch.uint8, I32)
            and (codes.shape[1] == 1 or codes.stride(1) == 1)):
        return codes
    return codes.to(I32).contiguous()


def as_code_pair(query: torch.Tensor,
                 target: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``as_codes`` of both, in one dtype (a kernel instance reads one)."""
    qc, tc = as_codes(query), as_codes(target)
    if qc.dtype != tc.dtype:     # one is uint8: widen that one
        qc, tc = (a if a.dtype == I32 else a.to(I32).contiguous()
                  for a in (qc, tc))
    return qc, tc


def job_keys_core(qlen: torch.Tensor, tlen: torch.Tensor, w: torch.Tensor,
                  end_bonus: torch.Tensor, Q: int, T: int, *, mat_max: int,
                  o_del: int, e_del: int, o_ins: int,
                  e_ins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(the clamped band, the sort key) of each job, int32 [J]:
    ``clamp_band_batch`` and ``job_keys`` for CPU tensors, one launch of
    ``csrc/extend.cu``'s prep kernel for CUDA tensors."""
    ins = [a.to(I32).contiguous() for a in (qlen, tlen, w, end_bonus)]
    if qlen.device.type == "cpu":
        wc = clamp_band_batch(ins[2], ins[0], mat_max, o_del, e_del, o_ins,
                              e_ins, ins[3])
        return wc, job_keys(ins[0], ins[1], wc, Q, T)
    build("extend")
    dev = qlen.device
    J = qlen.shape[0]
    wc = torch.empty(J, dtype=I32, device=dev)
    keys = torch.empty(J, dtype=I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fns["extend_prep"](
            *(a.data_ptr() for a in (*ins, wc, keys)), J, Q, T, mat_max,
            o_del, e_del, o_ins, e_ins, stream)
    if rc != 0:
        raise RuntimeError(f"extend prep launch failed: CUDA error {rc}")
    return wc, keys


def _check_jobs(query, target, **vectors) -> None:
    dev = query.device
    J = query.shape[0]
    if target.shape[0] != J:
        raise ValueError(f"target rows {target.shape[0]} != jobs {J}")
    for vname, v in vectors.items():
        if v.shape != (J,) or v.device != dev:
            raise ValueError(f"{vname}: expected shape ({J},) on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
    if target.device != dev:
        raise ValueError(f"target on {target.device}, query on {dev}")


def kernel_args(query, qlen, target, tlen, mat, w, h0, end_bonus, *,
                o_del, e_del, o_ins, e_ins, mat_max) -> tuple[tuple, tuple]:
    """What K1 and K1b are launched with, after the input checks: (the
    tensors, in the C entry points' order: query and target codes as
    ``as_code_pair`` reads them, qlen, tlen, the clamped bands, h0, the
    sorted keys, the order, the class-bounds scratch, the scores, the
    output [6, J]; the ints: J, Q, T, the rows' strides, the code width).
    Both kernels take the same: the band clamp and keys of
    ``job_keys_core``, ``job_order``'s order, the classes of the sorted
    keys, the matrix read on the device.  Device ops only, no host
    synchronisation."""
    dev = query.device
    J, Q = query.shape
    T = target.shape[1]
    _check_jobs(query, target, qlen=qlen, tlen=tlen, w=w, h0=h0,
                end_bonus=end_bonus)
    if not 1 <= Q <= MAX_Q or T < 1:
        raise ValueError(f"extend: Q={Q}, T={T}: needs 1 <= Q <= {MAX_Q} "
                         "(a group holds at most 32 x 8 columns) and T >= 1")
    m = torch.as_tensor(mat, device=dev).reshape(-1).to(I32).contiguous()
    if m.numel() != 25:
        raise ValueError(f"mat: expected a 5x5 matrix, got {m.numel()} "
                         "values")
    ql, tl, h = (a.to(I32).contiguous() for a in (qlen, tlen, h0))
    wc, keys = job_keys_core(ql, tl, w, end_bonus, Q, T, mat_max=mat_max,
                             o_del=o_del, e_del=e_del, o_ins=o_ins,
                             e_ins=e_ins)
    skeys, order = job_order(keys)
    start = torch.empty(len(SIZE_CLASSES) + 2, dtype=I32, device=dev)
    out = torch.empty((6, J), dtype=I32, device=dev)
    qc, tc = as_code_pair(query, target)
    return ((qc, tc, ql, tl, wc, h, skeys, order, start, m, out),
            (J, Q, T, qc.stride(0), tc.stride(0), qc.element_size()))


def _launch(name, query, qlen, target, tlen, mat, w, h0, end_bonus, *,
            o_del, e_del, o_ins, e_ins, zdrop, mat_max,
            variant: int | None = None) -> ExtendBatchResult:
    """One launch of K1 ("extend") or K1b ("extend_b"; `variant` 0, or an
    ablation set of ``VARIANTS``)."""
    Q = query.shape[1]
    if variant and not ABLATE_Q[0] <= Q <= ABLATE_Q[1]:
        raise ValueError(f"extend_b variant {variant}: Q={Q}, the ablation "
                         f"sets are built for {ABLATE_Q[0]} <= Q <= "
                         f"{ABLATE_Q[1]} only")
    tensors, ints = kernel_args(query, qlen, target, tlen, mat, w, h0,
                                end_bonus, o_del=o_del, e_del=e_del,
                                o_ins=o_ins, e_ins=e_ins, mat_max=mat_max)
    if variant:                  # the ablation sets read int32 codes
        tensors = (*(a.to(I32).contiguous() for a in tensors[:2]),
                   *tensors[2:])
        ints = (*ints[:3], tensors[0].stride(0), tensors[1].stride(0), 4)
    build(name)
    dev = query.device
    extra = () if variant is None else (variant,)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _fns[name](*(a.data_ptr() for a in tensors), *ints, o_del,
                        e_del, o_ins, e_ins, zdrop, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return ExtendBatchResult(*tensors[-1].unbind(0))


def _core(name: str, wrapper, query, qlen, target, tlen, mat, w, h0,
          end_bonus, kw: dict) -> ExtendBatchResult:
    if query.device.type == "cpu":
        return _extend_core(query, qlen, target, tlen, mat, w, h0,
                            end_bonus, **kw)
    if query.device.type != "cuda":
        raise ValueError(f"no extension kernel for device {query.device}")
    res = _launch(name, query, qlen, target, tlen, mat, w, h0, end_bonus,
                  variant=0 if name == "extend_b" else None, **kw)
    cuda_build.count_launch(wrapper)
    return res


def extend_core(query: torch.Tensor, qlen: torch.Tensor,
                target: torch.Tensor, tlen: torch.Tensor, mat,
                w: torch.Tensor, h0: torch.Tensor, end_bonus: torch.Tensor,
                *, o_del: int, e_del: int, o_ins: int, e_ins: int,
                zdrop: int, mat_max: int) -> ExtendBatchResult:
    """Batched ksw_extend2 (``ops.extend._extend_core``'s contract): the
    plain version for CPU tensors, K1 for CUDA tensors."""
    return _core("extend", extend_core, query, qlen, target, tlen, mat, w,
                 h0, end_bonus, dict(o_del=o_del, e_del=e_del, o_ins=o_ins,
                                     e_ins=e_ins, zdrop=zdrop,
                                     mat_max=mat_max))


def extend_core_b(query: torch.Tensor, qlen: torch.Tensor,
                  target: torch.Tensor, tlen: torch.Tensor, mat,
                  w: torch.Tensor, h0: torch.Tensor, end_bonus: torch.Tensor,
                  *, o_del: int, e_del: int, o_ins: int, e_ins: int,
                  zdrop: int, mat_max: int) -> ExtendBatchResult:
    """Batched ksw_extend2 (``ops.extend._extend_core``'s contract): the
    plain version for CPU tensors, K1b (a job's row across a group of
    lanes) for CUDA tensors."""
    return _core("extend_b", extend_core_b, query, qlen, target, tlen, mat,
                 w, h0, end_bonus, dict(o_del=o_del, e_del=e_del,
                                        o_ins=o_ins, e_ins=e_ins,
                                        zdrop=zdrop, mat_max=mat_max))


def extend_b_variant(variant: str, query, qlen, target, tlen, mat, w, h0,
                     end_bonus, **kw) -> ExtendBatchResult:
    """K1b with blocks cut out (``VARIANTS``; CUDA tensors, Q = 192):
    timing only — every variant but "full" gives wrong results by
    design.  Counted in its own ``launches``, not in
    ``extend_core_b.launches``."""
    if query.device.type != "cuda":
        raise ValueError("extend_b_variant runs on CUDA tensors only")
    res = _launch("extend_b", query, qlen, target, tlen, mat, w, h0,
                  end_bonus, variant=VARIANTS[variant], **kw)
    cuda_build.count_launch(extend_b_variant)
    return res


extend_core.launches = 0
extend_core_b.launches = 0
extend_b_variant.launches = 0
