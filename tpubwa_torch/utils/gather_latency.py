"""How long one dependent gather from the checkpoint table takes on the
card: the floor under a step of an SMEM chain (K2) or an LF walk (K5).

``measure(cp)`` builds a small probe kernel with nvcc (it is no part of
the aligner) in which every thread follows its own chain of loads, each
address computed from the value loaded before, over rows of the table
`cp` [nblocks, 8]; it returns, per configuration, the microseconds and the
SM cycles one step takes.  One warp alone gives the latency of a load that
hits the L2 cache; as many warps as a batch of K2 puts on the card give the
time of a step when all of them gather at once; added shuffles give the
cost of one ``__shfl_xor_sync`` on the chain.

    python -m tpubwa_torch.utils.gather_latency      # a random 4 MB table
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

from tpubwa_torch.ops import cuda_build

SOURCE = r"""
#include <cuda_runtime.h>
// Every thread: `steps` dependent loads of one int from rows of 8 ints,
// the row picked by a hash of what was loaded; `shuffles` dependent
// warp shuffles after each load.  out[block] = cycles thread 0 took.
__global__ void chase(const int* cp, unsigned mask, int steps, int shuffles,
                      long long* out, int* sink) {
  unsigned idx = threadIdx.x * 977u + blockIdx.x * 7919u;
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {
    int v = __ldg(cp + static_cast<size_t>(idx & mask) * 8 + (threadIdx.x & 7));
    for (int k = 0; k < shuffles; ++k)
      v += __shfl_xor_sync(0xffffffffu, v, 1 << (k & 3));
    idx = idx * 2654435761u + static_cast<unsigned>(v) + 12345u;
    idx ^= idx >> 15;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
  if (idx == 0xdeadbeefu) *sink = 1;
}
extern "C" int tpubwa_chase_launch(const int* cp, unsigned mask, int steps,
                                   int shuffles, int blocks, int threads,
                                   long long* out, int* sink, void* stream) {
  chase<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      cp, mask, steps, shuffles, out, sink);
  return static_cast<int>(cudaGetLastError());
}
"""

# (blocks, threads a block, shuffles a step, what it shows)
CONFIGS = (
    (1, 32, 0, "one warp: the latency of a load"),
    (1, 32, 4, "one warp, 4 shuffles a step"),
    (512, 128, 0, "2,048 warps (a K2 batch of 8192 lanes): all gather at "
                  "once"),
)


def _build() -> ctypes.CDLL:
    tag = hashlib.sha256(SOURCE.encode()).hexdigest()[:16]
    so = cuda_build.BUILD_DIR / f"libtpubwa_chase_{tag}.so"
    if not so.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = so.with_suffix(".cu")
        src.write_text(SOURCE)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas",
                                                               "-v")]
        proc = subprocess.run([cuda_build._nvcc(src), *flags, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the probe:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.tpubwa_chase_launch.restype = ctypes.c_int
    lib.tpubwa_chase_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_uint] + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 3)
    return lib


def measure(cp: torch.Tensor, steps: int = 2000) -> list[dict]:
    """One dict per entry of CONFIGS: what, rows and bytes gathered over,
    us_per_step, cycles_per_step."""
    if cp.device.type != "cuda" or cp.dtype != torch.int32 or cp.dim() != 2 \
            or cp.shape[1] != 8 or not cp.is_contiguous():
        raise ValueError("cp: expected a contiguous int32 [nblocks, 8] "
                         "tensor on a CUDA device")
    lib = _build()
    rows = 1 << (cp.shape[0].bit_length() - 1)     # a power of two of rows
    out = torch.zeros(4096, dtype=torch.int64, device=cp.device)
    sink = torch.zeros(1, dtype=torch.int32, device=cp.device)
    res = []
    with torch.cuda.device(cp.device):
        stream = torch.cuda.current_stream(cp.device).cuda_stream
        for blocks, threads, shuffles, what in CONFIGS:
            for _ in range(2):                     # the first run warms up
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                rc = lib.tpubwa_chase_launch(
                    cp.data_ptr(), rows - 1, steps, shuffles, blocks, threads,
                    out.data_ptr(), sink.data_ptr(), stream)
                b.record()
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"probe launch failed: CUDA error "
                                       f"{rc}")
            res.append(dict(
                what=what, rows=rows, table_bytes=rows * 32,
                us_per_step=1e3 * a.elapsed_time(b) / steps,
                cycles_per_step=float(out[:blocks].double().mean()) / steps))
    return res


def main() -> None:
    cp = torch.randint(0, 1 << 30, (1 << 17, 8), dtype=torch.int32,
                       device="cuda")
    for r in measure(cp):
        print(f"{r['what']}: {r['us_per_step']:.3f} us, "
              f"{r['cycles_per_step']:.0f} cycles a step ({r['rows']} rows, "
              f"{r['table_bytes']} bytes)")


if __name__ == "__main__":
    main()
