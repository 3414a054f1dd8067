// What K1 (csrc/extend.cu) and K1b (csrc/extend_b.cu) share around their
// DP kernels: the launch parameters, the ksw band clamp and sort key of a
// job (one thread a job), and the size classes of the jobs once the caller
// has sorted the keys in descending order.  K1b's wrapper runs K1's prep
// kernel (tpubwa_extend_prep) and the same torch.sort, so both kernels see
// the same order and the same classes:
//   class 0: qlen > 128   class 1: qlen > 64   class 2: qlen > 32
//   class 3: qlen >= 1    class 4: a dead job (qlen or tlen 0)
// A warp takes 1, 1, 2, 4 or 32 neighbouring jobs of one class
// (jobs_per_warp).  Included by each source (ops/cuda_build.py hashes the
// headers with the source).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kClasses = 5;    // four live size classes and the dead jobs
constexpr int kKeyShift = 16;  // key = qlen << 16 | rows, 0 for a dead job

struct Params {
  int J, Q, T;
  int q_stride, t_stride;  // elements between the rows of query and target
  int o_del, e_del, o_ins, e_ins, zdrop;
};

// max(max(a + b, c), 0)
__device__ __forceinline__ int addmax_relu(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmax_s32_relu(a, b, c);
#else
  return max(max(a + b, c), 0);
#endif
}

// size class of a sorted key: 0 (longest) .. 3, 4 = dead
__device__ __forceinline__ int key_class(int key) {
  const int qlen = key >> kKeyShift;
  return qlen > 128 ? 0 : qlen > 64 ? 1 : qlen > 32 ? 2 : qlen >= 1 ? 3 : 4;
}

// neighbouring jobs of class c that one warp takes
__device__ __forceinline__ int jobs_per_warp(int c) {
  return c < 2 ? 1 : c == 2 ? 2 : c == 3 ? 4 : 32;
}

// floor(x / e), as torch.div(rounding_mode="floor") on int32
__device__ __forceinline__ int floor_div(int x, int e) {
  if (e == 0) return 0;
  const int q = x / e;
  return (x % e != 0 && (x < 0) != (e < 0)) ? q - 1 : q;
}

// The ksw band clamp (ops/extend.py::clamp_band_batch) and the sort key
// (ops/extend_cuda.py::job_keys) of every job: wc, keys [J].
__global__ void prep_kernel(const int* __restrict__ qlen_a,
                            const int* __restrict__ tlen_a,
                            const int* __restrict__ w_a,
                            const int* __restrict__ bonus_a, int mat_max,
                            int* __restrict__ wc_a, int* __restrict__ keys,
                            const Params p) {
  const int job = blockIdx.x * blockDim.x + threadIdx.x;
  if (job >= p.J) return;
  const int reach = qlen_a[job] * mat_max + bonus_a[job];
  const int max_ins = floor_div(reach - p.o_ins, p.e_ins) + 1;
  const int max_del = floor_div(reach - p.o_del, p.e_del) + 1;
  const int w = min(min(w_a[job], max(max_ins, 1)), max(max_del, 1));
  wc_a[job] = w;
  const int ql = min(qlen_a[job], p.Q);
  const int tl = min(tlen_a[job], p.T);
  const int rows = min(max(min(tl, ql + w), 0), (1 << kKeyShift) - 1);
  keys[job] = ql > 0 && tl > 0 ? (ql << kKeyShift) | rows : 0;
}

// start[c] = first sorted position of class >= c (c = 0 .. kClasses), from
// the keys in descending order: thread p writes the classes that begin at p.
__global__ void class_bounds_kernel(const int* __restrict__ keys, int J,
                                    int* __restrict__ start) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p > J) return;
  const int prev = p == 0 ? -1 : key_class(keys[p - 1]);
  const int cur = p == J ? kClasses : key_class(keys[p]);
  for (int c = prev + 1; c <= cur; ++c) start[c] = p;
}

// A dead job's result (nothing to extend): best = h0, the rest as bwa.
__device__ __forceinline__ void write_dead(const int* __restrict__ h0_a,
                                           int* __restrict__ out, int job,
                                           int J) {
  out[0 * J + job] = h0_a[job];
  out[1 * J + job] = 0;
  out[2 * J + job] = 0;
  out[3 * J + job] = 0;
  out[4 * J + job] = -1;
  out[5 * J + job] = 0;
}

bool bad_shape(int Q, int T) { return Q < 1 || Q > 256 || T < 1; }

}  // namespace
