// Banded affine-gap seed extension (bwa ksw_extend2) in the row layout
// (K1b): a group of lanes per job, sized by the job, one whole DP row of
// the job at a time, spread across the group.
//
// Replaces the Pallas TPU kernel tpubwa/ops/extend_pallas.py::_kernel
// (launched by _extend_core_pallas_b, the round-4 [B, Q] layout): the
// same function as the plain version
// tpubwa_torch/ops/extend.py::_extend_core and as K1 (csrc/extend.cu),
// bit for bit.  What makes the layout is kept: lane l of a group holds the
// contiguous columns [l*C, l*C + C) of a row, and F comes from a max-scan
// across the lanes (K1 runs its rows as a skewed wavefront instead).
//
// What bounds it on an H100: integer operations, ~15 a band cell, are not
// it (a wave of 8192 jobs is some tens of millions of cells, tens of
// microseconds of the card's ALUs).  A row cannot start before the row
// above is complete across the group, so a job takes its rows times the
// chain of dependent warp collectives of one row, and a warp lasts as long
// as its longest job.  The first design (a warp per job in arrival order,
// 32 * ceil(Q/32) columns a row whatever the job's qlen, ~10 dependent
// collectives a row, and a wrapper that clamped the bands with torch ops,
// copied the codes to int32 and read the scores on the host) spent its
// time on masked columns, on long chains, and around the kernel.
//
// What this design does about it:
//   - The jobs are those of K1's wrapper: its prep kernel clamps the bands
//     and makes the sort keys, torch.sort orders them longest first, and
//     the class bounds of csrc/extend_jobs.cuh split them by qlen.  A warp
//     takes 1, 1, 2 or 4 neighbouring jobs of one class in groups of 32,
//     32, 16 or 8 lanes with C0 = max(5, ceil(Q/32)), 4, 4 or 4 columns a
//     lane, so a job of qlen 20 computes 32 columns a row, not 192.  Dead
//     jobs get their constant result from a thread each; results go to
//     each job's own slot.
//   - A row costs 1 + (log2(G) + 1) + (1 or log2(G)) dependent collectives
//     (G = lanes of the group): the diagonal H(i-1, j0-1) by one
//     __shfl_up_sync; F at the lane's first column from a log2(G)-step
//     __shfl_up_sync max-scan of the lane totals of the plain version's
//     running maximum and one shift, then along the lane's columns by
//     bwa's recurrence (the same int32 values for penalties >= 0, and no
//     per-column prefix held in registers); the row maximum m and its
//     LARGEST column mj as ONE maximum
//     of (H << 8 | j), behind a guard that cannot guess wrong: every H of
//     a job is at most max(h0, 0) + qlen * (largest score), and only when
//     that is below 2^23 for every job of the warp is the key used, else m
//     and mj take two reductions.  A group of 32 reduces with
//     __reduce_max_sync, smaller ones with log2(G) __shfl_xor_sync.  The
//     lane that holds column qlen - 1 reads h_last itself (gscore does not
//     steer the loop, so no shuffle).  Groups of one warp run their rows in
//     lockstep; an __any_sync a row ends the warp (groups of 32 need none).
//   - E of the next row is computed from this row's M (no M_prev row);
//     Hopper's DPX instructions fuse max(a + b, c, 0) (__viaddmax_s32_relu)
//     and max(a, b, c) (__vimax3_s32).
//   - Codes are read as given, bytes or 32-bit ints, rows at their own
//     stride; the scores are read from the matrix on the device.
//   - Columns stay absolute (cell c of lane l is column l*C + c).  A
//     band-relative frame pays only when 2w + 1 is well below qlen, and on
//     the main path's waves w clamps to about qlen (chip_smoke.py phase 4
//     prints the share).
//
// The five `No*` template flags cut the same blocks out of this body as
// scripts/ablate_kernel_r5.py::make_kernel cuts out of the TPU kernel
// (results wrong by design, timing only; production runs with all off):
// the F scan, mj, m, h_last and the z-drop test.  With the fused key, m
// and mj are one reduction: no_mj keeps it (H alone, without the column)
// and cuts only the packing, no_m+mj cuts the reduction; no_hlast cuts a
// compare and a select (no shuffle to cut).  Variants read int32 codes,
// for 161 <= Q <= 192 (C0 = 6) only.
#include <cuda_runtime.h>

#include "extend_jobs.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kNeg = -(1 << 30);
constexpr int kColBits = 8;                   // key = H << 8 | j, j < 256
constexpr int kKeyLimit = 1 << (31 - kColBits);  // H below this fits a key
constexpr int kAblateC = 6;                   // the ablation harness's Q

enum : int {
  kNoCummax = 1,
  kNoMj = 2,
  kNoM = 4,
  kNoHlast = 8,
  kNoZdrop = 16,
};

// max(a, b, c)
__device__ __forceinline__ int max3(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vimax3_s32(a, b, c);
#else
  return max(max(a, b), c);
#endif
}

// the maximum of v over the G lanes of a group, in every lane of it
template <int G>
__device__ __forceinline__ int group_max(int v) {
  if constexpr (G == 32) {
    return __reduce_max_sync(kFull, v);
  } else {
#pragma unroll
    for (int d = G / 2; d >= 1; d >>= 1)
      v = max(v, __shfl_xor_sync(kFull, v, d, G));
    return v;
  }
}

// G lanes (a power of two) work on the job at sorted position `pos`, or
// idle along with the warp's other groups if `pos` is past the class.
template <typename Code, int G, int C, int V>
__device__ __forceinline__ void extend_group(
    const Code* __restrict__ query, const Code* __restrict__ target,
    const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
    const int* __restrict__ w_a, const int* __restrict__ h0_a,
    const long long* __restrict__ order, const int* __restrict__ mat,
    int* __restrict__ out, const int pos, const bool valid,
    const Params& p) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);  // lane within the group
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  const int s_match = mat[0], s_mis = mat[1], s_n = mat[4];

  const int job = valid ? static_cast<int>(order[pos]) : 0;
  const int qlen = valid ? min(qlen_a[job], p.Q) : 1;
  const int tlen = valid ? min(tlen_a[job], p.T) : 0;
  // a band wider than the matrix is the whole matrix
  const int w = valid ? min(w_a[job], p.Q + p.T) : 0;
  const int h0 = valid ? h0_a[job] : 0;
  const Code* q = query + static_cast<size_t>(job) * p.q_stride;
  const Code* t = target + static_cast<size_t>(job) * p.t_stride;
  const int j0 = gl * C;
  const int last = (qlen - 1) / C;  // the lane that holds column qlen - 1
  const int last_c = qlen - 1 - last * C;

  // the guard of the fused (H << 8 | j) key: no H of any job of the warp
  // can reach 2^23
  const long long s_top = max(max(max(s_match, s_mis), s_n), 0);
  const bool fits = !valid || static_cast<long long>(max(h0, 0)) +
                                      static_cast<long long>(qlen) * s_top <
                                  kKeyLimit;
  const bool fused = __all_sync(kFull, fits);

  int qc[C], H[C], E[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    qc[c] = valid && j < qlen ? static_cast<int>(q[j]) : 4;
    H[c] = max(h0 - oe_ins - j * p.e_ins, 0);  // row i = -1
    E[c] = 0;                                  // E(0, j)
  }

  int best = h0, best_i = -1, best_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  bool running = valid && tlen > 0;
  int tcode = running ? static_cast<int>(t[0]) : 4;

  for (int i = 0;; ++i) {
    if constexpr (G == 32) {
      if (!running) break;  // the group is the warp
    } else {
      if (!__any_sync(kFull, running)) break;
    }
    const int tnext = running ? static_cast<int>(t[min(i + 1, tlen - 1)]) : 4;
    // H(i-1, j0-1): the boundary column H(i-1, -1) for lane 0
    const int up = __shfl_up_sync(kFull, H[C - 1], 1, G);
    int hd = gl > 0 ? up
             : i == 0 ? h0
             : i - 1 <= w ? max(h0 - p.o_del - p.e_del * i, 0) : 0;
    const int lo = i - w;                  // band: lo <= j < hi
    const int hi = min(i + w + 1, qlen);
    const unsigned width = hi > lo ? static_cast<unsigned>(hi - lo) : 0u;
    const bool t_n = tcode >= 4;

    // M, and the lane's total of g(k) = max(M(k) - oe_ins, 0) + k*e_ins
    int M[C];
    int run = kNeg;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool band = static_cast<unsigned>(j0 + c - lo) < width;
      const int s = (qc[c] >= 4 || t_n) ? s_n
                    : (qc[c] == tcode ? s_match : s_mis);
      M[c] = band && hd > 0 ? hd + s : 0;
      hd = H[c];
      run = max(run, addmax_relu(M[c], -oe_ins, 0) + (j0 + c) * p.e_ins);
    }

    // F(i, j) = max(max_{k<j} g(k) - (j-1)*e_ins, 0): at the lane's first
    // column from the exclusive max-scan of the lanes' totals, then along
    // the lane by the recurrence F(j+1) = max(F(j) - e_ins, M(j) - oe_ins,
    // 0), which gives the same values
    int f = 0;
    if constexpr ((V & kNoCummax) == 0) {
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {  // inclusive max-scan of totals
        const int v = __shfl_up_sync(kFull, run, d, G);
        if (gl >= d) run = max(run, v);
      }
      const int below = __shfl_up_sync(kFull, run, 1, G);
      f = gl == 0 ? 0 : addmax_relu(below, -(j0 - 1) * p.e_ins, 0);
    }

    // H, the next row's E, and what the row maximum needs (out of the band
    // H is 0, which matters only when m is 0, and then the job ends here)
    int key = 0, lmax = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool band = static_cast<unsigned>(j0 + c - lo) < width;
      const int F = (V & kNoCummax) ? M[c] : f;
      const int h = band ? max3(M[c], E[c], F) : 0;
      f = addmax_relu(f, -p.e_ins, M[c] - oe_ins);      // F(i, j+1)
      E[c] = addmax_relu(M[c], -oe_del, E[c] - p.e_del);  // E(i+1, j)
      H[c] = h;
      key = max(key, (V & kNoMj) ? h : (h << kColBits) | (j0 + c));
      lmax = max(lmax, h);
    }

    // the row maximum m and the largest in-band column mj reaching it
    int m, mj;
    if constexpr ((V & kNoM) != 0) {  // cheap stand-in: lane 0's columns
      int sum = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) sum += H[c];
      m = __shfl_sync(kFull, sum, 0, G);
      mj = m;
    } else if (fused) {
      key = group_max<G>(key);
      m = (V & kNoMj) ? key : key >> kColBits;
      mj = (V & kNoMj) ? m : key & ((1 << kColBits) - 1);
    } else {
      m = group_max<G>(lmax);
      if constexpr ((V & kNoMj) != 0) {
        mj = m;
      } else {
        int lj = -1;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (static_cast<unsigned>(j0 + c - lo) < width && H[c] == m)
            lj = j0 + c;
        mj = group_max<G>(lj);
      }
    }

    if (running) {
      // gscore, when the band touches the query end: the lane that holds
      // column qlen - 1 keeps it
      if (!(V & kNoHlast) && gl == last && i + w + 1 >= qlen) {
        int h_last = 0;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (c == last_c) h_last = H[c];
        if (h_last >= gscore) {
          gscore = h_last;
          max_ie = i;
        }
      }
      bool ended = i + 1 >= tlen;
      if (m == 0) {
        ended = true;
      } else if (m > best) {
        best = m;
        best_i = i;
        best_j = mj;
        max_off = max(max_off, abs(mj - i));
      } else if (!(V & kNoZdrop) && p.zdrop > 0) {
        const int di = i - best_i;
        const int dj = mj - best_j;
        const bool z = di > dj ? best - m - (di - dj) * p.e_del > p.zdrop
                               : best - m - (dj - di) * p.e_ins > p.zdrop;
        if (z) ended = true;
      }
      running = !ended;
    }
    tcode = tnext;
  }

  if (valid && gl == last) {
    out[0 * p.J + job] = best;
    out[1 * p.J + job] = best_j + 1;
    out[2 * p.J + job] = best_i + 1;
    out[3 * p.J + job] = max_ie + 1;
    out[4 * p.J + job] = gscore;
    out[5 * p.J + job] = max_off;
  }
}

// At least four blocks an SM: ptxas then keeps every instantiation in
// registers (62-86 of them); left to itself it spilled a few bytes in
// some, to stay at a lower register count.
template <typename Code, int C0, int V>
__global__ void __launch_bounds__(kWarps * 32, 4)
extend_b_kernel(const Code* __restrict__ query,
                const Code* __restrict__ target,
                const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
                const int* __restrict__ w_a, const int* __restrict__ h0_a,
                const long long* __restrict__ order,
                const int* __restrict__ start, const int* __restrict__ mat,
                int* __restrict__ out, const Params p) {
  const int lane = threadIdx.x & 31;
  int wi = blockIdx.x * kWarps + (threadIdx.x >> 5);  // warp of the grid
  // the classes' warps follow each other: 1, 1, 2, 4 and 32 jobs a warp
  int s0 = start[0];
#pragma unroll
  for (int c = 0; c < kClasses; ++c) {
    const int s1 = start[c + 1];
    const int per = jobs_per_warp(c);
    const int warps = (s1 - s0 + per - 1) / per;
    if (wi < warps) {
      const int first = s0 + wi * per;
#define TPUBWA_GROUP(G, C)                                                \
  {                                                                       \
    const int pos = first + lane / G;                                     \
    extend_group<Code, G, C, V>(query, target, qlen_a, tlen_a, w_a, h0_a, \
                                order, mat, out, pos, pos < s1, p);       \
  }
      if (c == 0) TPUBWA_GROUP(32, C0)
      else if (c == 1) TPUBWA_GROUP(32, 4)
      else if (c == 2) TPUBWA_GROUP(16, 4)
      else if (c == 3) TPUBWA_GROUP(8, 4)
#undef TPUBWA_GROUP
      else if (first + lane < s1)  // a dead job: nothing to extend
        write_dead(h0_a, out, static_cast<int>(order[first + lane]), p.J);
      return;
    }
    wi -= warps;
    s0 = s1;
  }
}

struct Args {
  const void* query;
  const void* target;
  const int *qlen, *tlen, *w, *h0;
  const long long* order;
  const int* start;
  const int* mat;
  int* out;
};

template <typename Code, int C0, int V>
int launch(const Args& a, const Params& p, cudaStream_t st) {
  // at most one warp a job (the classes of 1 job a warp), plus one a class
  // for the rounding
  const int blocks = (p.J + kClasses + kWarps - 1) / kWarps;
  extend_b_kernel<Code, C0, V><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const Code*>(a.query), static_cast<const Code*>(a.target),
      a.qlen, a.tlen, a.w, a.h0, a.order, a.start, a.mat, a.out, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Code>
int launch_c0(int c0, const Args& a, const Params& p, cudaStream_t st) {
  switch (c0) {
    case 5: return launch<Code, 5, 0>(a, p, st);
    case 6: return launch<Code, 6, 0>(a, p, st);
    case 7: return launch<Code, 7, 0>(a, p, st);
    case 8: return launch<Code, 8, 0>(a, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_variant(int variant, const Args& a, const Params& p,
                   cudaStream_t st) {
  switch (variant) {  // the ablation sets, int32 codes, C0 = 6
#define TPUBWA_V(v) \
  case v:           \
    return launch<int, kAblateC, v>(a, p, st);
    TPUBWA_V(kNoCummax)
    TPUBWA_V(kNoMj)
    TPUBWA_V(kNoM | kNoMj)
    TPUBWA_V(kNoHlast)
    TPUBWA_V(kNoZdrop)
    TPUBWA_V(kNoCummax | kNoMj | kNoM | kNoHlast | kNoZdrop)
#undef TPUBWA_V
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the extension on `stream`, with K1's arguments
// (tpubwa_extend_launch): query [J, Q] (Q <= 256) and target [J, T] codes,
// uint8 if code_bytes is 1 and int32 if it is 4, rows q_stride and
// t_stride elements apart; qlen, tlen, wc (tpubwa_extend_prep's), h0 [J]
// int32; keys [J] int32, tpubwa_extend_prep's in descending order, and
// order [J] int64, the job at each sorted position; start [6] int32
// scratch; mat [25] int32; out [6, J] int32 = best, qle, tle, gtle,
// gscore, max_off.  `variant` is 0 in production, or one of the ablation
// sets of scripts/ablate_kernel_r5.py (an OR of the No* flags above; int32
// codes and 161 <= Q <= 192 only).  Returns the CUDA error code (0 =
// launched).
extern "C" int tpubwa_extend_b_launch(
    const void* query, const void* target, const int* qlen, const int* tlen,
    const int* wc, const int* h0, const int* keys, const long long* order,
    int* start, const int* mat, int* out, int J, int Q, int T, int q_stride,
    int t_stride, int code_bytes, int o_del, int e_del, int o_ins, int e_ins,
    int zdrop, int variant, void* stream) {
  if (J == 0) return 0;
  if (bad_shape(Q, T) || (code_bytes != 1 && code_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int c0 = max((Q + 31) / 32, 5);  // class 0: 128 < qlen <= Q
  if (variant != 0 && (c0 != kAblateC || code_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  class_bounds_kernel<<<(J + 256) / 256, 256, 0, st>>>(keys, J, start);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{J,     Q,     T,     q_stride, t_stride,
                 o_del, e_del, o_ins, e_ins,    zdrop};
  const Args a{query, target, qlen, tlen, wc, h0, order, start, mat, out};
  if (variant != 0) return launch_variant(variant, a, p, st);
  return code_bytes == 1 ? launch_c0<unsigned char>(c0, a, p, st)
                         : launch_c0<int>(c0, a, p, st);
}
