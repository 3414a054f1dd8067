// Banded affine-gap seed extension (bwa ksw_extend2): a group of lanes per
// job, sized by the job, a skewed wavefront with the DP state in registers.
//
// Replaces the Pallas TPU kernel tpubwa/ops/extend_pallas.py::_kernel_t
// (launched by _extend_core_pallas_t): the same function as the plain
// version tpubwa_torch/ops/extend.py::_extend_core, bit for bit.
//
// What bounds it on an H100: integer operations, ~15 a band cell; a job
// brings in a few hundred bytes.  But a wave of 8192 jobs is only some
// tens of millions of cells, which the card's ALUs finish in tens of
// microseconds, so what one measures is the longest job's serial walk and
// the launch itself.  The first design (a thread per job, H and E rows in
// 96 KB of shared memory a block, jobs in arrival order) had 2 resident
// warps an SM, each waiting for the one thread whose job was longest, and
// the retry launch's dead lanes scattered through live warps.
//
// What this design does about it:
//   - The caller orders the jobs by (qlen, rows they can visit), longest
//     first, dead ones (qlen or tlen 0) last, and passes the order and the
//     sorted keys; results are written to each job's own slot, so nothing
//     is permuted in memory.  Sorted jobs fall into size classes by qlen:
//       qlen > 128: 32 lanes x 8 columns     qlen > 64: 32 lanes x 4
//       qlen > 32:  16 lanes x 4             qlen >= 1:  8 lanes x 4
//     and a warp takes 1, 1, 2 or 4 neighbouring jobs of one class, so its
//     jobs are alike and the long jobs start first.  Dead jobs get their
//     constant result from a thread each.  Two one-thread-per-job kernels
//     stand around the caller's sort: one clamps the bands and makes the
//     keys, one finds the class boundaries in the sorted keys (both in
//     csrc/extend_jobs.cuh, which K1b shares).  (As torch
//     operations the clamp and the keys were ~25 launches a call, and the
//     host's launch time, not the card's, was what one measured.)
//   - Lane l of a group holds the query columns [l*C, l*C + C) of H and E,
//     and their codes, in registers; no DP state is in shared memory.
//   - The rows run as a wavefront: at step s lane l works on row s - l, on
//     those of its columns that lie in the band.  Four __shfl_up_sync a
//     step hand on what the next lane needs of the row: H of the lane's
//     last column (the next row's diagonal), F after it (the sequential
//     bwa recurrence  f = max(f - e_ins, M - oe_ins, 0), 0 left of the
//     band), and the running row maximum m with mj, the LARGEST column
//     reaching it (>= updates).  No scan, no reduction.
//   - The lane that holds column qlen - 1 sees the rows complete and in
//     order: it keeps best, the z-drop test, gscore and max_off exactly as
//     the scalar code does, and ends the job at a zero row, a z-drop or
//     the last row; rows in flight past that row are dropped.  One
//     __ballot_sync a step tells the groups of a warp who has ended.
//   - Codes are read as they are given, bytes or 32-bit ints, rows at
//     their own stride (a conversion pass costs more than it saves here);
//     a lane reads its query codes once and fetches the target code of a
//     row one step ahead (copying the target rows to shared memory first,
//     as the local-SW kernel does, was 6 % slower on the main path's
//     waves).  The scores (match, mismatch, N) are read from the matrix
//     on the device: no host round trip.
//   - Hopper's DPX instructions (__viaddmax_s32_relu) fuse the
//     max(a + b, c, 0) steps of E and F.
// Scores stay in 32-bit lanes; there is no packed 16-bit path.
#include <cuda_runtime.h>

#include "extend_jobs.cuh"

namespace {

constexpr int kWarps = 4;

// G lanes (a power of two) work on the job at sorted position `pos`, or
// idle along with the warp's other groups if `pos` is past the class.
template <typename Code, int G, int C>
__device__ __forceinline__ void extend_group(
    const Code* __restrict__ query, const Code* __restrict__ target,
    const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
    const int* __restrict__ w_a, const int* __restrict__ h0_a,
    const long long* __restrict__ order,
    const int* __restrict__ mat, int* __restrict__ out, const int pos,
    const bool valid, const Params& p) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);    // lane within the group
  const int gbase = lane & ~(G - 1);
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  const int s_match = mat[0], s_mis = mat[1], s_n = mat[4];

  const int job = valid ? static_cast<int>(order[pos]) : 0;
  const int qlen = valid ? min(qlen_a[job], p.Q) : 1;
  const int tlen = valid ? min(tlen_a[job], p.T) : 0;
  const int w = valid ? w_a[job] : 0;
  const int h0 = valid ? h0_a[job] : 0;
  const Code* q = query + static_cast<size_t>(job) * p.q_stride;
  const Code* t = target + static_cast<size_t>(job) * p.t_stride;
  const int j0 = gl * C;
  const int last = (qlen - 1) / C;  // the lane that holds column qlen - 1

  int qc[C], H[C], E[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    qc[c] = valid && j < qlen ? static_cast<int>(q[j]) : 4;
    H[c] = max(h0 - oe_ins - j * p.e_ins, 0);  // row i = -1
    E[c] = 0;
  }
  // what this lane hands to the next one after each of its rows
  int h_out = 0, f_out = 0, m_out = 0, mj_out = -1;
  // H(i-1, j0-1) from the lane below; row -1's for the first row
  int diag = max(h0 - oe_ins - (j0 - 1) * p.e_ins, 0);
  int tcode = valid && tlen > 0 ? static_cast<int>(t[0]) : 4;
  // the lane `last` only: the rows in order
  int best = h0, best_i = -1, best_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  bool running = valid && tlen > 0;

  for (int s = 0;; ++s) {
    const int i = s - gl;
    const int h_in = __shfl_up_sync(kFull, h_out, 1, G);
    const int f_in = __shfl_up_sync(kFull, f_out, 1, G);
    const int m_in = __shfl_up_sync(kFull, m_out, 1, G);
    const int mj_in = __shfl_up_sync(kFull, mj_out, 1, G);
    bool ended = false;
    if (running && i >= 0 && i < tlen && gl <= last) {
      const int beg = max(i - w, 0);
      const int end = min(i + w + 1, qlen);
      // boundary column H(i-1, -1) for lane 0
      const int hb = i == 0 ? h0
                     : i - 1 <= w ? max(h0 - p.o_del - p.e_del * i, 0) : 0;
      int hd = gl == 0 ? hb : diag;  // H(i-1, j-1)
      int f = gl == 0 ? 0 : f_in;    // F(i, j)
      int m = gl == 0 ? 0 : m_in;
      int mj = gl == 0 ? -1 : mj_in;
      diag = h_in;
      const bool t_n = tcode >= 4;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        const int sc = (qc[c] >= 4 || t_n) ? s_n
                       : (qc[c] == tcode ? s_match : s_mis);
        const int M = hd > 0 ? hd + sc : 0;
        const int e = E[c];
        const int h = max(max(M, e), f);
        hd = H[c];
        if (j >= beg && j < end) {
          H[c] = h;
          E[c] = addmax_relu(M, -oe_del, e - p.e_del);  // E(i+1, j)
          f = addmax_relu(f, -p.e_ins, M - oe_ins);     // F(i, j+1)
          if (h >= m) {  // largest j reaching the row max
            m = h;
            mj = j;
          }
        } else {
          f = 0;  // left of the band F starts at 0
        }
      }
      h_out = H[C - 1];
      f_out = f;
      m_out = m;
      mj_out = mj;
      tcode = static_cast<int>(t[min(i + 1, tlen - 1)]);

      if (gl == last) {  // the row is complete here
        ended = i + 1 >= tlen;
        // gscore: when the band touches the query end
        if (i + w + 1 >= qlen) {
          int h_last = 0;
          if (qlen - 1 >= beg) {
            const int lc = qlen - 1 - j0;
#pragma unroll
            for (int c = 0; c < C; ++c)
              if (c == lc) h_last = H[c];
          }
          if (h_last >= gscore) {
            gscore = h_last;
            max_ie = i;
          }
        }
        if (m == 0) {
          ended = true;
        } else if (m > best) {
          best = m;
          best_i = i;
          best_j = mj;
          max_off = max(max_off, abs(mj - i));
        } else if (p.zdrop > 0) {
          const int di = i - best_i;
          const int dj = mj - best_j;
          const bool z = di > dj ? best - m - (di - dj) * p.e_del > p.zdrop
                                 : best - m - (dj - di) * p.e_ins > p.zdrop;
          if (z) ended = true;
        }
      }
    }
    // a group runs until its lane `last` has ended; the warp until all have
    const unsigned live = __ballot_sync(kFull, running && !ended);
    running = (live >> (gbase + last)) & 1u;
    if (live == 0) break;
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

template <typename Code>
__global__ void __launch_bounds__(kWarps * 32)
extend_kernel(const Code* __restrict__ query, const Code* __restrict__ target,
              const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
              const int* __restrict__ w_a, const int* __restrict__ h0_a,
              const long long* __restrict__ order,
              const int* __restrict__ start,
              const int* __restrict__ mat, int* __restrict__ out,
              const Params p) {
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
#define TPUBWA_GROUP(G, C)                                                  \
  {                                                                         \
    const int pos = first + lane / G;                                       \
    extend_group<Code, G, C>(query, target, qlen_a, tlen_a, w_a, h0_a,      \
                             order, mat, out, pos, pos < s1, p);            \
  }
      if (c == 0) TPUBWA_GROUP(32, 8)
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

template <typename Code>
int launch(const void* query, const void* target, const int* qlen,
           const int* tlen, const int* w, const int* h0,
           const long long* order, const int* start, const int* mat, int* out,
           const Params& p, cudaStream_t st) {
  // at most one warp a job (the classes of 1 job a warp), plus one a class
  // for the rounding
  const int blocks = (p.J + kClasses + kWarps - 1) / kWarps;
  extend_kernel<Code><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const Code*>(query), static_cast<const Code*>(target), qlen,
      tlen, w, h0, order, start, mat, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Clamps the bands and makes the sort keys on `stream`: qlen, tlen, w,
// end_bonus [J] int32 in; wc (the clamped band) and keys [J] int32 out (key
// = qlen << 16 | rows for a job with qlen and tlen > 0, cut to Q and T, rows
// = min(tlen, qlen + wc); else 0).  Returns the CUDA error code.
extern "C" int tpubwa_extend_prep(
    const int* qlen, const int* tlen, const int* w, const int* end_bonus,
    int* wc, int* keys, int J, int Q, int T, int mat_max, int o_del,
    int e_del, int o_ins, int e_ins, void* stream) {
  if (J == 0) return 0;
  if (bad_shape(Q, T)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{J, Q, T, 0, 0, o_del, e_del, o_ins, e_ins, 0};
  prep_kernel<<<(J + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      qlen, tlen, w, end_bonus, mat_max, wc, keys, p);
  return static_cast<int>(cudaGetLastError());
}

// Launches the extension on `stream`: query [J, Q] (Q <= 256) and target
// [J, T] codes, uint8 if code_bytes is 1 and int32 if it is 4, rows q_stride
// and t_stride elements apart; qlen, tlen, wc (tpubwa_extend_prep's), h0 [J]
// int32; keys [J] int32, tpubwa_extend_prep's in descending order, and order
// [J] int64, the job at each sorted position; start [6] int32 scratch; mat
// [25] int32; out [6, J] int32 = best, qle, tle, gtle, gscore, max_off.
// Returns the CUDA error code (0 = launched).
extern "C" int tpubwa_extend_launch(
    const void* query, const void* target, const int* qlen, const int* tlen,
    const int* wc, const int* h0, const int* keys, const long long* order,
    int* start, const int* mat, int* out, int J, int Q, int T, int q_stride,
    int t_stride, int code_bytes, int o_del, int e_del, int o_ins, int e_ins,
    int zdrop, void* stream) {
  if (J == 0) return 0;
  if (bad_shape(Q, T) || (code_bytes != 1 && code_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  class_bounds_kernel<<<(J + 256) / 256, 256, 0, st>>>(keys, J, start);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{J,     Q,     T,     q_stride, t_stride,
                 o_del, e_del, o_ins, e_ins,    zdrop};
  return code_bytes == 1
             ? launch<unsigned char>(query, target, qlen, tlen, wc, h0, order,
                                     start, mat, out, p, st)
             : launch<int>(query, target, qlen, tlen, wc, h0, order, start,
                           mat, out, p, st);
}
