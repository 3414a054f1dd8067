// Banded affine-gap seed extension (bwa ksw_extend2), one warp per job.
//
// Replaces the Pallas TPU kernel tpubwa/ops/extend_pallas.py::_kernel
// (launched by _extend_core_pallas_b, the round-4 [B, Q] layout): the
// same function as the plain version
// tpubwa_torch/ops/extend.py::_extend_core and as the thread-per-job
// kernel csrc/extend.cu, bit for bit.
//
// The TPU kernel spreads one job's whole DP row across vector lanes and
// reduces across them: F by a log-step exclusive cummax, the row max m
// and its column mj by lane reductions, M_prev kept in scratch.  Here a
// warp owns a job and lane l holds the contiguous columns
// [l*C, l*C + C) of H, E and M_prev in registers (C = ceil(Q/32), a
// template parameter: 6 for Q = 192, at most 8).  Per row:
//   - H(i-1, j-1) at a lane's first column comes from the lane below
//     (__shfl_up_sync); lane 0 takes the boundary column Hb;
//   - F is an exclusive running max: a serial prefix over the lane's C
//     columns, then a 5-step __shfl_up_sync max-scan over lane totals;
//   - m is a __reduce_max_sync; mj is the LARGEST in-band column with
//     H == m, a second __reduce_max_sync;
//   - h_last (column qlen-1) is one __shfl_sync from the lane holding it.
// The scalar trackers are warp-uniform, and the warp leaves the row loop
// when its own job stops at a zero row or a z-drop (no tile lockstep;
// that changes nothing in the output).
//
// What bounds it on an H100: every row costs ~8 dependent shuffle /
// reduction steps (~20-30 cycles each) whatever the band, against the
// thread-per-job kernel's band-length serial loop and the divergence
// between the jobs of its warps.  Full rows (all C*32 columns, masked)
// are computed, as on the TPU; the integer work per cell is ~15 ops.
//
// The five `No*` template flags cut blocks out of the row exactly as the
// ablation harness scripts/ablate_kernel_r5.py::make_kernel does
// (results wrong by design, timing only); production runs with all off.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 30);
constexpr int kAblateC = 6;  // the ablation harness's Q = 192

enum : int {
  kNoCummax = 1,
  kNoMj = 2,
  kNoM = 4,
  kNoHlast = 8,
  kNoZdrop = 16,
};

struct Params {
  int J, Q, T;
  int s_match, s_mis, s_n;
  int o_del, e_del, o_ins, e_ins, zdrop;
};

template <int C, int V>
__global__ void __launch_bounds__(kWarps * 32)
extend_b_kernel(const int* __restrict__ query, const int* __restrict__ target,
                const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
                const int* __restrict__ w_a, const int* __restrict__ h0_a,
                int* __restrict__ out, const Params p) {
  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (job >= p.J) return;  // whole warps leave together

  const int* q = query + static_cast<size_t>(job) * p.Q;
  const int* t = target + static_cast<size_t>(job) * p.T;
  const int qlen = min(qlen_a[job], p.Q);
  const int tlen = min(tlen_a[job], p.T);
  const int w = w_a[job];
  const int h0 = h0_a[job];
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  const int j0 = lane * C;

  int qc[C], H[C], E[C], Mp[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    qc[c] = j < p.Q ? __ldg(q + j) : 4;
    H[c] = max(h0 - oe_ins - j * p.e_ins, 0);  // row i = -1
    E[c] = 0;
    Mp[c] = 0;
  }
  // the lane holding h_last = H(i, qlen-1), and its register
  const int last_lane = qlen > 0 ? (qlen - 1) / C : 0;
  const int last_c = qlen > 0 ? (qlen - 1) % C : 0;

  int best = h0, best_i = -1, best_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  int Hb = h0;  // boundary column H(i-1, -1)
  const bool alive = qlen > 0 && tlen > 0;

  for (int i = 0; alive && i < tlen; ++i) {
    const int ti = __ldg(t + i);
    const int lo = i - w, hi = i + w + 1;  // band: lo <= j < hi, j < qlen
    const int beg = max(lo, 0);
    const int up = __shfl_up_sync(kFull, H[C - 1], 1);
    int hd = lane == 0 ? Hb : up;  // H(i-1, j-1) at the lane's first column

    int M[C];
    bool band[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      band[c] = j >= lo && j < hi && j < qlen;
      const int s = (qc[c] >= 4 || ti >= 4) ? p.s_n
                    : (qc[c] == ti ? p.s_match : p.s_mis);
      M[c] = band[c] && hd > 0 ? hd + s : 0;
      hd = H[c];
    }

    // F(i, j) = max(max_{k<j}(max(M(k) - oe_ins, 0) + k*e_ins)
    //               - (j-1)*e_ins, 0) for j > beg, else 0
    int F[C];
    if (V & kNoCummax) {
#pragma unroll
      for (int c = 0; c < C; ++c) F[c] = M[c];
    } else {
      int run = kNeg;
      int excl[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        excl[c] = run;
        run = max(run, max(M[c] - oe_ins, 0) + (j0 + c) * p.e_ins);
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {  // inclusive max-scan of totals
        const int v = __shfl_up_sync(kFull, run, d);
        if (lane >= d) run = max(run, v);
      }
      int below = __shfl_up_sync(kFull, run, 1);
      if (lane == 0) below = kNeg;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        F[c] = j > beg ? max(max(below, excl[c]) - (j - 1) * p.e_ins, 0) : 0;
      }
    }

    int lmax = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      E[c] = max(max(Mp[c] - oe_del, E[c] - p.e_del), 0);  // E(i, j)
      H[c] = band[c] ? max(max(M[c], E[c]), F[c]) : 0;
      Mp[c] = M[c];
      lmax = max(lmax, H[c]);
    }

    int m;
    if (V & kNoM) {  // cheap stand-in: lane 0's own columns
      int sum = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) sum += H[c];
      m = __shfl_sync(kFull, sum, 0);
    } else {
      m = __reduce_max_sync(kFull, lmax);
    }
    int mj;
    if (V & kNoMj) {
      mj = m;
    } else {
      int lj = -1;  // largest in-band column reaching the row max
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (band[c] && H[c] == m) lj = j0 + c;
      mj = __reduce_max_sync(kFull, lj);
    }
    const int boundary = i <= w ? max(h0 - p.o_del - p.e_del * (i + 1), 0)
                                : 0;

    if (!(V & kNoHlast)) {  // gscore: when the band touches the query end
      int mine = 0;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c == last_c) mine = H[c];
      const int h_last = __shfl_sync(kFull, mine, last_lane);
      if (hi >= qlen && h_last >= gscore) {
        gscore = h_last;
        max_ie = i;
      }
    }
    if (m == 0) break;
    if (m > best) {
      best = m;
      best_i = i;
      best_j = mj;
      max_off = max(max_off, abs(mj - i));
    } else if (!(V & kNoZdrop) && p.zdrop > 0) {
      const int di = i - best_i;
      const int dj = mj - best_j;
      const bool z = di > dj ? best - m - (di - dj) * p.e_del > p.zdrop
                             : best - m - (dj - di) * p.e_ins > p.zdrop;
      if (z) break;
    }
    Hb = boundary;
  }

  if (lane == 0) {
    out[0 * p.J + job] = best;
    out[1 * p.J + job] = best_j + 1;
    out[2 * p.J + job] = best_i + 1;
    out[3 * p.J + job] = max_ie + 1;
    out[4 * p.J + job] = gscore;
    out[5 * p.J + job] = max_off;
  }
}

template <int C, int V>
int launch(const int* query, const int* target, const int* qlen,
           const int* tlen, const int* w, const int* h0, int* out,
           const Params& p, cudaStream_t stream) {
  const int blocks = (p.J + kWarps - 1) / kWarps;
  extend_b_kernel<C, V><<<blocks, kWarps * 32, 0, stream>>>(
      query, target, qlen, tlen, w, h0, out, p);
  return static_cast<int>(cudaGetLastError());
}

int launch_c(int C, const int* query, const int* target, const int* qlen,
             const int* tlen, const int* w, const int* h0, int* out,
             const Params& p, cudaStream_t stream) {
  switch (C) {
#define TPUBWA_C(n) \
  case n:           \
    return launch<n, 0>(query, target, qlen, tlen, w, h0, out, p, stream);
    TPUBWA_C(1) TPUBWA_C(2) TPUBWA_C(3) TPUBWA_C(4)
    TPUBWA_C(5) TPUBWA_C(6) TPUBWA_C(7) TPUBWA_C(8)
#undef TPUBWA_C
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the kernel on `stream`: query [J, Q] (Q <= 256), target [J, T],
// qlen, tlen, w (already band-clamped), h0 [J] int32; out [6, J] int32 =
// best, qle, tle, gtle, gscore, max_off.  `variant` is 0 in production, or
// one of the ablation sets of scripts/ablate_kernel_r5.py (an OR of the
// No* flags above; 161 <= Q <= 192 only).  Returns the CUDA error code
// (0 = launched).
extern "C" int tpubwa_extend_b_launch(
    const int* query, const int* target, const int* qlen, const int* tlen,
    const int* w, const int* h0, int* out, int J, int Q, int T, int s_match,
    int s_mis, int s_n, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
    int variant, void* stream) {
  if (J == 0) return 0;
  const int C = (Q + 31) / 32;
  if (C < 1 || C > 8) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{J, Q, T, s_match, s_mis, s_n, o_del, e_del, o_ins, e_ins,
                 zdrop};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    return launch_c(C, query, target, qlen, tlen, w, h0, out, p, s);
  if (C != kAblateC) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {  // the ablation sets, built for Q = 192 only
#define TPUBWA_V(v) \
  case v:           \
    return launch<kAblateC, v>(query, target, qlen, tlen, w, h0, out, p, s);
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
