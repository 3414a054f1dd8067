// Banded affine-gap seed extension (bwa ksw_extend2), one thread per job.
//
// Replaces the Pallas TPU kernel tpubwa/ops/extend_pallas.py::_kernel_t
// (launched by _extend_core_pallas_t): the same function as the plain
// version tpubwa_torch/ops/extend.py::_extend_core, bit for bit.
//
// What bounds it on an H100: integer ALU work and the latency of the
// dependent chain inside a row.  Each band cell costs ~15 integer ops
// and touches 8 bytes of DP state (H and E), while a job brings in only
// its query (Q ints), the target rows it visits and 6 ints of parameters,
// so bytes per job are tiny against cells per job (up to ~200 x 768).
// The TPU kernel had to march whole 128-job tiles through every row in
// lockstep, computing the full Q-wide row (band or not) and running the
// F recurrence as a log-step exclusive cummax.
//
// What this design does about it: each thread owns one job and walks
// only the band cells of each row, in order of j, so F is the sequential
// bwa recurrence  f = max(f - e_ins, M - oe_ins, 0)  (equal to the
// exclusive-cummax form, which the CPU tests pin), and the job stops at
// its own zero row or z-drop instead of waiting for its tile.  H and E
// rows live in dynamic shared memory laid out [j][thread], so the 32
// threads of a warp always hit 32 different banks whatever their j.
// With Q = 192 and 64 threads a block uses 96 KB, above the 48 KB
// default, hence cudaFuncAttributeMaxDynamicSharedMemorySize.  Warp
// divergence (jobs of a warp have different bands and lengths) and the
// small number of resident warps are what a faster version attacks.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

struct Params {
  int J, Q, T;
  int s_match, s_mis, s_n;
  int o_del, e_del, o_ins, e_ins, zdrop;
};

__global__ void __launch_bounds__(kThreads)
extend_kernel(const int* __restrict__ query, const int* __restrict__ target,
              const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
              const int* __restrict__ w_a, const int* __restrict__ h0_a,
              int* __restrict__ out, const Params p) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x;
  const int job = blockIdx.x * kThreads + tid;
  if (job >= p.J) return;

  int* H = smem + tid;                   // H[j * kThreads]: H(i-1, j)
  int* E = smem + p.Q * kThreads + tid;  // E[j * kThreads]: E(i, j)
  const int* q = query + static_cast<size_t>(job) * p.Q;
  const int* t = target + static_cast<size_t>(job) * p.T;
  // rows past T do not exist (the plain version scans T rows); qlen <= Q
  // is the caller's contract, clamped so shared memory stays in bounds
  const int qlen = min(qlen_a[job], p.Q);
  const int tlen = min(tlen_a[job], p.T);
  const int w = w_a[job];
  const int h0 = h0_a[job];
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;

  // row i = -1: H(-1, j) = max(h0 - oe_ins - j*e_ins, 0); E = 0
  for (int j = 0; j < qlen; ++j) {
    H[j * kThreads] = max(h0 - oe_ins - j * p.e_ins, 0);
    E[j * kThreads] = 0;
  }
  int best = h0, best_i = -1, best_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  int Hb = h0;  // boundary column H(i-1, -1)
  const bool alive = qlen > 0 && tlen > 0;

  for (int i = 0; alive && i < tlen; ++i) {
    const int ti = __ldg(t + i);
    const int beg = max(i - w, 0);
    const int end = min(i + w + 1, qlen);
    int hd = beg == 0 ? Hb : H[(beg - 1) * kThreads];  // H(i-1, j-1)
    int f = 0;                                         // F(i, j)
    int m = 0, mj = -1;
    for (int j = beg; j < end; ++j) {
      const int qj = __ldg(q + j);
      const int s = (qj >= 4 || ti >= 4) ? p.s_n
                    : (qj == ti ? p.s_match : p.s_mis);
      const int M = hd > 0 ? hd + s : 0;
      const int e = E[j * kThreads];
      const int h = max(max(M, e), f);
      hd = H[j * kThreads];
      H[j * kThreads] = h;
      E[j * kThreads] = max(max(M - oe_del, e - p.e_del), 0);  // E(i+1, j)
      f = max(max(f - p.e_ins, M - oe_ins), 0);                // F(i, j+1)
      if (h >= m) {  // largest j reaching the row max
        m = h;
        mj = j;
      }
    }
    // gscore: when the band touches the query end
    if (i + w + 1 >= qlen) {
      const int h_last = qlen - 1 >= beg ? H[(qlen - 1) * kThreads] : 0;
      if (h_last >= gscore) {
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
    } else if (p.zdrop > 0) {
      const int di = i - best_i;
      const int dj = mj - best_j;
      const bool z = di > dj ? best - m - (di - dj) * p.e_del > p.zdrop
                             : best - m - (dj - di) * p.e_ins > p.zdrop;
      if (z) break;
    }
    Hb = i <= w ? max(h0 - p.o_del - p.e_del * (i + 1), 0) : 0;
  }

  out[0 * p.J + job] = best;
  out[1 * p.J + job] = best_j + 1;
  out[2 * p.J + job] = best_i + 1;
  out[3 * p.J + job] = max_ie + 1;
  out[4 * p.J + job] = gscore;
  out[5 * p.J + job] = max_off;
}

}  // namespace

// Launches the kernel on `stream`: query [J, Q], target [J, T], qlen, tlen,
// w (already band-clamped), h0 [J] int32; out [6, J] int32 = best, qle,
// tle, gtle, gscore, max_off.  Returns the CUDA error code (0 = launched).
extern "C" int tpubwa_extend_launch(
    const int* query, const int* target, const int* qlen, const int* tlen,
    const int* w, const int* h0, int* out, int J, int Q, int T, int s_match,
    int s_mis, int s_n, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
    void* stream) {
  if (J == 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(Q) * kThreads * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      extend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{J, Q, T, s_match, s_mis, s_n, o_del, e_del, o_ins, e_ins,
                 zdrop};
  const int blocks = (J + kThreads - 1) / kThreads;
  extend_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      query, target, qlen, tlen, w, h0, out, p);
  return static_cast<int>(cudaGetLastError());
}
