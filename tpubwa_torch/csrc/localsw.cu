// Batched local Smith-Waterman for mate rescue (bwa ksw_align2 / kswv
// semantics), one thread per rescue job.
//
// Replaces the XLA scan tpubwa/ops/localsw.py::localsw_batch (step
// :99-121, reduction :128-148): the same function as the plain version
// tpubwa_torch/ops/localsw.py::localsw_batch, bit for bit.  The JAX
// package ran it as a lax.scan over up to 1024 target rows; in PyTorch
// eager each row is ~15 separate launches.
//
// What bounds it on an H100: integer ALU work and the latency of the
// dependent chain inside a row.  Each cell costs ~12 integer ops and
// touches 8 bytes of DP state (H and E), while a job brings in only its
// query (<= 192 codes), its target window (<= 1024 codes) and 4 ints of
// parameters.
//
// What this design does about it: each thread owns one job and walks
// its qlen columns of each of its tlen rows in order of j, so F is the
// sequential recurrence  f = max(0, f - e_ins, h - oe_ins)  (equal to the
// exclusive-cummax form of the plain version; the CPU tests pin
// localsw_ref, which uses it, to the JAX scan), and the job stops after
// the first row whose max reaches endsc.  H and E rows live in dynamic
// shared memory laid out [j][thread], so a warp's 32 threads hit 32
// different banks whatever their j.  Row maxima go to a global scratch
// buffer laid out [T][J] (neighbouring threads write neighbouring
// words); score2 needs te, so a second loop over the counted rows reads
// them back.
//
// Tie-breaks are the opposite of the extension kernel's: te is the FIRST
// row reaching the global max and qe the FIRST column reaching that
// row's max (strict > updates).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

struct Params {
  int J, Q, T;
  int o_del, e_del, o_ins, e_ins;
};

__global__ void __launch_bounds__(kThreads)
localsw_kernel(const int* __restrict__ query, const int* __restrict__ target,
               const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
               const int* __restrict__ minsc_a,
               const int* __restrict__ endsc_a, const int* __restrict__ mat,
               int* __restrict__ rowmax, int* __restrict__ out,
               const Params p) {
  extern __shared__ int smem[];
  __shared__ int smat[25];
  const int tid = threadIdx.x;
  if (tid < 25) smat[tid] = mat[tid];
  __syncthreads();
  const int job = blockIdx.x * kThreads + tid;
  if (job >= p.J) return;

  int* H = smem + tid;                   // H[j * kThreads]: H(i-1, j)
  int* E = smem + p.Q * kThreads + tid;  // E[j * kThreads]: E(i-1, j)
  const int* q = query + static_cast<size_t>(job) * p.Q;
  const int* t = target + static_cast<size_t>(job) * p.T;
  const int qlen = max(min(qlen_a[job], p.Q), 0);
  const int tlen = max(min(tlen_a[job], p.T), 0);
  const int endsc = endsc_a[job];
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;

  for (int j = 0; j < qlen; ++j) {
    H[j * kThreads] = 0;
    E[j * kThreads] = 0;
  }
  int gmax = -1, te = -1, qe = -1;
  int n_rows = 0;
  for (int i = 0; i < tlen; ++i) {
    const int* mrow = smat + 5 * min(max(__ldg(t + i), 0), 4);
    int hd = 0;       // H(i-1, j-1); column 0's diagonal is 0
    int f = 0;        // F(i, j)
    int rmax = 0, rarg = 0;
    for (int j = 0; j < qlen; ++j) {
      const int hp = H[j * kThreads];
      const int e = max(max(E[j * kThreads] - p.e_del, hp - oe_del), 0);
      const int h = max(max(hd + mrow[min(max(__ldg(q + j), 0), 4)], e),
                        max(f, 0));
      hd = hp;
      H[j * kThreads] = h;
      E[j * kThreads] = e;
      f = max(max(f - p.e_ins, h - oe_ins), 0);
      if (h > rmax) {  // first column reaching the row max
        rmax = h;
        rarg = j;
      }
    }
    rowmax[static_cast<size_t>(i) * p.J + job] = rmax;
    n_rows = i + 1;
    if (rmax > gmax) {  // first row reaching the global max
      gmax = rmax;
      te = i;
      qe = rarg;
    }
    if (rmax >= endsc) break;
  }

  int score = 0, score2 = -1;
  if (gmax > 0) {
    score = gmax;
    const int minsc = minsc_a[job];
    for (int r = 0; r < n_rows; ++r) {
      const int m = rowmax[static_cast<size_t>(r) * p.J + job];
      if (m >= minsc && (r < te - qlen || r > te + qlen) && m > score2)
        score2 = m;
    }
  } else {
    te = -1;
    qe = -1;
  }
  out[0 * p.J + job] = score;
  out[1 * p.J + job] = te;
  out[2 * p.J + job] = qe;
  out[3 * p.J + job] = score2;
}

}  // namespace

// Launches the kernel on `stream`: query [J, Q], target [J, T], qlen,
// tlen, minsc, endsc [J] int32; mat [25] int32; rowmax [T, J]
// int32 scratch; out [4, J] int32 = score, te, qe, score2.  Returns the
// CUDA error code (0 = launched).
extern "C" int tpubwa_localsw_launch(
    const int* query, const int* target, const int* qlen, const int* tlen,
    const int* minsc, const int* endsc, const int* mat, int* rowmax,
    int* out, int J, int Q, int T, int o_del, int e_del, int o_ins,
    int e_ins, void* stream) {
  if (J == 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(Q) * kThreads * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      localsw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{J, Q, T, o_del, e_del, o_ins, e_ins};
  const int blocks = (J + kThreads - 1) / kThreads;
  localsw_kernel<<<blocks, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      query, target, qlen, tlen, minsc, endsc, mat, rowmax, out, p);
  return static_cast<int>(cudaGetLastError());
}
