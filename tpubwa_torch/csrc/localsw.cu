// Batched local Smith-Waterman for mate rescue (bwa ksw_align2 / kswv
// semantics), one warp per rescue job, a skewed wavefront with the DP
// state in registers.
//
// Replaces the XLA scan tpubwa/ops/localsw.py::localsw_batch (step
// :99-121, reduction :128-148): the same function as the plain version
// tpubwa_torch/ops/localsw.py::localsw_batch, bit for bit.  The JAX
// package ran it as a lax.scan over up to 1024 target rows; in PyTorch
// eager each row is ~15 separate launches.
//
// What bounds it on an H100: integer operations.  A cell costs ~12 of
// them and a job brings in only its query (<= 256 bytes), its target
// window (<= 1024 bytes) and 4 ints, so the bytes are nothing beside the
// cells (~95,000 a job at 150 x 640).  What kept the first design (a
// thread per job, H and E rows in 96 KB of shared memory a block) at a
// twentieth of that bound was occupancy and latency: 4 resident warps an
// SM, each cell a chain of shared-memory loads and stores.
//
// What this design does about it:
//   - A warp owns a job.  Lane l holds the C = ceil(qlen / 32) query
//     columns [l*C, l*C + C) of H and E, and their query codes, in
//     registers (C is a template parameter chosen per job, 1..8).  No DP
//     state is in shared memory, so an SM holds tens of warps.
//   - The rows run as a wavefront: at step s lane l works on row s - l.
//     What the next lane needs of a row is handed on with four
//     __shfl_up_sync a step: H of the lane's last column (the diagonal of
//     the next row), F after it, and the row's running maximum with its
//     first column.  No scan and no reduction: F stays the sequential
//     recurrence of the scalar code, carried from lane to lane.
//   - Lane 31 sees the rows complete and in order.  It alone keeps the
//     global maximum with bwa's tie rules (te the FIRST row reaching it,
//     qe the FIRST column reaching that row's maximum: strict > updates)
//     and decides the endsc stop; rows in flight past the stopping row are
//     dropped.  Row maxima wait in shared memory (T ints a warp) for
//     score2, which needs te: the warp scans them together at the end.
//   - Codes are read as they are given, bytes or 32-bit ints, rows at
//     their own stride: the rescue rounds hand over column slices of one
//     int32 buffer, and a conversion pass costs more than it saves.  A
//     lane reads its query codes once; the warp copies its target window
//     into shared memory as bytes first (T bytes a warp), so the code of
//     a row is one shared load a step and never waits for L2.
//   - Hopper's DPX instructions (__viaddmax_s32_relu) fuse the
//     max(a + b, c, 0) steps.  With hnf = max(H(i-1,j-1) + S, E, 0) the F
//     recurrence  f' = max(f - e_ins, max(hnf, f) - oe_ins, 0)  is written
//     f' = max(f - min(e_ins, oe_ins), hnf - oe_ins, 0), the same value,
//     which leaves one instruction a cell on the chain from lane to lane.
// Scores stay in 32-bit lanes; there is no packed 16-bit path.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMatPad = 32;  // the 25 scores, padded

struct Params {
  int J, Q, T;
  int q_stride, t_stride;  // elements between the rows of query and target
  int o_del, e_del, o_ins, e_ins;
};

// max(max(a + b, c), 0)
__device__ __forceinline__ int addmax_relu(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmax_s32_relu(a, b, c);
#else
  return max(max(a + b, c), 0);
#endif
}

// bytes of a warp's target window, a multiple of 4
__host__ __device__ constexpr int target_pad(int T) { return (T + 3) & ~3; }

template <typename Code, int C>
__device__ __forceinline__ void sw_job(
    const Code* __restrict__ q, const unsigned char* t, const int qlen, const int tlen, const int minsc, const int endsc,
    const int* smat, int* rowmax, int* __restrict__ out, const int job,
    const Params& p) {
  const int lane = threadIdx.x & 31;
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  const int fdec = min(p.e_ins, oe_ins);
  const int j0 = lane * C;
  const int jlim = qlen - j0;  // the lane's columns c < jlim exist

  int qc[C], H[C], E[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qc[c] = j0 + c < qlen ? min(max(static_cast<int>(q[j0 + c]), 0), 4) : 4;
    H[c] = 0;
    E[c] = 0;
  }
  // what this lane hands to the next one after each of its rows
  int h_out = 0, f_out = 0, rm_out = 0, ra_out = 0;
  int diag = 0;  // H(i-1, j0-1), from the lane below
  // lane 31 only: the rows in order
  int gmax = -1, te = -1, qe = -1, n_rows = 0;
  bool stopped = false;

  for (int s = 0; s < tlen + 31; ++s) {
    const int i = s - lane;
    const int h_in = __shfl_up_sync(kFull, h_out, 1);
    const int f_in = __shfl_up_sync(kFull, f_out, 1);
    const int rm_in = __shfl_up_sync(kFull, rm_out, 1);
    const int ra_in = __shfl_up_sync(kFull, ra_out, 1);
    if (i >= 0 && i < tlen) {
      const int* mrow = smat + 5 * t[i];
      int hd = lane == 0 ? 0 : diag;  // column 0's diagonal is 0
      int f = lane == 0 ? 0 : f_in;
      int rmax = lane == 0 ? 0 : rm_in;
      int rarg = lane == 0 ? 0 : ra_in;
      diag = h_in;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int hp = H[c];
        const int e = addmax_relu(E[c], -p.e_del, hp - oe_del);
        const int hnf = addmax_relu(hd, mrow[qc[c]], e);
        const int h = max(hnf, f);
        f = addmax_relu(f, -fdec, hnf - oe_ins);
        hd = hp;
        H[c] = h;
        E[c] = e;
        if (c < jlim && h > rmax) {  // first column reaching the row max
          rmax = h;
          rarg = j0 + c;
        }
      }
      h_out = H[C - 1];
      f_out = f;
      rm_out = rmax;
      ra_out = rarg;
      if (lane == 31 && !stopped) {
        rowmax[i] = rmax;
        n_rows = i + 1;
        if (rmax > gmax) {  // first row reaching the global max
          gmax = rmax;
          te = i;
          qe = rarg;
        }
        stopped = rmax >= endsc;
      }
    }
    if (__any_sync(kFull, stopped)) break;
  }

  __syncwarp();
  gmax = __shfl_sync(kFull, gmax, 31);
  te = __shfl_sync(kFull, te, 31);
  n_rows = __shfl_sync(kFull, n_rows, 31);
  int score2 = -1;
  for (int r = lane; r < n_rows; r += 32) {
    const int m = rowmax[r];
    if (m >= minsc && (r < te - qlen || r > te + qlen)) score2 = max(score2, m);
  }
  score2 = __reduce_max_sync(kFull, score2);
  if (lane == 31) {
    const bool hit = gmax > 0;
    out[0 * p.J + job] = hit ? gmax : 0;
    out[1 * p.J + job] = hit ? te : -1;
    out[2 * p.J + job] = hit ? qe : -1;
    out[3 * p.J + job] = hit ? score2 : -1;
  }
}

template <typename Code>
__global__ void __launch_bounds__(kWarps * 32)
localsw_kernel(const Code* __restrict__ query, const Code* __restrict__ target,
               const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
               const int* __restrict__ minsc_a,
               const int* __restrict__ endsc_a, const int* __restrict__ mat,
               int* __restrict__ out, const Params p) {
  // the scores, then T row maxima a warp, then T target bytes a warp
  extern __shared__ int smem[];
  if (threadIdx.x < 25) smem[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int job = blockIdx.x * kWarps + warp;
  if (job >= p.J) return;  // whole warps leave together

  const int qlen = max(min(qlen_a[job], p.Q), 0);
  const int tlen = max(min(tlen_a[job], p.T), 0);
  if (qlen == 0 || tlen == 0) {  // no cell scores above 0
    if ((threadIdx.x & 31) == 0) {
      out[0 * p.J + job] = 0;
      out[1 * p.J + job] = -1;
      out[2 * p.J + job] = -1;
      out[3 * p.J + job] = -1;
    }
    return;
  }
  const Code* q = query + static_cast<size_t>(job) * p.q_stride;
  const Code* tg = target + static_cast<size_t>(job) * p.t_stride;
  int* rowmax = smem + kMatPad + warp * p.T;
  unsigned char* t =
      reinterpret_cast<unsigned char*>(smem + kMatPad + kWarps * p.T) +
      warp * target_pad(p.T);
  for (int k = threadIdx.x & 31; k < tlen; k += 32)
    t[k] = static_cast<unsigned char>(min(max(static_cast<int>(tg[k]), 0), 4));
  __syncwarp();
  const int minsc = minsc_a[job];
  const int endsc = endsc_a[job];
  switch ((qlen + 31) / 32) {
#define TPUBWA_C(n)                                                    \
  case n:                                                              \
    sw_job<Code, n>(q, t, qlen, tlen, minsc, endsc, smem, rowmax, out, \
                    job, p);                                           \
    break;
    TPUBWA_C(1) TPUBWA_C(2) TPUBWA_C(3) TPUBWA_C(4)
    TPUBWA_C(5) TPUBWA_C(6) TPUBWA_C(7) TPUBWA_C(8)
#undef TPUBWA_C
    default:
      break;  // Q <= 256 is the launch function's check
  }
}

template <typename Code>
int launch(const void* query, const void* target, const int* qlen,
           const int* tlen, const int* minsc, const int* endsc,
           const int* mat, int* out, const Params& p, cudaStream_t st) {
  const size_t smem =
      (kMatPad + static_cast<size_t>(kWarps) * p.T) * sizeof(int) +
      static_cast<size_t>(kWarps) * target_pad(p.T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        localsw_kernel<Code>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (p.J + kWarps - 1) / kWarps;
  localsw_kernel<Code><<<blocks, kWarps * 32, smem, st>>>(
      static_cast<const Code*>(query), static_cast<const Code*>(target), qlen,
      tlen, minsc, endsc, mat, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`: query [J, Q] (Q <= 256) and target
// [J, T] codes, uint8 if code_bytes is 1 and int32 if it is 4, rows q_stride
// and t_stride elements apart; qlen, tlen, minsc, endsc [J] int32; mat [25]
// int32; out [4, J] int32 = score, te, qe, score2.  Returns the CUDA error
// code (0 = launched).
extern "C" int tpubwa_localsw_launch(
    const void* query, const void* target, const int* qlen, const int* tlen,
    const int* minsc, const int* endsc, const int* mat, int* out, int J,
    int Q, int T, int q_stride, int t_stride, int code_bytes, int o_del,
    int e_del, int o_ins, int e_ins, void* stream) {
  if (J == 0) return 0;
  if (Q < 1 || Q > 256 || T < 1 || (code_bytes != 1 && code_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{J, Q, T, q_stride, t_stride, o_del, e_del, o_ins, e_ins};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return code_bytes == 1
             ? launch<unsigned char>(query, target, qlen, tlen, minsc, endsc,
                                     mat, out, p, st)
             : launch<int>(query, target, qlen, tlen, minsc, endsc, mat, out,
                           p, st);
}
