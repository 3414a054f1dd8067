// Banded global affine-gap alignment (bwa ksw_global2) with traceback and
// CIGAR run-length packing, one warp per lane (K3).
//
// Replaces the XLA scans of tpubwa/ops/global_align.py::global_align_batch
// (:142, scan :233) and global_align_cigar_batch (:247, scan :294) and the
// run-length pack of tpubwa/align/flatsam.py::_ga_rows (:154): the same
// functions as the plain versions
// tpubwa_torch/ops/global_align.py::global_align_cigar_batch and
// tpubwa_torch/align/flatsam.py::_ga_rows, bit for bit.  The JAX package
// ran the fill as a scan over target rows and the traceback as a second
// scan over T+Q steps, with the [B, T, Q] direction matrix in HBM between
// them; in PyTorch eager every row is ~40 launches and every traceback
// step ~15.
//
// What bounds it on an H100: integer ALU work in the fill (~25 ops per
// band cell) and, in the traceback, the latency of a chain of dependent
// one-byte loads (one per CIGAR step).  A lane brings in only its query
// and target window (<= 448 bytes at Q=192, T=256) and writes 52 bytes.
//
// What this design does about it: a warp owns a lane and walks its target
// rows; the 32 threads take 32 neighbouring band columns at a time, so a
// row costs ceil(band / 32) passes whatever Q is.  H (two rows, swapped),
// E and the previous row's M live in shared memory.  F is the plain
// version's exclusive running maximum of M - oe_ins + j*e_ins over the
// in-band columns, as a warp max-scan with a carry between passes, minus
// (j-1)*e_ins: the same int32 expression, not a recurrence on H.  Only
// band cells are computed and stored.  Columns outside the band hold
// -2^30 (the plain version lets them drift by a few gap penalties below
// that; every comparison that sets a direction bit has an in-band value,
// |v| < 2^20, on one side, so the bits are the same).  The direction bytes
// go to a per-block scratch in device memory, indexed by band offset
// (row * min(2w+1, Q) + j - (i-w)), so a lane touches tlen * band bytes
// that stay in L1/L2; blocks are persistent (a grid-stride loop over
// lanes), so the scratch is sized by the grid and not by the batch.  Thread
// 0 then walks the traceback from (tlen-1, min(tlen+w, qlen)-1) and
// run-length encodes it on the fly: neither the direction matrix nor the
// step rows are ever a tensor.
//
// Two outputs from one fill and traceback (template flag kPack):
//   pack  int16 [M, 2 + ga_k]: score, nseg, then (len << 2 | op) per CIGAR
//         segment in CIGAR order; all segments zero when nseg > ga_k;
//   steps uint8 [M, T + Q] (pre-filled with 3 by the wrapper): the op of
//         each traceback step, corner to origin, and score int32 [M].
// CIGAR ops: 0 = M, 1 = I (consumes query), 2 = D (consumes target).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -0x40000000;
constexpr int kMaxPack = 64;  // largest ga_k the pack output takes

struct Params {
  int M, Q, T;        // lanes; padded query / target widths of this call
  int q_stride, t_stride;
  int o_del, e_del, o_ins, e_ins;
  int ga_k;           // pack capacity (kPack only)
};

template <bool kPack>
__global__ void __launch_bounds__(32)
global_align_kernel(const int8_t* __restrict__ qD,
                    const int8_t* __restrict__ tD,
                    const int64_t* __restrict__ rows,
                    const int* __restrict__ qlen_a,
                    const int* __restrict__ tlen_a,
                    const int* __restrict__ w_a, const int* __restrict__ mat,
                    uint8_t* zbuf, int16_t* __restrict__ pack,
                    uint8_t* __restrict__ steps, int* __restrict__ score_out,
                    const Params p) {
  extern __shared__ int sm[];
  const int Q = p.Q;
  int* Ha = sm;                      // [Q+1]: Ha[j+1] = H(i-1, j), Ha[0]: col -1
  int* Hb = Ha + (Q + 1);            // the row being written
  int* E = Hb + (Q + 1);             // [Q]
  int* Mp = E + Q;                   // [Q]: M of the row before
  int* smat = Mp + Q;                // [25]
  int* seg = smat + 25;              // [kMaxPack]: (len << 2 | op), reversed
  int8_t* qs = reinterpret_cast<int8_t*>(seg + kMaxPack);   // [Q]
  const int tid = threadIdx.x;
  if (tid < 25) smat[tid] = mat[tid];
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  uint8_t* z = zbuf + static_cast<size_t>(blockIdx.x) * p.T * Q;

  for (int lane = blockIdx.x; lane < p.M; lane += gridDim.x) {
    const int64_t row = rows[lane];
    const int8_t* q = qD + row * p.q_stride;
    const int8_t* t = tD + row * p.t_stride;
    const int qlen = min(max(qlen_a[lane], 0), Q);
    const int tlen = min(max(tlen_a[lane], 0), p.T);
    // a band wider than the matrix is the whole matrix
    const int w = min(w_a[lane], Q + p.T);
    const int bw = min(2 * max(w, 0) + 1, Q);   // stored cells per row
    const bool shifted = bw < Q;                // row i starts at column i-w

    // row i = -1
    const int fill = min(qlen, w);
    for (int j = tid; j < Q; j += 32) {
      Ha[j + 1] = (j + 1 <= fill) ? -(p.o_ins + p.e_ins * (j + 1)) : kNeg;
      E[j] = kNeg;
      Mp[j] = kNeg;
      qs[j] = j < qlen ? q[j] : 4;
    }
    if (tid == 0) Ha[0] = 0;
    __syncwarp();

    int* Hp = Ha;   // H of row i-1
    int* Hn = Hb;   // H of row i
    for (int i = 0; i < tlen; ++i) {
      const int* mrow = smat + 5 * min(max(static_cast<int>(t[i]), 0), 4);
      const int beg = max(i - w, 0);
      const int end = min(qlen, i + w + 1);
      uint8_t* zrow = z + static_cast<size_t>(i) * bw - (shifted ? i - w : 0);
      int carry = kNeg;   // max of g over the columns of earlier passes
      for (int c0 = beg; c0 < end; c0 += 32) {
        const int j = c0 + tid;
        const bool in = j < end;
        int M = kNeg, e = kNeg, g = kNeg;
        if (in) {
          M = Hp[j] + mrow[min(max(static_cast<int>(qs[j]), 0), 4)];
          e = i > 0 ? max(Mp[j] - oe_del, E[j] - p.e_del) : E[j];
          g = M - oe_ins + j * p.e_ins;
        }
        // exclusive running max of g along the row
        int run = g;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(kFull, run, off);
          if (tid >= off) run = max(run, v);
        }
        int excl = __shfl_up_sync(kFull, run, 1);
        excl = tid == 0 ? carry : max(excl, carry);
        carry = max(carry, __shfl_sync(kFull, run, 31));
        if (in) {
          const int f_in = j > 0 ? excl - (j - 1) * p.e_ins : kNeg;
          int d = M >= e ? 0 : 1;
          int h = max(M, e);
          if (!(h >= f_in)) d = 2;
          h = max(h, f_in);
          int tt = M - oe_del;
          const int e2 = e - p.e_del;
          d |= (e2 > tt ? 1 : 0) << 2;
          E[j] = max(e2, tt);
          tt = M - oe_ins;
          d |= (f_in - p.e_ins > tt ? 1 : 0) << 5;
          zrow[j] = static_cast<uint8_t>(d);
          Hn[j + 1] = h;
          Mp[j] = M;
        }
      }
      if (tid == 0) Hn[0] = i - w <= 0 ? -(p.o_del + p.e_del * (i + 1)) : kNeg;
      __syncwarp();
      int* sw = Hp; Hp = Hn; Hn = sw;
    }

    if (tid == 0) {
      // H(tlen-1, qlen-1): -2^30 when the corner is outside the band
      int score = Hp[qlen];
      if (tlen > 0 && qlen > 0) {
        const int ci = tlen - 1, cj = qlen - 1;
        if (!(cj >= ci - w && cj < ci + w + 1)) score = kNeg;
      }
      int i = tlen - 1;
      int k = min(i + w + 1, qlen) - 1;
      int which = 0;
      int nseg = 0, cur_op = -1, cur_len = 0, n_steps = 0;
      uint8_t* srow = kPack ? nullptr
                            : steps + static_cast<size_t>(lane) * (p.T + Q);
      while (i >= 0 || k >= 0) {
        int op;
        if (i >= 0 && k >= 0) {
          // cells outside the band read as 0, as the plain version's
          // zero-filled matrix does
          const bool inb = k >= i - w && k < i + w + 1;
          const int zv = inb ? z[static_cast<size_t>(i) * bw + k -
                                 (shifted ? i - w : 0)] : 0;
          which = (zv >> (which << 1)) & 3;
          op = which == 0 ? 0 : (which == 1 ? 2 : 1);
        } else {
          op = i >= 0 ? 2 : 1;
        }
        i -= (op == 0 || op == 2) ? 1 : 0;
        k -= (op == 0 || op == 1) ? 1 : 0;
        if (kPack) {
          if (op == cur_op) {
            ++cur_len;
          } else {
            if (cur_op >= 0 && nseg <= p.ga_k)
              seg[nseg - 1] = (cur_len << 2) | cur_op;
            ++nseg;
            cur_op = op;
            cur_len = 1;
          }
        } else {
          srow[n_steps++] = static_cast<uint8_t>(op);
        }
      }
      if (kPack) {
        if (cur_op >= 0 && nseg <= p.ga_k)
          seg[nseg - 1] = (cur_len << 2) | cur_op;
        int16_t* o = pack + static_cast<size_t>(lane) * (2 + p.ga_k);
        o[0] = static_cast<int16_t>(score);
        o[1] = static_cast<int16_t>(nseg);
        const bool fits = nseg <= p.ga_k;
        for (int c = 0; c < p.ga_k; ++c)   // CIGAR order = reversed walk
          o[2 + c] = (fits && c < nseg)
                         ? static_cast<int16_t>(seg[nseg - 1 - c]) : 0;
      } else {
        score_out[lane] = score;
      }
    }
    __syncwarp();   // the next lane reuses the shared rows and the scratch
  }
}

}  // namespace

// Shared memory a block needs for padded query width Q.
static size_t smem_bytes(int Q) {
  return (2 * (static_cast<size_t>(Q) + 1) + 2 * static_cast<size_t>(Q) + 25 +
          kMaxPack) * sizeof(int) + static_cast<size_t>(Q);
}

// Launches the kernel on `stream` with `blocks` persistent one-warp
// blocks: qD [N, q_stride] and tD [N, t_stride] int8 codes; rows [M]
// int64 picks each lane's row; qlen, tlen, w [M] and mat [25] int32; zbuf
// [blocks, T, Q] bytes of scratch.  want_steps = 0 writes pack int16
// [M, 2 + ga_k] (ga_k <= 64); want_steps = 1 writes steps uint8 [M, T + Q]
// (which must come in filled with 3) and score int32 [M].  Returns the
// CUDA error code (0 = launched; 1 = an argument out of range).
extern "C" int tpubwa_global_align_launch(
    const int8_t* qD, const int8_t* tD, const int64_t* rows, const int* qlen,
    const int* tlen, const int* w, const int* mat, uint8_t* zbuf,
    int16_t* pack, uint8_t* steps, int* score, int M, int Q, int T,
    int q_stride, int t_stride, int o_del, int e_del, int o_ins, int e_ins,
    int ga_k, int want_steps, int blocks, void* stream) {
  if (M == 0) return 0;
  if (Q < 1 || T < 1 || blocks < 1 || ga_k < 0 || ga_k > kMaxPack ||
      smem_bytes(Q) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{M, Q, T, q_stride, t_stride, o_del, e_del, o_ins, e_ins,
                 ga_k};
  auto st = static_cast<cudaStream_t>(stream);
  if (want_steps)
    global_align_kernel<false><<<blocks, 32, smem_bytes(Q), st>>>(
        qD, tD, rows, qlen, tlen, w, mat, zbuf, pack, steps, score, p);
  else
    global_align_kernel<true><<<blocks, 32, smem_bytes(Q), st>>>(
        qD, tD, rows, qlen, tlen, w, mat, zbuf, pack, steps, score, p);
  return static_cast<int>(cudaGetLastError());
}
