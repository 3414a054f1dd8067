// Banded global affine-gap alignment (bwa ksw_global2) with traceback and
// CIGAR run-length packing, one warp per lane, the DP rows in registers
// and the direction bits in shared memory (K3).
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
// What bounds it on an H100: integer operations in the fill (~25 per band
// cell).  A lane brings in only its query and target window (<= 448 bytes
// at Q=192, T=256) and writes 52 bytes.  The main path's bands are narrow
// (25 to 45 cells of a 150-column row), so a design that computes whole
// rows, or a skewed wavefront over absolute columns, wastes most of its
// work; what kept the first design (rows in shared memory, a five-level
// shuffle scan per 32 columns, the traceback as thread 0's chain of
// dependent one-byte loads from a scratch in device memory) at a tenth of
// the bound was many executed instructions per useful one.
//
// What this design does about it:
//   - A warp owns a lane and walks its target rows.  A row is the band's
//     bw = min(2w+1, Q) stored cells; thread t holds C = ceil(bw / 32)
//     neighbouring cells of it, H and the E input of the next row, in
//     registers (C is a template parameter chosen per lane).  Narrow
//     bands use the band's own frame (cell c of row i is column i-w+c), in
//     which the diagonal input is the thread's own register and the E
//     input comes from the cell to the right; bands as wide as the query
//     use absolute columns.  What crosses threads is one shuffle a row for
//     that neighbour and the scan below; nothing of the fill is in shared
//     memory but the codes and the direction bits.
//   - F is the plain version's exclusive running maximum of
//     M - oe_ins + j*e_ins over the in-band columns, minus (j-1)*e_ins:
//     the same int32 expression, not a recurrence on H.  A thread takes
//     the running maximum over its own cells serially and the warp scans
//     the 32 partial maxima once a row, whatever C is.  Columns outside the
//     band hold -2^30 (the plain version lets them drift by a few gap
//     penalties below that; every comparison that sets a direction bit has
//     an in-band value, |v| < 2^20, on one side, so the bits are the same).
//   - A cell's direction byte carries four bits of information (H source,
//     E extends, F extends), so two cells share a byte and a lane's whole
//     matrix, tlen * ceil(bw / 2) bytes, sits in shared memory: at most
//     24.5 KB at Q=192, T=256, a few KB for the main path's bands.  There
//     is no scratch in device memory.
//   - The traceback runs on the whole warp: while it is on the match path
//     the 32 threads look at the next 32 cells of the diagonal at once and
//     a ballot gives the length of the run of matches; gap steps are taken
//     one at a time by all threads alike, from shared memory.  Runs go
//     straight into the run-length code, so neither the direction matrix
//     nor the step rows are ever a tensor.
//   - Lanes are handed out from an atomic counter, so no block is dealt a
//     share in advance.  Two launches a call share the code: the first has
//     four warps a block with a small direction store each (most lanes),
//     and appends the lanes that need more (bands wider than 128 cells or
//     more bytes than its store) to a list; the second, one warp a block
//     with the store of a full matrix, works that list off and ends at
//     once when it is empty.
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
constexpr int kMaxPack = 64;      // largest ga_k the pack output takes
constexpr int kMaxQ = 320;        // 32 threads x 10 cells
constexpr int kNarrowWarps = 4;   // warps a block of the first launch
constexpr int kNarrowBw = 128;    // widest band the first launch takes
constexpr int kMatPad = 32;       // the 25 scores, padded

struct Params {
  int M, Q, T;        // lanes; padded query / target widths of this call
  int q_stride, t_stride;
  int o_del, e_del, o_ins, e_ins;
  int ga_k;           // pack capacity (kPack only)
  int store;          // direction bytes a warp of this launch has
};

// Bytes of shared memory a warp needs beside its direction store: query
// and target codes, then the reversed segments (4-byte aligned).
__host__ __device__ constexpr int codes_bytes(int Q, int T) {
  return ((Q + T + 3) & ~3) + kMaxPack * 4;
}

struct Lane {
  int qlen, tlen, w;  // w as given (clamped to Q + T); it may be negative
  int bw;             // stored cells a row
  int rb;             // bytes a row of direction bits takes
};

// The fill: all rows of one lane.  Writes the direction bits and returns
// H(tlen-1, qlen-1) in every thread (kNeg when that corner lies outside
// the band); tlen > 0 and qlen > 0.
template <int C, bool kShifted>
__device__ __forceinline__ int fill(const uint8_t* qs, const uint8_t* ts,
                                    const int* smat, uint8_t* nib,
                                    const Lane& ln, const Params& p) {
  const int t = threadIdx.x & 31;
  const int c0 = t * C;
  const int w = ln.w, wf = max(ln.w, 0), qlen = ln.qlen;
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  const int e_del = p.e_del, e_ins = p.e_ins;

  // H of row -1 in that row's frame; the E input of row 0 is -2^30
  int H[C], EE[C];
  const int top = min(qlen, w);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c0 + c + (kShifted ? -1 - wf : 0);
    H[c] = (j >= 0 && j + 1 <= top) ? -(p.o_ins + e_ins * (j + 1)) : kNeg;
    EE[c] = kNeg;
  }
  // the query codes of this thread's cells; in the band's frame they move
  // one cell to the left a row
  int qc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c0 + c + (kShifted ? -wf : 0);
    qc[c] = j >= 0 && j < qlen ? qs[j] : 4;
  }

  for (int i = 0; i < ln.tlen; ++i) {
    const int off = kShifted ? i - wf : 0;
    const int* mrow = smat + 5 * ts[i];
    const int bnd = i == 0 ? 0 : -(p.o_del + e_del * i);   // H(i-1, -1)
    // the frame columns [clo, chi) of this row lie in the band and in the
    // query
    const int clo = kShifted ? max(-off, 0) : max(i - w, 0);
    const int chi = w < 0 ? 0
                    : kShifted ? min(ln.bw, qlen - off)
                               : min(min(qlen, i + w + 1), ln.bw);
    const unsigned span = static_cast<unsigned>(max(chi - clo, 0));
    // the neighbour's cell of the row before: H to the left (absolute
    // columns), the E input to the right (the band's frame)
    int edge = kShifted ? __shfl_down_sync(kFull, EE[0], 1)
                        : __shfl_up_sync(kFull, H[C - 1], 1);
    if (kShifted && t == 31) edge = kNeg;

    int M[C];
    unsigned in = 0;
    int run = kNeg;    // max of g over this thread's cells
    const int g0 = (c0 + off) * e_ins - oe_ins;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      int diag = kShifted ? H[c] : (c == 0 ? edge : H[c > 0 ? c - 1 : 0]);
      if (c0 + c + off == 0) diag = bnd;
      M[c] = kNeg;
      if (static_cast<unsigned>(c0 + c - clo) < span) {
        in |= 1u << c;
        M[c] = diag + mrow[qc[c]];
        run = max(run, M[c] + g0 + c * e_ins);
      }
    }
    // exclusive running maximum over the threads before this one (a
    // shuffle from below the warp returns the thread's own value)
    int inc = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      inc = max(inc, __shfl_up_sync(kFull, inc, d));
    int excl = __shfl_up_sync(kFull, inc, 1);
    if (t == 0) excl = kNeg;

    unsigned long long pk = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c0 + c + off;
      const int e = kShifted ? (c + 1 < C ? EE[c + 1 < C ? c + 1 : 0] : edge)
                             : EE[c];
      int h = kNeg, een = kNeg;
      if ((in >> c) & 1u) {
        const int m = M[c];
        const int g = m + g0 + c * e_ins;
        // excl - (j - 1) * e_ins
        const int f_in = j > 0 ? excl - (g - m) - oe_ins + e_ins : kNeg;
        excl = max(excl, g);
        int d = m >= e ? 0 : 1;
        h = max(m, e);
        if (!(h >= f_in)) d = 2;
        h = max(h, f_in);
        int tt = m - oe_del;
        const int e2 = e - e_del;
        d |= (e2 > tt ? 1 : 0) << 2;
        // E of the row after, as that row will take it in
        een = max(tt, max(e2, tt) - e_del);
        tt = m - oe_ins;
        d |= (f_in - e_ins > tt ? 1 : 0) << 3;
        pk |= static_cast<unsigned long long>(d) << (4 * c);
      }
      H[c] = h;
      EE[c] = een;
    }
    if (kShifted) {   // the codes of the next row's cells
#pragma unroll
      for (int c = 0; c + 1 < C; ++c) qc[c] = qc[c + 1];
      const int j = c0 + C + off;
      qc[C - 1] = j >= 0 && j < qlen ? qs[j] : 4;
    }
    // two cells a byte; with an odd C a pair of threads shares bytes and
    // the even one writes them
    int n_bytes = C / 2;
    if (C & 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, pk, 1);
      pk |= other << (4 * C);
      n_bytes = (t & 1) ? 0 : C;
    }
    uint8_t* row = nib + i * ln.rb;
    const int b0 = c0 >> 1;
#pragma unroll
    for (int b = 0; b < (C & 1 ? C : C / 2); ++b)
      if (b < n_bytes && b0 + b < ln.rb)
        row[b0 + b] = static_cast<uint8_t>(pk >> (8 * b));
  }
  // H(tlen-1, qlen-1): -2^30 in a cell outside the band, and when no
  // thread holds that column
  const int cc = qlen - 1 - (kShifted ? ln.tlen - 1 - wf : 0) - c0;
  int corner = kNeg;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c == cc) corner = H[c];
  return __reduce_max_sync(kFull, corner);
}

// The four direction bits of cell (i, k); 0 outside the band, as the plain
// version's zero-filled matrix reads.
__device__ __forceinline__ int dir_bits(const uint8_t* nib, const Lane& ln,
                                        bool shifted, int i, int k) {
  if (!(k >= i - ln.w && k < i + ln.w + 1)) return 0;
  const int c = k - (shifted ? i - max(ln.w, 0) : 0);
  const int v = nib[i * ln.rb + (c >> 1)];
  return (c & 1) ? v >> 4 : v & 15;
}

// Traceback and output of one lane; every thread holds the same state.
template <bool kPack>
__device__ __forceinline__ void trace(const uint8_t* nib, const Lane& ln,
                                      int score, int* seg, int lane,
                                      int16_t* pack, uint8_t* steps,
                                      int* score_out, const Params& p) {
  const int t = threadIdx.x & 31;
  const bool shifted = ln.bw < p.Q;
  int i = ln.tlen - 1;
  int k = min(i + ln.w + 1, ln.qlen) - 1;
  int which = 0;
  int nseg = 0, cur_op = -1, cur_len = 0, n_steps = 0;
  uint8_t* srow =
      kPack ? nullptr : steps + static_cast<size_t>(lane) * (p.T + p.Q);

  while (i >= 0 || k >= 0) {
    int op, n = 1;
    if (i < 0) {            // the rest of the query is an insertion
      op = 1; n = k + 1; k = -1;
    } else if (k < 0) {     // the rest of the target is a deletion
      op = 2; n = i + 1; i = -1;
    } else {
      n = 0;
      if (which == 0) {     // the run of matches along this diagonal
        const bool m = i - t >= 0 && k - t >= 0 &&
                       (dir_bits(nib, ln, shifted, i - t, k - t) & 3) == 0;
        n = __ffs(~__ballot_sync(kFull, m)) - 1;
        if (n < 0) n = 32;
      }
      if (n > 0) {
        op = 0; i -= n; k -= n;
      } else {
        const int zv = dir_bits(nib, ln, shifted, i, k);
        which = which == 0 ? zv & 3
                           : which == 1 ? (zv >> 2) & 1 : (zv >> 2) & 2;
        op = which == 0 ? 0 : (which == 1 ? 2 : 1);
        i -= (op == 0 || op == 2) ? 1 : 0;
        k -= (op == 0 || op == 1) ? 1 : 0;
        n = 1;
      }
    }
    if (kPack) {
      if (op == cur_op) {
        cur_len += n;
      } else {
        if (t == 0 && cur_op >= 0 && nseg <= p.ga_k)
          seg[nseg - 1] = (cur_len << 2) | cur_op;
        ++nseg;
        cur_op = op;
        cur_len = n;
      }
    } else {
      for (int x = t; x < n; x += 32)
        srow[n_steps + x] = static_cast<uint8_t>(op);
      n_steps += n;
    }
  }
  if (kPack) {
    if (t == 0 && cur_op >= 0 && nseg <= p.ga_k)
      seg[nseg - 1] = (cur_len << 2) | cur_op;
    __syncwarp();
    int16_t* o = pack + static_cast<size_t>(lane) * (2 + p.ga_k);
    if (t == 0) {
      o[0] = static_cast<int16_t>(score);
      o[1] = static_cast<int16_t>(nseg);
    }
    const bool fits = nseg <= p.ga_k;
    for (int c = t; c < p.ga_k; c += 32)   // CIGAR order = reversed walk
      o[2 + c] = (fits && c < nseg)
                     ? static_cast<int16_t>(seg[nseg - 1 - c]) : 0;
    __syncwarp();   // the next lane reuses seg
  } else if (t == 0) {
    score_out[lane] = score;
  }
}

// count[0]: the next lane of the first launch; count[1]: lanes on the
// wide list; count[2]: the next entry of the list for the second launch.
template <bool kPack, bool kWide>
__global__ void __launch_bounds__(kWide ? 32 : kNarrowWarps * 32)
global_align_kernel(const int8_t* __restrict__ qD,
                    const int8_t* __restrict__ tD,
                    const int64_t* __restrict__ rows,
                    const int* __restrict__ qlen_a,
                    const int* __restrict__ tlen_a,
                    const int* __restrict__ w_a, const int* __restrict__ mat,
                    int* count, int* wide_list, int16_t* __restrict__ pack,
                    uint8_t* __restrict__ steps, int* __restrict__ score_out,
                    const Params p) {
  // the scores; then per warp: direction store, query and target codes,
  // reversed segments
  extern __shared__ int sm[];
  if (threadIdx.x < 25) sm[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int t = threadIdx.x & 31;
  const int per_warp = p.store + codes_bytes(p.Q, p.T);
  uint8_t* nib = reinterpret_cast<uint8_t*>(sm + kMatPad) +
                 static_cast<size_t>(threadIdx.x >> 5) * per_warp;
  uint8_t* qs = nib + p.store;
  uint8_t* ts = qs + p.Q;
  int* seg = reinterpret_cast<int*>(nib + per_warp - kMaxPack * 4);
  const int n_wide = kWide ? count[1] : 0;

  for (;;) {
    int lane = 0;
    if (t == 0) lane = atomicAdd(count + (kWide ? 2 : 0), 1);
    lane = __shfl_sync(kFull, lane, 0);
    if (lane >= (kWide ? n_wide : p.M)) break;
    if (kWide) lane = wide_list[lane];

    Lane ln;
    ln.qlen = min(max(qlen_a[lane], 0), p.Q);
    ln.tlen = min(max(tlen_a[lane], 0), p.T);
    // a band wider than the matrix is the whole matrix
    ln.w = min(w_a[lane], p.Q + p.T);
    ln.bw = min(2 * max(ln.w, 0) + 1, p.Q);
    ln.rb = (ln.bw + 1) >> 1;
    if (!kWide && (ln.bw > kNarrowBw || ln.tlen * ln.rb > p.store)) {
      if (t == 0) wide_list[atomicAdd(count + 1, 1)] = lane;
      continue;
    }

    const int64_t row = rows[lane];
    const int8_t* q = qD + row * p.q_stride;
    const int8_t* tg = tD + row * p.t_stride;
    for (int j = t; j < ln.qlen; j += 32)
      qs[j] = static_cast<uint8_t>(min(max(static_cast<int>(q[j]), 0), 4));
    for (int j = t; j < ln.tlen; j += 32)
      ts[j] = static_cast<uint8_t>(min(max(static_cast<int>(tg[j]), 0), 4));
    __syncwarp();

    int score;
    if (ln.tlen == 0) {           // H(-1, qlen-1)
      score = ln.qlen == 0 ? 0
              : ln.qlen <= ln.w ? -(p.o_ins + p.e_ins * ln.qlen) : kNeg;
    } else if (ln.qlen == 0) {    // H(tlen-1, -1)
      score = ln.tlen - 1 - ln.w <= 0 ? -(p.o_del + p.e_del * ln.tlen)
                                      : kNeg;
    } else {
      const bool shifted = ln.bw < p.Q;
      const int cells = (ln.bw + 31) >> 5;   // a thread's share of a row
#define TPUBWA_FILL(n)                                                   \
  score = shifted ? fill<n, true>(qs, ts, sm, nib, ln, p)                \
                  : fill<n, false>(qs, ts, sm, nib, ln, p)
      if (!kWide && cells <= 1) { TPUBWA_FILL(1); }
      else if (cells <= 2) { TPUBWA_FILL(2); }
      else if (!kWide && cells <= 3) { TPUBWA_FILL(3); }
      else if (!kWide || cells <= 4) { TPUBWA_FILL(4); }
      else if (cells <= 6) { TPUBWA_FILL(6); }
      else { TPUBWA_FILL(10); }
#undef TPUBWA_FILL
    }
    __syncwarp();   // the direction bits are written
    trace<kPack>(nib, ln, score, seg, lane, pack, steps, score_out, p);
    __syncwarp();   // the next lane reuses the codes and the store
  }
}

size_t block_bytes(int warps, int store, int Q, int T) {
  return kMatPad * sizeof(int) +
         static_cast<size_t>(warps) * (store + codes_bytes(Q, T));
}

template <bool kPack, bool kWide>
int launch(const int8_t* qD, const int8_t* tD, const int64_t* rows,
           const int* qlen, const int* tlen, const int* w, const int* mat,
           int* count, int* wide_list, int16_t* pack, uint8_t* steps,
           int* score, const Params& p, int blocks, cudaStream_t st) {
  const int warps = kWide ? 1 : kNarrowWarps;
  const size_t smem = block_bytes(warps, p.store, p.Q, p.T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        global_align_kernel<kPack, kWide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  global_align_kernel<kPack, kWide><<<blocks, warps * 32, smem, st>>>(
      qD, tD, rows, qlen, tlen, w, mat, count, wide_list, pack, steps, score,
      p);
  return static_cast<int>(cudaGetLastError());
}

// direction bytes of a full matrix
int full_store(int Q, int T) { return ((T * ((Q + 1) / 2)) + 3) & ~3; }

}  // namespace

// Launches the kernel on `stream`: qD [N, q_stride] and tD [N, t_stride]
// int8 codes; rows [M] int64 picks each lane's row; qlen, tlen, w [M] and
// mat [25] int32; count [3] int32, zero-filled, and wide_list [M] int32 are
// scratch.  blocks_narrow four-warp blocks, each warp with narrow_store
// bytes (a multiple of 4) for its direction bits, take the lanes from a
// counter; lanes whose bits do not fit (or whose band is wider than 128
// cells) go to blocks_wide one-warp blocks of a second launch, each with
// the store of a full matrix, T * ceil(Q / 2) bytes.  blocks_wide = 0 makes
// no second launch and is taken only where no lane can need it.  Q <= 320;
// a launch fails where the card has less shared memory than a block needs.
// want_steps = 0 writes pack int16 [M, 2 + ga_k] (ga_k <= 64); want_steps =
// 1 writes steps uint8 [M, T + Q] (which must come in filled with 3) and
// score int32 [M].  Returns the CUDA error code (0 = launched; 1 = an
// argument out of range).
extern "C" int tpubwa_global_align_launch(
    const int8_t* qD, const int8_t* tD, const int64_t* rows, const int* qlen,
    const int* tlen, const int* w, const int* mat, int* count,
    int* wide_list, int16_t* pack, uint8_t* steps, int* score, int M, int Q,
    int T, int q_stride, int t_stride, int o_del, int e_del, int o_ins,
    int e_ins, int ga_k, int want_steps, int narrow_store, int blocks_narrow,
    int blocks_wide, void* stream) {
  if (M == 0) return 0;
  if (Q < 1 || Q > kMaxQ || T < 1 || narrow_store < 0 || (narrow_store & 3) ||
      blocks_narrow < 1 || blocks_wide < 0 || ga_k < 0 || ga_k > kMaxPack ||
      (blocks_wide == 0 &&
       (full_store(Q, T) > narrow_store || Q > kNarrowBw)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{M, Q, T, q_stride, t_stride, o_del, e_del, o_ins, e_ins, ga_k,
           narrow_store};
  auto st = static_cast<cudaStream_t>(stream);
  int rc = want_steps
               ? launch<false, false>(qD, tD, rows, qlen, tlen, w, mat, count,
                                      wide_list, pack, steps, score, p,
                                      blocks_narrow, st)
               : launch<true, false>(qD, tD, rows, qlen, tlen, w, mat, count,
                                     wide_list, pack, steps, score, p,
                                     blocks_narrow, st);
  if (rc != 0 || blocks_wide == 0) return rc;
  p.store = full_store(Q, T);
  return want_steps
             ? launch<false, true>(qD, tD, rows, qlen, tlen, w, mat, count,
                                   wide_list, pack, steps, score, p,
                                   blocks_wide, st)
             : launch<true, true>(qD, tD, rows, qlen, tlen, w, mat, count,
                                  wide_list, pack, steps, score, p,
                                  blocks_wide, st);
}
