// Sampled-SA lookup: suffix positions of FM-index rows through a
// position-sampled suffix array and an LF-walk, a thread a row (K5).
//
// Replaces the XLA fori_loop tpubwa/ops/fm.py::sa_lookup_sampled (body
// :355-363, lf_step :283-320): the same function as the plain version
// tpubwa_torch/ops/fm.py::sa_lookup_sampled, bit for bit, on every row
// below the live count (rows at or past it are 0; without a count every
// row is live).  The JAX loop (and the plain version) runs 2^shift
// lockstep iterations over every row.
//
// What bounds it on an H100: a chain of dependent gathers, as K2's walks.
// A row takes sa[r] mod 2^shift LF steps (0 to 31 at shift 5, 15.5 on
// average) and one more probe, each a round trip to the tables (a 16- or
// 32-byte rank-directory row, then a 32- or 64-byte checkpoint row), then
// one gather of the sample.  The arithmetic (~60 integer operations a
// step) is the bound one computes: 0.5438 ms for the 9.2 M rows of a
// 4.6 Mb index at shift 5.  What one measures is the chain or the
// requests.  On the main path's calls (tens of thousands of live rows in
// a buffer of 262,144) it is the chain: the card's own dependent gather
// takes 0.228 us for a warp alone and 0.497 us when 2,048 warps gather at
// once (utils/gather_latency.py), and a warp lasts as long as its longest
// walk (~31 steps while its rows average 15.5).  On a whole index it is
// the L2's rate of random requests: ~300 M row loads in ~2 ms.
//
// What this design does about it:
//   - Only the live rows are walked: the caller passes their count as a
//     device tensor, and the rest are written 0 (the main path's calls
//     hold a quarter of live rows or fewer; the first design walked all).
//   - A step makes the fewest requests: the directory row and the
//     checkpoint row are each one or two 16-byte loads, the checkpoint row
//     only after a probe that missed; occ is two popcounts; L2[0..3] live
//     in registers; positions are 32-bit (a call takes fewer than 2^31
//     rows), rows in T.  No collectives.
//   - Measured and dropped (chip_smoke.py's first runs of this design,
//     PERF.md): refilling a lane with the next row of its warp's run when
//     its walk ends, and loading both rows of a step at once.  On the
//     main path's calls a warp gets too few rows for refills to pay for
//     their ballots, and on a whole index both add requests or
//     instructions to a stream the L2 already cannot serve faster.
//   - No table changes: a fused directory-plus-checkpoint row would halve
//     the requests of a step but cost about N bytes more of device
//     memory, which is what --sa-shift saves.
//
// The iteration order is the JAX loop's: probe first (take the sample if
// the row's bit is set, plus the number of LF steps taken so far), then one
// LF step.  A row that finds no sample in 2^shift probes gets 0.
//
// Index types: T = int32_t for a narrow index, int64_t for a wide one (both
// instantiations are in this library).  The directory's mask words are
// signed 32-bit values (their uint32 bit pattern), sign-extended in the
// int64 layout; the wide checkpoint rows hold the packed words as unsigned
// values.  Both are read through a cast to uint32_t, which keeps exactly
// the low 32 bits.  Every table row starts on a 16-byte boundary (the
// wrapper checks the base addresses).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kEven = 0x5555555555555555ull;

__device__ __forceinline__ void unpack(const int4& x, int32_t* v) {
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void unpack(const longlong2& x, int64_t* v) {
  v[0] = x.x;
  v[1] = x.y;
}

// N consecutive values of a table row, as 16-byte loads
template <int N>
__device__ __forceinline__ void load_row(const int32_t* p, int32_t (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    unpack(__ldg(reinterpret_cast<const int4*>(p) + k), v + 4 * k);
}

template <int N>
__device__ __forceinline__ void load_row(const int64_t* p, int64_t (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k)
    unpack(__ldg(reinterpret_cast<const longlong2*>(p) + k), v + 2 * k);
}

// Two 32-bit words (their low 32 bits) as one 64-bit value, lo first.
__device__ __forceinline__ uint64_t pack(int64_t lo, int64_t hi) {
  return static_cast<uint64_t>(static_cast<uint32_t>(lo)) |
         (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32);
}

// Probe the rank directory row b of row r: is r sampled, and if so the
// index of its sample in vals.
template <typename T>
__device__ __forceinline__ bool probe(const T (&b)[4], T r, T n_vals,
                                      T* rank) {
  const int off = static_cast<int>(r & 63);
  const uint64_t mask = pack(b[1], b[2]);
  if (!((mask >> off) & 1u)) return false;
  const T k = static_cast<T>(b[0] +
                             __popcll(mask & ((uint64_t{1} << off) - 1u)));
  *rank = k < 0 ? 0 : (k > n_vals - 1 ? n_vals - 1 : k);
  return true;
}

// One LF step from checkpoint row `row` of j = r - (r > primary):
// L2[c] + occ(c, r), c = the BWT symbol at r.  occ counts the symbol's
// 2-bit fields in two 64-bit halves of the block, one __popcll each.
template <typename T>
__device__ __forceinline__ T lf_step(const T (&row)[8], T j,
                                     const T (&l2)[4]) {
  const int o = static_cast<int>(j & 63);
  const uint64_t w01 = pack(row[4], row[5]);
  const uint64_t w23 = pack(row[6], row[7]);
  const int sh = 2 * (o & 31);
  const uint64_t part = (uint64_t{1} << sh) - 1u;
  const bool in_hi = o >= 32;
  const int c = static_cast<int>(((in_hi ? w23 : w01) >> sh) & 3u);
  const uint64_t pat = static_cast<uint64_t>(c) * kEven;
  const uint64_t x01 = w01 ^ pat;
  const uint64_t x23 = w23 ^ pat;
  const uint64_t eq01 = ~(x01 | (x01 >> 1)) & kEven;  // fields equal to c
  const uint64_t eq23 = ~(x23 | (x23 >> 1)) & kEven;
  const int occ = __popcll(eq01 & (in_hi ? ~uint64_t{0} : part)) +
                  __popcll(eq23 & (in_hi ? part : uint64_t{0}));
  const T count = c == 0 ? row[0] : c == 1 ? row[1] : c == 2 ? row[2]
                                                            : row[3];
  const T base = c == 0 ? l2[0] : c == 1 ? l2[1] : c == 2 ? l2[2] : l2[3];
  return base + count + occ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sa_sampled_kernel(const T* __restrict__ rows, const T* __restrict__ cp,
                  const T* __restrict__ blocks, const T* __restrict__ vals,
                  const T* __restrict__ L2, T* __restrict__ out,
                  const long long* __restrict__ n_live, int R,
                  T primary, T n_vals, int intv) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R) return;
  int n = R;
  if (n_live) {
    const long long live = *n_live;
    n = live < 0 ? 0 : (live < R ? static_cast<int>(live) : R);
  }
  T res = 0;  // also the result of a row past the live count
  if (i < n) {
    T l2[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) l2[c] = L2[c];
    T b[4], row[8];
    T r = rows[i];
    for (int t = 0; t < intv; ++t) {
      load_row<4>(blocks + (r >> 6) * 4, b);
      T rank;
      if (probe(b, r, n_vals, &rank)) {
        res = static_cast<T>(vals[rank] + t);
        break;
      }
      const T j = r - (r > primary ? 1 : 0);
      load_row<8>(cp + (j >> 6) * 8, row);
      r = lf_step(row, j, l2);
    }
  }
  out[i] = res;
}

template <typename T>
int launch(const void* rows, const void* cp, const void* blocks,
           const void* vals, const void* L2, void* out,
           const long long* n_live, int R, long long primary,
           long long n_vals, int intv, cudaStream_t stream) {
  sa_sampled_kernel<T><<<(R + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(
      static_cast<const T*>(rows), static_cast<const T*>(cp),
      static_cast<const T*>(blocks), static_cast<const T*>(vals),
      static_cast<const T*>(L2), static_cast<T*>(out), n_live, R,
      static_cast<T>(primary), static_cast<T>(n_vals), intv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`: rows [R] (R < 2^31), cp [nblocks, 8],
// blocks [nblocks', 4], vals [n_vals], L2 [5] and out [R], all int32
// (wide = 0) or all int64 (wide = 1), each starting on a 16-byte boundary;
// n_live: null (every row is live) or one int64 on the device, the count
// of leading rows that are looked up (the rest get 0); intv = 2^shift.
// Returns the CUDA error code (0 = launched).
extern "C" int tpubwa_sa_sampled_launch(const void* rows, const void* cp,
                                        const void* blocks, const void* vals,
                                        const void* L2, void* out,
                                        const long long* n_live, int R,
                                        long long primary, long long n_vals,
                                        int intv, int wide, void* stream) {
  if (R <= 0) return R == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return wide ? launch<int64_t>(rows, cp, blocks, vals, L2, out, n_live, R,
                                primary, n_vals, intv, s)
              : launch<int32_t>(rows, cp, blocks, vals, L2, out, n_live, R,
                                primary, n_vals, intv, s);
}
