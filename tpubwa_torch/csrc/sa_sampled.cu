// Sampled-SA lookup: suffix positions of FM-index rows through a
// position-sampled suffix array and an LF-walk, one thread per row (K5).
//
// Replaces the XLA fori_loop tpubwa/ops/fm.py::sa_lookup_sampled (body
// :355-363, lf_step :283-320): the same function as the plain version
// tpubwa_torch/ops/fm.py::sa_lookup_sampled, bit for bit.  The JAX loop
// (and the plain version) runs 2^shift lockstep iterations over every
// row, ~40 launches each in PyTorch eager, so every row pays for the
// slowest one.
//
// What bounds it on an H100: memory latency.  Each step is two dependent
// random gathers (a 16- or 32-byte rank-directory row, then a 32- or
// 64-byte checkpoint row) and a few dozen integer ops; a walk is a chain
// of up to 2 * 2^shift such loads, and the tables (SA / 2^shift values,
// N/64 directory rows, N/64 checkpoint rows) are far larger than L2 for a
// real genome.
//
// What this design does about it: each thread walks its own row and
// stops at its own sample, after sa[r] mod 2^shift steps (half the
// lockstep loop's on average), and enough threads are in flight to hide
// the gathers' latency.  No shared memory, no synchronisation.
//
// The iteration order is the JAX loop's: probe first (take the sample if
// the row's bit is set, with the number of LF steps taken so far), then
// one LF step.  A row that finds no sample in 2^shift probes gets 0.
//
// Index types: T = int32_t for a narrow index, int64_t for a wide one
// (both instantiations are in this library).  The directory's mask words
// are signed 32-bit values (their uint32 bit pattern), sign-extended in
// the int64 layout; the wide checkpoint rows hold the packed words as
// unsigned values.  Both are read through a cast to uint32_t, which keeps
// exactly the low 32 bits.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
sa_sampled_kernel(const T* __restrict__ rows, const T* __restrict__ cp,
                  const T* __restrict__ blocks, const T* __restrict__ vals,
                  const T* __restrict__ L2, T* __restrict__ out, int64_t R,
                  int64_t primary, int64_t n_vals, int intv) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= R) return;
  int64_t r = static_cast<int64_t>(rows[i]);
  T res = 0;
  for (int t = 0; t < intv; ++t) {
    // probe the rank directory
    const T* b = blocks + (r >> 6) * 4;
    const int off = static_cast<int>(r & 63);
    const uint32_t lo = static_cast<uint32_t>(b[1]);
    const uint32_t hi = static_cast<uint32_t>(b[2]);
    const uint32_t word = off >= 32 ? hi : lo;
    if ((word >> (off & 31)) & 1u) {
      const uint32_t m_lo = off >= 32 ? 0xFFFFFFFFu : (1u << off) - 1u;
      const uint32_t m_hi = off >= 32 ? (1u << (off - 32)) - 1u : 0u;
      int64_t rank = static_cast<int64_t>(b[0]) + __popc(lo & m_lo) +
                     __popc(hi & m_hi);
      rank = rank < 0 ? 0 : (rank > n_vals - 1 ? n_vals - 1 : rank);
      res = static_cast<T>(vals[rank] + t);
      break;
    }
    // one LF step: r = L2[c] + occ(c, r), c = BWT symbol at r
    const int64_t j = r - (r > primary ? 1 : 0);
    const T* row = cp + (j >> 6) * 8;
    const int o = static_cast<int>(j & 63);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = static_cast<uint32_t>(row[4 + k]);
    const int q = o >> 4;  // a select, so w[] stays in registers
    const uint32_t wq = q == 0 ? w[0] : q == 1 ? w[1] : q == 2 ? w[2] : w[3];
    const int c = static_cast<int>((wq >> (2 * (o & 15))) & 3u);
    const uint32_t pat = static_cast<uint32_t>(c) * 0x55555555u;
    int neq = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = min(max(o - 16 * k, 0), 16);
      const uint32_t mask = p >= 16 ? 0xFFFFFFFFu : (1u << (2 * p)) - 1u;
      const uint32_t x = w[k] ^ pat;
      neq += __popc((x | (x >> 1)) & 0x55555555u & mask);
    }
    r = static_cast<int64_t>(L2[c]) + static_cast<int64_t>(row[c]) +
        (o - neq);
  }
  out[i] = res;
}

template <typename T>
int launch(const void* rows, const void* cp, const void* blocks,
           const void* vals, const void* L2, void* out, int64_t R,
           int64_t primary, int64_t n_vals, int intv, cudaStream_t stream) {
  const int64_t grid = (R + kThreads - 1) / kThreads;
  sa_sampled_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(rows), static_cast<const T*>(cp),
      static_cast<const T*>(blocks), static_cast<const T*>(vals),
      static_cast<const T*>(L2), static_cast<T*>(out), R, primary, n_vals,
      intv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`: rows [R], cp [nblocks, 8],
// blocks [nblocks', 4], vals [n_vals], L2 [5] and out [R], all int32
// (wide = 0) or all int64 (wide = 1); intv = 2^shift.  Returns the CUDA
// error code (0 = launched).
extern "C" int tpubwa_sa_sampled_launch(const void* rows, const void* cp,
                                        const void* blocks, const void* vals,
                                        const void* L2, void* out, int64_t R,
                                        int64_t primary, int64_t n_vals,
                                        int intv, int wide, void* stream) {
  if (R == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return wide ? launch<int64_t>(rows, cp, blocks, vals, L2, out, R, primary,
                                n_vals, intv, s)
              : launch<int32_t>(rows, cp, blocks, vals, L2, out, R, primary,
                                n_vals, intv, s);
}
