// SMEM chain walks over the FM-index: the three seeding rounds, one thread
// per lane, each running its whole chain to the end (K2).
//
// Replaces the XLA while_loops of tpubwa/ops/smem_chain.py:
// smem_round1_chain (:109, loop :224), smem_through_chain (:232, loop
// :332) and smem_round3_chain (:341, loop :415): the same functions as the
// plain versions tpubwa_torch/ops/smem_chain.py::smem_round1_chain,
// smem_through_chain and smem_round3_chain, bit for bit.  The JAX loops
// (and the plain versions) step every lane in lockstep until the slowest
// one is done; in PyTorch eager each step is ~60 separate launches and the
// loop condition a host sync.
//
// What bounds it on an H100: memory latency.  A chain is a sequence of up
// to a few hundred dependent extension steps; each step gathers two
// 32-byte (narrow) or 64-byte (wide) checkpoint rows at data-dependent
// addresses (at kk and kk + s) and does ~100 integer ops on them.  The
// checkpoint table is N/64 rows: it fits the 50 MB L2 for genomes up to
// ~100 Mbp (narrow) and goes to HBM beyond.
//
// What this design does about it: a lane is a state machine in registers
// (mode, positions, two bi-intervals); it takes exactly the plain
// version's transition per loop turn, so its emissions come out in the
// same order with the same values, but it waits for no other lane and
// stops at its own DONE.  The two rows of a step are fetched with 16-byte
// loads issued together, and the four bases' occ counts come from one
// pass of masked popcounts over the row's four packed words.  Lanes of a
// warp diverge (repeat reads walk long BWD stretches); blocks are small
// (64 threads) so that a batch of 8192 lanes still spreads over all SMs.
//
// Emissions go to m5[lane, slot, 0:5] = (k, l, s, start, end) at slot
// mn[lane]; at mn == cap the emission is dropped and ovf[lane] is set.
// The wrapper zero-fills m5, mn and ovf, so lanes that never start (an
// empty read, an inactive or ambiguous round-2 candidate) and slots past
// mn stay zero, as in the plain versions.  steps[lane] (optional) counts
// the extension steps a lane took.
//
// Index types: T = int32_t for a narrow index, int64_t for a wide one
// (both instantiations are in this library).  Interval arithmetic stays in
// T, as the plain version's stays in the tensors' dtype.  The wide
// checkpoint rows hold the packed words as unsigned values in int64;
// reading them through a cast to uint32_t keeps exactly the low 32 bits,
// which is also the narrow layout's bit pattern.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int FRESH = 0, FWD = 1, BWD = 2, DONE = 3;  // round 3: FWD = EXT3

template <typename T>
struct Index {
  const T* cp;      // [nblocks, 8]: 4 counts + 4 packed words (64 symbols)
  const T* L2;      // [5]
  int64_t primary;  // the sentinel's row
};

// One checkpoint row: counts[4] and the four packed words.
__device__ __forceinline__ void load_row(const int32_t* row, int32_t* counts,
                                         uint32_t* w) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(row));
  const int4 b = __ldg(reinterpret_cast<const int4*>(row) + 1);
  counts[0] = a.x; counts[1] = a.y; counts[2] = a.z; counts[3] = a.w;
  w[0] = static_cast<uint32_t>(b.x); w[1] = static_cast<uint32_t>(b.y);
  w[2] = static_cast<uint32_t>(b.z); w[3] = static_cast<uint32_t>(b.w);
}

__device__ __forceinline__ void load_row(const int64_t* row, int64_t* counts,
                                         uint32_t* w) {
  const longlong2* r = reinterpret_cast<const longlong2*>(row);
  const longlong2 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2),
                  d = __ldg(r + 3);
  counts[0] = a.x; counts[1] = a.y; counts[2] = b.x; counts[3] = b.y;
  w[0] = static_cast<uint32_t>(c.x); w[1] = static_cast<uint32_t>(c.y);
  w[2] = static_cast<uint32_t>(d.x); w[3] = static_cast<uint32_t>(d.y);
}

// occ_full(c, i) for the four bases: counts of each base in BWT[0:i), the
// sentinel never counted (ops/fm.py::occ4).
template <typename T>
__device__ __forceinline__ void occ4(const Index<T>& ix, T i, T* occ) {
  const T j = i - (static_cast<int64_t>(i) > ix.primary ? 1 : 0);
  const int off = static_cast<int>(j & 63);
  T counts[4];
  uint32_t w[4];
  load_row(ix.cp + static_cast<int64_t>(j >> 6) * 8, counts, w);
  uint32_t mask[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = min(max(off - 16 * k, 0), 16);
    mask[k] = p >= 16 ? 0xFFFFFFFFu : (1u << (2 * p)) - 1u;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t pat = static_cast<uint32_t>(c) * 0x55555555u;
    int neq = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t x = w[k] ^ pat;
      neq += __popc((x | (x >> 1)) & 0x55555555u & mask[k]);
    }
    occ[c] = counts[c] + static_cast<T>(off - neq);
  }
}

template <typename T>
__device__ __forceinline__ T pick(const T* a, int c) {
  return c == 0 ? a[0] : c == 1 ? a[1] : c == 2 ? a[2] : a[3];
}

// One extension of (k, l, s) by base c (already complemented for a forward
// append): _mixed_ext + ext_core of the plain version.  Forward steps swap
// k and l on the way in and out.
template <typename T>
__device__ __forceinline__ void ext_step(const Index<T>& ix, const T* L2,
                                         bool is_fwd, T k, T l, T s, int c,
                                         T& nk, T& nl, T& ns) {
  const T kk = is_fwd ? l : k;
  const T ll = is_fwd ? k : l;
  T ok[4], oe[4], sb[4], lb[4];
  occ4(ix, kk, ok);
  occ4(ix, static_cast<T>(kk + s), oe);
#pragma unroll
  for (int b = 0; b < 4; ++b) sb[b] = oe[b] - ok[b];
  // the sentinel row inside [kk, kk+s) takes one slot of the co-interval
  const T sent = (static_cast<int64_t>(kk) <= ix.primary &&
                  ix.primary < static_cast<int64_t>(kk) + s) ? 1 : 0;
  lb[3] = ll + sent;
  lb[2] = lb[3] + sb[3];
  lb[1] = lb[2] + sb[2];
  lb[0] = lb[1] + sb[1];
  const T nk0 = L2[c] + pick(ok, c);
  const T nl0 = pick(lb, c);
  ns = pick(sb, c);
  nk = is_fwd ? nl0 : nk0;
  nl = is_fwd ? nk0 : nl0;
}

template <typename T>
__device__ __forceinline__ void set_intv(const T* L2, int c, T& k, T& l,
                                         T& s) {
  k = L2[c];
  l = L2[3 - c];
  s = L2[c + 1] - k;
}

// q[i] of a read row, 4 outside [0, L)
__device__ __forceinline__ int take_q(const int* q, int L, int i) {
  return (i >= 0 && i < L) ? __ldg(q + i) : 4;
}

template <typename T>
struct Emitter {
  T* m5;   // this lane's [cap, 5]
  int cap;
  int mn = 0;
  int ovf = 0;
  __device__ __forceinline__ void emit(T k, T l, T s, int start, int end) {
    if (mn < cap) {
      T* o = m5 + static_cast<int64_t>(mn) * 5;
      o[0] = k; o[1] = l; o[2] = s;
      o[3] = static_cast<T>(start);
      o[4] = static_cast<T>(end);
      ++mn;
    } else {
      ovf = 1;
    }
  }
};

// The FWD/BWD walk shared by rounds 1 and 2.  Round 1 (kThrough = false)
// restarts at FRESH after a stop and takes at occ >= 1; round 2 ends at a
// stop, takes at occ >= thr and ends once the next root passes `mid`.
template <typename T, bool kThrough>
__device__ __forceinline__ void walk(const Index<T>& ix, const T* L2,
                                     const int* q, int L, int len,
                                     int min_seed_len, T thr, int mid,
                                     int mode, int i, int j, int start,
                                     int e_anchor, T k, T l, T s, T bk, T bl,
                                     T bs, Emitter<T>& em, int& n_steps) {
  while (mode != DONE) {
    if (mode == FRESH) {           // round 1 only: scan for the next root
      if (i >= len) {
        mode = DONE;
      } else {
        const int qi = take_q(q, L, i);
        if (qi <= 3) {
          set_intv(L2, qi, k, l, s);
          start = i;
          mode = FWD;
        }
        ++i;
      }
    } else if (mode == FWD) {
      const int qi = take_q(q, L, i);
      if (i >= len || qi > 3) {    // end or N: emit [start, i)
        if (i - start >= min_seed_len) em.emit(k, l, s, start, i);
        mode = kThrough ? DONE : FRESH;
      } else {
        T nk, nl, ns;
        ext_step(ix, L2, true, k, l, s, 3 - qi, nk, nl, ns);
        ++n_steps;
        if (ns == s || ns >= thr) {
          k = nk; l = nl; s = ns;
          ++i;
        } else {                   // occ drop at i: emit, then walk back
          if (i - start >= min_seed_len) em.emit(k, l, s, start, i);
          set_intv(L2, qi, bk, bl, bs);
          j = i - 1;
          e_anchor = i + 1;
          mode = BWD;
        }
      }
    } else {                       // BWD: longest match ending at e_anchor
      const int qj = take_q(q, L, j);
      bool fail = j < 0 || qj > 3;
      T nk = 0, nl = 0, ns = 0;
      if (!fail) {
        ext_step(ix, L2, false, bk, bl, bs, qj, nk, nl, ns);
        ++n_steps;
        fail = ns < thr;
      }
      if (!fail) {
        bk = nk; bl = nl; bs = ns;
        --j;
      } else if (kThrough && j + 1 > mid) {
        mode = DONE;               // the next root lies past mid
      } else {
        k = bk; l = bl; s = bs;
        start = j + 1;
        i = e_anchor;
        mode = FWD;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
round1_kernel(const Index<T> ix, const int* __restrict__ q,
              const int* __restrict__ lens, int B, int L, int min_seed_len,
              int cap, T* __restrict__ m5, int* __restrict__ mn,
              uint8_t* __restrict__ ovf, int* __restrict__ steps) {
  __shared__ T L2[5];
  if (threadIdx.x < 5) L2[threadIdx.x] = ix.L2[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= B) return;
  const int len = lens[lane];
  Emitter<T> em{m5 + static_cast<int64_t>(lane) * cap * 5, cap};
  int n_steps = 0;
  if (len > 0)
    walk<T, false>(ix, L2, q + static_cast<int64_t>(lane) * L, L, len,
                   min_seed_len, static_cast<T>(1), 0, FRESH, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, em, n_steps);
  mn[lane] = em.mn;
  ovf[lane] = static_cast<uint8_t>(em.ovf);
  if (steps) steps[lane] = n_steps;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
round2_kernel(const Index<T> ix, const int* __restrict__ q,
              const int* __restrict__ lens, const int* __restrict__ rd,
              const int* __restrict__ mid_a, const T* __restrict__ thr_a,
              const uint8_t* __restrict__ act, int G, int L, int min_seed_len,
              int cap, T* __restrict__ m5, int* __restrict__ mn,
              uint8_t* __restrict__ ovf, int* __restrict__ steps) {
  __shared__ T L2[5];
  if (threadIdx.x < 5) L2[threadIdx.x] = ix.L2[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= G) return;
  Emitter<T> em{m5 + static_cast<int64_t>(lane) * cap * 5, cap};
  int n_steps = 0;
  if (act[lane]) {
    const int r = rd[lane];
    const int* qrow = q + static_cast<int64_t>(r) * L;
    const int mid = mid_a[lane];
    const int qm = take_q(qrow, L, mid);
    if (qm < 4) {                  // start in BWD at mid
      T bk, bl, bs;
      set_intv(L2, qm, bk, bl, bs);
      walk<T, true>(ix, L2, qrow, L, lens[r], min_seed_len, thr_a[lane], mid,
                    BWD, 0, mid - 1, mid, mid + 1, 0, 0, 0, bk, bl, bs, em,
                    n_steps);
    }
  }
  mn[lane] = em.mn;
  ovf[lane] = static_cast<uint8_t>(em.ovf);
  if (steps) steps[lane] = n_steps;
}

// Round 3: forward-only restart seeding.  A root at x is extended until
// its interval is smaller than max_mem_intv at length >= min_seed_len; the
// EXTENDED interval is emitted (if non-empty) and the scan restarts after
// it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
round3_kernel(const Index<T> ix, const int* __restrict__ q,
              const int* __restrict__ lens, int B, int L, int min_seed_len,
              int max_mem_intv, int cap, T* __restrict__ m5,
              int* __restrict__ mn, uint8_t* __restrict__ ovf,
              int* __restrict__ steps) {
  __shared__ T L2[5];
  if (threadIdx.x < 5) L2[threadIdx.x] = ix.L2[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= B) return;
  const int len = lens[lane];
  const int* qrow = q + static_cast<int64_t>(lane) * L;
  Emitter<T> em{m5 + static_cast<int64_t>(lane) * cap * 5, cap};
  int n_steps = 0;
  int mode = len > 0 ? FRESH : DONE;
  int i = 0, x = 0;
  T k = 0, l = 0, s = 0;
  while (mode != DONE) {
    if (i >= len) {
      mode = DONE;
      continue;
    }
    const int qi = take_q(qrow, L, i);
    if (mode == FRESH) {
      if (qi <= 3) {
        set_intv(L2, qi, k, l, s);
        x = i;
        mode = FWD;
      }
    } else if (qi > 3) {
      mode = FRESH;
    } else {
      T nk, nl, ns;
      ext_step(ix, L2, true, k, l, s, 3 - qi, nk, nl, ns);
      ++n_steps;
      if (ns < static_cast<T>(max_mem_intv) && i - x >= min_seed_len) {
        if (ns > 0) em.emit(nk, nl, ns, x, i + 1);
        mode = FRESH;
      } else {
        k = nk; l = nl; s = ns;
      }
    }
    ++i;
  }
  mn[lane] = em.mn;
  ovf[lane] = static_cast<uint8_t>(em.ovf);
  if (steps) steps[lane] = n_steps;
}

inline unsigned grid_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename T>
int launch_r1(const void* cp, const void* L2, int64_t primary, const int* q,
              const int* lens, int B, int L, int min_seed_len, int cap,
              void* m5, int* mn, uint8_t* ovf, int* steps, cudaStream_t st) {
  const Index<T> ix{static_cast<const T*>(cp), static_cast<const T*>(L2),
                    primary};
  round1_kernel<T><<<grid_for(B), kThreads, 0, st>>>(
      ix, q, lens, B, L, min_seed_len, cap, static_cast<T*>(m5), mn, ovf,
      steps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_r2(const void* cp, const void* L2, int64_t primary, const int* q,
              const int* lens, const int* rd, const int* mid, const void* thr,
              const uint8_t* act, int G, int L, int min_seed_len, int cap,
              void* m5, int* mn, uint8_t* ovf, int* steps, cudaStream_t st) {
  const Index<T> ix{static_cast<const T*>(cp), static_cast<const T*>(L2),
                    primary};
  round2_kernel<T><<<grid_for(G), kThreads, 0, st>>>(
      ix, q, lens, rd, mid, static_cast<const T*>(thr), act, G, L,
      min_seed_len, cap, static_cast<T*>(m5), mn, ovf, steps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_r3(const void* cp, const void* L2, int64_t primary, const int* q,
              const int* lens, int B, int L, int min_seed_len,
              int max_mem_intv, int cap, void* m5, int* mn, uint8_t* ovf,
              int* steps, cudaStream_t st) {
  const Index<T> ix{static_cast<const T*>(cp), static_cast<const T*>(L2),
                    primary};
  round3_kernel<T><<<grid_for(B), kThreads, 0, st>>>(
      ix, q, lens, B, L, min_seed_len, max_mem_intv, cap,
      static_cast<T*>(m5), mn, ovf, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All three launch on `stream` and return the CUDA error code (0 =
// launched).  cp [nblocks, 8], L2 [5], thr [G] and m5 [lanes, cap, 5] are
// int32 (wide = 0) or int64 (wide = 1); q [B, L], lens [B], rd, mid [G],
// mn [lanes] and steps [lanes] (may be null) are int32; act [G] and ovf
// [lanes] are bytes.  m5, mn and ovf must come in zero-filled.

extern "C" int tpubwa_smem_round1_launch(
    const void* cp, const void* L2, int64_t primary, const int* q,
    const int* lens, int B, int L, int min_seed_len, int cap, void* m5,
    int* mn, uint8_t* ovf, int* steps, int wide, void* stream) {
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return wide ? launch_r1<int64_t>(cp, L2, primary, q, lens, B, L,
                                   min_seed_len, cap, m5, mn, ovf, steps, st)
              : launch_r1<int32_t>(cp, L2, primary, q, lens, B, L,
                                   min_seed_len, cap, m5, mn, ovf, steps, st);
}

extern "C" int tpubwa_smem_round2_launch(
    const void* cp, const void* L2, int64_t primary, const int* q,
    const int* lens, const int* rd, const int* mid, const void* thr,
    const uint8_t* act, int G, int L, int min_seed_len, int cap, void* m5,
    int* mn, uint8_t* ovf, int* steps, int wide, void* stream) {
  if (G == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return wide ? launch_r2<int64_t>(cp, L2, primary, q, lens, rd, mid, thr,
                                   act, G, L, min_seed_len, cap, m5, mn, ovf,
                                   steps, st)
              : launch_r2<int32_t>(cp, L2, primary, q, lens, rd, mid, thr,
                                   act, G, L, min_seed_len, cap, m5, mn, ovf,
                                   steps, st);
}

extern "C" int tpubwa_smem_round3_launch(
    const void* cp, const void* L2, int64_t primary, const int* q,
    const int* lens, int B, int L, int min_seed_len, int max_mem_intv,
    int cap, void* m5, int* mn, uint8_t* ovf, int* steps, int wide,
    void* stream) {
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return wide ? launch_r3<int64_t>(cp, L2, primary, q, lens, B, L,
                                   min_seed_len, max_mem_intv, cap, m5, mn,
                                   ovf, steps, st)
              : launch_r3<int32_t>(cp, L2, primary, q, lens, B, L,
                                   min_seed_len, max_mem_intv, cap, m5, mn,
                                   ovf, steps, st);
}
