// SMEM chain walks over the FM-index: the three seeding rounds, a group of
// eight threads per lane, each group running its lane's whole chain to the
// end (K2).
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
// What bounds it on an H100: the latency of one chain.  A chain is a
// sequence of up to a few hundred dependent extension steps; each step
// gathers two 32-byte (narrow) or 64-byte (wide) checkpoint rows at
// data-dependent addresses (at kk and kk + s) and counts the four bases in
// them.  A launch ends with its longest chain, so its floor is that
// chain's steps times the time of one step; the arithmetic of all chains
// together (~180 integer operations a step) is a twentieth of that.  The
// checkpoint table is N/64 rows: it fits the 50 MB L2 for genomes up to
// ~100 Mbp (narrow) and goes to HBM beyond.
//
// What this design does about it:
//   - Eight threads share a lane, so a batch of 8192 lanes puts 65,536
//     threads on the card, and a step is short: thread (r, x) of a group
//     loads the count of base x and the packed word x of row r (r = 0 at
//     kk, r = 1 at kk + s), so both rows' loads are in flight at once, as
//     two 16-byte (narrow) segments a row.  It counts the four bases in
//     its 16 symbols by bit planes into one packed register (a byte a
//     base); two __shfl_xor_sync add the four words, one more exchanges
//     the two rows' counts, and five broadcasts hand every thread the four
//     interval sizes and the count of the step's base.  All threads of a
//     group hold the same lane state (mode, positions, two bi-intervals)
//     in registers and take the same branch, so only groups diverge.
//   - One extension step a turn for the whole warp.  Each group first
//     derives from its mode whether it wants a step and with what
//     (direction, interval, base); the warp runs the step once, groups
//     that want none on a harmless row; then each group does its short
//     mode-specific update.  A lane still takes exactly the plain
//     version's sequence of transitions, so its emissions come out in the
//     same order with the same values, but it waits for no lane outside
//     its warp, and a group that is done keeps taking part in the warp's
//     shuffles until the warp's last group is done.
//   - The read is copied once, as bytes, into shared memory by its group
//     (round 2: the row rd[lane]), so no load from device memory sits
//     between two steps but the checkpoint rows.
//   - An emission is written by five threads of the group, one value each.
// Measured on an H100 (80GB HBM3, 700 W): the three rounds of a batch of
// 8192 reads of 150 bases take 0.65 ms with groups of 8 threads, 0.74 ms
// with 4 and 0.77 ms with 2, and a step of the longest chain ~0.56 us in
// all three, which is the latency of the row loads, not arithmetic.
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

constexpr int kThreads = 128;
constexpr int kGroup = 8;                       // threads a lane
constexpr int kLanes = kThreads / kGroup;       // lanes a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int FRESH = 0, FWD = 1, BWD = 2, DONE = 3;  // round 3: FWD = EXT3

template <typename T>
struct Index {
  const T* cp;      // [nblocks, 8]: 4 counts + 4 packed words (64 symbols)
  const T* L2;      // [5]
  int64_t primary;  // the sentinel's row
};

template <typename T>
__device__ __forceinline__ T pick(const T* a, int c) {
  return c == 0 ? a[0] : c == 1 ? a[1] : c == 2 ? a[2] : a[3];
}

// The four bases' counts among the first `off` symbols of a row, of which
// `word` holds symbols [16 x, 16 x + 16): a byte a base (at most 16 each),
// by bit planes.
__device__ __forceinline__ uint32_t count_word(uint32_t word, int off,
                                               int x) {
  const int p = min(max(off - 16 * x, 0), 16);
  const uint32_t mask =
      (p >= 16 ? 0xFFFFFFFFu : (1u << (2 * p)) - 1u) & 0x55555555u;
  const uint32_t lo = word & mask, hi = (word >> 1) & mask;
  const int n3 = __popc(lo & hi), n2 = __popc(hi & ~lo),
            n1 = __popc(lo & ~hi);
  return static_cast<uint32_t>(p - n1 - n2 - n3) |
         static_cast<uint32_t>(n1) << 8 | static_cast<uint32_t>(n2) << 16 |
         static_cast<uint32_t>(n3) << 24;
}

// One extension of (k, l, s) by base c (already complemented for a forward
// append), computed by the eight threads of a group together; every
// thread of the warp calls it, and all threads of a group pass the same
// arguments and get the same result: _mixed_ext + ext_core of the plain
// version.  Forward steps swap k and l on the way in and out.  occ_full(b,
// i), the count of base b in BWT[0:i) with the sentinel never counted, is
// taken at i = kk (threads 0-3) and at i = kk + s (threads 4-7).
template <typename T>
__device__ __forceinline__ void ext_step(const Index<T>& ix, const T* L2,
                                         bool is_fwd, T k, T l, T s, int c,
                                         T& nk, T& nl, T& ns) {
  const int g = threadIdx.x & (kGroup - 1);
  const T kk = is_fwd ? l : k;
  const T ll = is_fwd ? k : l;
  // thread (r, x) takes base x and packed word x of row r
  const int x = g & 3;
  const T i = (g & 4) ? static_cast<T>(kk + s) : kk;
  const T j = i - (static_cast<int64_t>(i) > ix.primary ? 1 : 0);
  const T* row = ix.cp + static_cast<int64_t>(j >> 6) * 8;
  const T count = __ldg(row + x);
  // a byte a base; the four words' sums are at most 64
  uint32_t packed = count_word(static_cast<uint32_t>(__ldg(row + 4 + x)),
                               static_cast<int>(j & 63), x);
  packed += __shfl_xor_sync(kFull, packed, 1);
  packed += __shfl_xor_sync(kFull, packed, 2);
  const T occ = count + static_cast<T>((packed >> (8 * x)) & 0xFFu);
  const T other = __shfl_xor_sync(kFull, occ, 4);
  const T ok_x = (g & 4) ? other : occ;        // occ_full(x, kk)
  const T sb_x = (g & 4) ? occ - other : other - occ;
  T sb[4];   // the four interval sizes
#pragma unroll
  for (int b = 0; b < 4; ++b) sb[b] = __shfl_sync(kFull, sb_x, b, kGroup);
  const T ok_c = __shfl_sync(kFull, ok_x, c, kGroup);
  // the sentinel row inside [kk, kk+s) takes one slot of the co-interval
  const T sent = (static_cast<int64_t>(kk) <= ix.primary &&
                  ix.primary < static_cast<int64_t>(kk) + s) ? 1 : 0;
  T lb[4];
  lb[3] = ll + sent;
  lb[2] = lb[3] + sb[3];
  lb[1] = lb[2] + sb[2];
  lb[0] = lb[1] + sb[1];
  const T nk0 = L2[c] + ok_c;
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

// The group's copy of a read in shared memory, a byte a base (codes above
// 3 as 4); 4 outside [0, L).
struct Read {
  const uint8_t* q;
  int L;
  __device__ __forceinline__ int at(int i) const {
    return (i >= 0 && i < L) ? q[i] : 4;
  }
};

__device__ __forceinline__ Read load_read(uint8_t* dst, const int* src,
                                          int L) {
  if (src)
    for (int i = threadIdx.x & (kGroup - 1); i < L; i += kGroup) {
      const int v = __ldg(src + i);
      dst[i] = static_cast<uint8_t>(v >= 0 && v <= 3 ? v : 4);
    }
  __syncwarp();
  return Read{dst, L};
}

// A lane's emissions; every thread of the group keeps the counts, five of
// them write one value each.
template <typename T>
struct Emitter {
  T* m5;   // this lane's [cap, 5]
  int cap;
  int mn = 0;
  int ovf = 0;
  __device__ __forceinline__ void emit(T k, T l, T s, int start, int end) {
    if (mn < cap) {
      const int g = threadIdx.x & (kGroup - 1);
      if (g < 5)
        m5[static_cast<int64_t>(mn) * 5 + g] =
            g == 0 ? k : g == 1 ? l : g == 2 ? s
            : static_cast<T>(g == 3 ? start : end);
      ++mn;
    } else {
      ovf = 1;
    }
  }
};

// A lane's state in the FWD/BWD walk of rounds 1 and 2.
template <typename T>
struct Walk {
  int mode, i, j, start, e_anchor;
  T k, l, s, bk, bl, bs;
};

// The FWD/BWD walk shared by rounds 1 and 2, one transition of the plain
// version a turn.  Round 1 (kThrough = false) restarts at FRESH after a
// stop and takes at occ >= 1; round 2 ends at a stop, takes at occ >= thr
// and ends once the next root passes `mid`.  Every thread of the warp
// stays in the loop until all its groups are DONE.
template <typename T, bool kThrough>
__device__ __forceinline__ void walk(const Index<T>& ix, const T* L2,
                                     const Read& rd, int len,
                                     int min_seed_len, T thr, int mid,
                                     Walk<T> w, Emitter<T>& em,
                                     int& n_steps) {
  while (!__all_sync(kFull, w.mode == DONE)) {
    // what this group's turn needs of the shared step
    bool want = false, is_fwd = false;
    int c = 0, qc = 4;
    T a = 0, b = 0, n = 0;
    if (w.mode == FRESH) {         // round 1 only: scan for the next root
      if (w.i >= len) {
        w.mode = DONE;
      } else {
        const int qi = rd.at(w.i);
        if (qi <= 3) {
          set_intv(L2, qi, w.k, w.l, w.s);
          w.start = w.i;
          w.mode = FWD;
        }
        ++w.i;
      }
    } else if (w.mode == FWD) {
      qc = rd.at(w.i);
      if (w.i >= len || qc > 3) {  // end or N: emit [start, i)
        if (w.i - w.start >= min_seed_len)
          em.emit(w.k, w.l, w.s, w.start, w.i);
        w.mode = kThrough ? DONE : FRESH;
      } else {
        want = true; is_fwd = true;
        a = w.k; b = w.l; n = w.s; c = 3 - qc;
      }
    } else if (w.mode == BWD) {    // longest match ending at e_anchor
      qc = rd.at(w.j);
      if (w.j >= 0 && qc <= 3) {
        want = true;
        a = w.bk; b = w.bl; n = w.bs; c = qc;
      }
    }
    T nk, nl, ns;
    ext_step(ix, L2, is_fwd, a, b, n, c, nk, nl, ns);
    if (want) ++n_steps;

    if (w.mode == FWD && want) {
      if (ns == w.s || ns >= thr) {
        w.k = nk; w.l = nl; w.s = ns;
        ++w.i;
      } else {                     // occ drop at i: emit, then walk back
        if (w.i - w.start >= min_seed_len)
          em.emit(w.k, w.l, w.s, w.start, w.i);
        set_intv(L2, qc, w.bk, w.bl, w.bs);
        w.j = w.i - 1;
        w.e_anchor = w.i + 1;
        w.mode = BWD;
      }
    } else if (w.mode == BWD) {
      if (want && !(ns < thr)) {
        w.bk = nk; w.bl = nl; w.bs = ns;
        --w.j;
      } else if (kThrough && w.j + 1 > mid) {
        w.mode = DONE;             // the next root lies past mid
      } else {
        w.k = w.bk; w.l = w.bl; w.s = w.bs;
        w.start = w.j + 1;
        w.i = w.e_anchor;
        w.mode = FWD;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void finish(int lane, const Emitter<T>& em,
                                       int n_steps, int* mn, uint8_t* ovf,
                                       int* steps) {
  if ((threadIdx.x & (kGroup - 1)) == 0) {
    mn[lane] = em.mn;
    ovf[lane] = static_cast<uint8_t>(em.ovf);
    if (steps) steps[lane] = n_steps;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
round1_kernel(const Index<T> ix, const int* __restrict__ q,
              const int* __restrict__ lens, int B, int L, int min_seed_len,
              int cap, T* __restrict__ m5, int* __restrict__ mn,
              uint8_t* __restrict__ ovf, int* __restrict__ steps) {
  extern __shared__ uint8_t reads[];   // [kLanes, L]
  __shared__ T L2[5];
  if (threadIdx.x < 5) L2[threadIdx.x] = ix.L2[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * kLanes + threadIdx.x / kGroup;
  const bool live = lane < B;
  const int len = live ? lens[lane] : 0;
  const Read rd = load_read(
      reads + (threadIdx.x / kGroup) * L,
      live && len > 0 ? q + static_cast<int64_t>(lane) * L : nullptr, L);
  Emitter<T> em{live ? m5 + static_cast<int64_t>(lane) * cap * 5 : nullptr,
                cap};
  int n_steps = 0;
  Walk<T> w{len > 0 ? FRESH : DONE, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  walk<T, false>(ix, L2, rd, len, min_seed_len, static_cast<T>(1), 0, w, em,
                 n_steps);
  if (live) finish(lane, em, n_steps, mn, ovf, steps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
round2_kernel(const Index<T> ix, const int* __restrict__ q,
              const int* __restrict__ lens, const int* __restrict__ rd_a,
              const int* __restrict__ mid_a, const T* __restrict__ thr_a,
              const uint8_t* __restrict__ act, int G, int L, int min_seed_len,
              int cap, T* __restrict__ m5, int* __restrict__ mn,
              uint8_t* __restrict__ ovf, int* __restrict__ steps) {
  extern __shared__ uint8_t reads[];   // [kLanes, L]
  __shared__ T L2[5];
  if (threadIdx.x < 5) L2[threadIdx.x] = ix.L2[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * kLanes + threadIdx.x / kGroup;
  const bool live = lane < G && act[lane];
  const int r = live ? rd_a[lane] : 0;
  const Read rd = load_read(reads + (threadIdx.x / kGroup) * L,
                            live ? q + static_cast<int64_t>(r) * L : nullptr,
                            L);
  Emitter<T> em{lane < G ? m5 + static_cast<int64_t>(lane) * cap * 5
                         : nullptr, cap};
  int n_steps = 0;
  const int mid = live ? mid_a[lane] : 0;
  const int qm = live ? rd.at(mid) : 4;
  Walk<T> w{DONE, 0, mid - 1, mid, mid + 1, 0, 0, 0, 0, 0, 0};
  if (qm < 4) {                    // start in BWD at mid
    set_intv(L2, qm, w.bk, w.bl, w.bs);
    w.mode = BWD;
  }
  walk<T, true>(ix, L2, rd, live ? lens[r] : 0, min_seed_len,
                live ? thr_a[lane] : static_cast<T>(1), mid, w, em, n_steps);
  if (lane < G) finish(lane, em, n_steps, mn, ovf, steps);
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
  extern __shared__ uint8_t reads[];   // [kLanes, L]
  __shared__ T L2[5];
  if (threadIdx.x < 5) L2[threadIdx.x] = ix.L2[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * kLanes + threadIdx.x / kGroup;
  const bool live = lane < B;
  const int len = live ? lens[lane] : 0;
  const Read rd = load_read(
      reads + (threadIdx.x / kGroup) * L,
      live && len > 0 ? q + static_cast<int64_t>(lane) * L : nullptr, L);
  Emitter<T> em{live ? m5 + static_cast<int64_t>(lane) * cap * 5 : nullptr,
                cap};
  int n_steps = 0;
  int mode = len > 0 ? FRESH : DONE;
  int i = 0, x = 0;
  T k = 0, l = 0, s = 0;
  while (!__all_sync(kFull, mode == DONE)) {
    bool want = false;
    int qi = 4;
    if (mode != DONE) {
      if (i >= len) {
        mode = DONE;
      } else {
        qi = rd.at(i);
        if (mode == FRESH) {
          if (qi <= 3) {
            set_intv(L2, qi, k, l, s);
            x = i;
            mode = FWD;
          }
          ++i;
        } else if (qi > 3) {
          mode = FRESH;
          ++i;
        } else {
          want = true;
        }
      }
    }
    T nk, nl, ns;
    ext_step(ix, L2, true, want ? k : static_cast<T>(0),
             want ? l : static_cast<T>(0), want ? s : static_cast<T>(0),
             want ? 3 - qi : 0, nk, nl, ns);
    if (want) {
      ++n_steps;
      if (ns < static_cast<T>(max_mem_intv) && i - x >= min_seed_len) {
        if (ns > 0) em.emit(nk, nl, ns, x, i + 1);
        mode = FRESH;
      } else {
        k = nk; l = nl; s = ns;
      }
      ++i;
    }
  }
  if (live) finish(lane, em, n_steps, mn, ovf, steps);
}

inline unsigned grid_for(int n) { return (n + kLanes - 1) / kLanes; }
inline size_t reads_bytes(int L) { return static_cast<size_t>(kLanes) * L; }

// Reads too long for the default 48 KB of shared memory a block opt in to
// more; beyond the card's limit the launch fails.
template <typename K>
int allow_reads(K kernel, int L) {
  if (reads_bytes(L) <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(reads_bytes(L))));
}

template <typename T>
int launch_r1(const void* cp, const void* L2, int64_t primary, const int* q,
              const int* lens, int B, int L, int min_seed_len, int cap,
              void* m5, int* mn, uint8_t* ovf, int* steps, cudaStream_t st) {
  const Index<T> ix{static_cast<const T*>(cp), static_cast<const T*>(L2),
                    primary};
  if (const int rc = allow_reads(round1_kernel<T>, L)) return rc;
  round1_kernel<T><<<grid_for(B), kThreads, reads_bytes(L), st>>>(
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
  if (const int rc = allow_reads(round2_kernel<T>, L)) return rc;
  round2_kernel<T><<<grid_for(G), kThreads, reads_bytes(L), st>>>(
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
  if (const int rc = allow_reads(round3_kernel<T>, L)) return rc;
  round3_kernel<T><<<grid_for(B), kThreads, reads_bytes(L), st>>>(
      ix, q, lens, B, L, min_seed_len, max_mem_intv, cap,
      static_cast<T*>(m5), mn, ovf, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All three launch on `stream` and return the CUDA error code (0 =
// launched).  cp [nblocks, 8], L2 [5], thr [G] and m5 [lanes, cap, 5] are
// int32 (wide = 0) or int64 (wide = 1); q [B, L], lens [B], rd, mid [G],
// mn [lanes] and steps [lanes] (may be null) are int32; act [G] and ovf
// [lanes] are bytes.  m5, mn and ovf must come in zero-filled.  A block
// keeps its 16 lanes' reads in shared memory, 16 * L bytes.

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
