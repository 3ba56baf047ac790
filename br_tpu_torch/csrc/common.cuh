// Shared device helpers of the port's kernels: 2-bit k-mer math in a
// register of type T (every helper is a template on T), the two
// membership probes and the probe policies the k-mer kernels are
// templated on, slot lookups.
//
// A k-mer kernel has three instantiations: uint32_t registers with the
// bitfield probe (an odd k <= 15), uint64_t with the bitfield probe (k =
// 17), and uint64_t with the sorted-table probe (a HashSet, any k <= 31:
// 62 bits of k-mer).
//
// Encoding (as in the JAX package): code = (ascii >> 1) & 3, so A=0 C=1
// T=2 G=3 and the complement of a code is code ^ 2; the canonical k-mer
// is whichever of {kmer, revcomp(kmer)} has an even popcount; its solid
// bit is bit (cano >> 1) & 31 of little-endian word (cano >> 1) >> 5 (at
// k = 17 the bit index reaches 2^33, its word index 2^28).  A sorted
// table holds the canonical k-mers as uint64, ascending, padded to
// 2^levels entries with a sentinel above every k-mer (1 << min(2k+1,
// 63), br_tpu/set/hash.py:108).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The checked build (nvcc -DBR_BOUNDS_CHECK; kernels.py builds it where
// BR_BOUNDS_CHECK=1 is set): an index outside its array prints where and
// traps, as a memory checker stops at the access.  Otherwise no code.
#ifdef BR_BOUNDS_CHECK
#include <cstdio>
#define BR_CHECK(cond)                                                   \
  do {                                                                   \
    if (!(cond)) {                                                       \
      printf("bounds check failed: %s:%d: %s (block %d, thread %d)\n",   \
             __FILE__, __LINE__, #cond, (int)blockIdx.x,                 \
             (int)threadIdx.x);                                          \
      __trap();                                                          \
    }                                                                    \
  } while (0)
#else
#define BR_CHECK(cond) ((void)0)
#endif

#define BR_BIG (1 << 30)
#define BR_SLOTS 8
#define BR_MAX_R 1024

// per-site cap reason codes (aux layout of the JAX pass)
#define BR_CAP_OVERFLOW 1
#define BR_CAP_ATTEMPT 2
#define BR_CAP_ROUNDS 4

template <class T = uint32_t>
__device__ __forceinline__ T br_kmask(int k) {
  return (T(1) << (2 * k)) - T(1);
}

// ((kmer << 2) & mask) ^ code  (reference add_nuc_to_end, mod.rs:110-112)
template <class T>
__device__ __forceinline__ T br_add(T km, uint32_t code, T kmask) {
  return ((km << 2) & kmask) ^ (T)code;
}

// reverse complement: complement every base, then reverse the 2-bit
// groups (a full bit reversal swaps the two bits of each group back).
template <class T>
__device__ __forceinline__ T br_revcomp(T km, int k) {
  if constexpr (sizeof(T) == 8) {
    uint64_t x = km ^ (0xAAAAAAAAAAAAAAAAull & br_kmask<uint64_t>(k));
    x = __brevll(x);
    x = ((x & 0x5555555555555555ull) << 1) |
        ((x >> 1) & 0x5555555555555555ull);
    return x >> (64 - 2 * k);
  } else {
    uint32_t x = km ^ (0xAAAAAAAAu & br_kmask(k));
    x = __brev(x);
    x = ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
    return x >> (32 - 2 * k);
  }
}

template <class T>
__device__ __forceinline__ T br_canonical(T km, int k) {
  int odd;
  if constexpr (sizeof(T) == 8) odd = __popcll(km) & 1;
  else odd = __popc(km) & 1;
  return odd ? br_revcomp(km, k) : km;
}

template <class T>
__device__ __forceinline__ bool br_probe(const uint32_t* __restrict__ table,
                                         T km, int k) {
  const T idx = br_canonical(km, k) >> 1;
  // the table holds 2^(2k-1) bits, at least one word
  BR_CHECK((uint64_t)(idx >> 5) <
           ((1ull << (2 * k - 1)) + 31ull) / 32ull);
  uint32_t w = __ldg(table + (idx >> 5));
  return (w >> ((uint32_t)idx & 31u)) & 1u;
}

// Membership in a sorted table of 2^levels canonical k-mers: the
// branchless binary search of br_tpu's make_hash_probe
// (br_tpu/correct/device_codec.py:160-175), levels dependent loads and
// one more for the equality; unsigned compares, loads through __ldg.
// With 2^levels entries, pos + 2^level never passes the last one, so the
// JAX form's min(cand, n-1) is not needed.
template <class T>
__device__ __forceinline__ bool br_probe_sorted(
    const uint64_t* __restrict__ table, int levels, T km, int k) {
  const uint64_t cano = (uint64_t)br_canonical(km, k);
  uint32_t pos = 0;
  for (int l = levels - 1; l >= 0; --l) {
    const uint32_t cand = pos | (1u << l);
    BR_CHECK(cand < (1u << levels));
    pos = __ldg(table + cand) <= cano ? cand : pos;
  }
  return __ldg(table + pos) == cano;
}

// The probe policies every k-mer kernel is templated on: probe(km, k)
// is one membership test; many(km, need, k) makes N independent tests
// (those with need[u] false are not loaded and read false) and returns
// them as a bit mask, their loads interleaved: for the bitfield one load
// each, all issued before any is used; for the sorted table the N
// searches step level by level together.  kMaxK is the largest k the
// policy takes in a register of type T, which sizes the code windows and
// the greedy DP.
struct BrBitProbe {
  const uint32_t* __restrict__ words;
  template <class T>
  static constexpr int kMaxK = sizeof(T) == 8 ? 17 : 15;

  template <class T>
  __device__ __forceinline__ bool operator()(T km, int k) const {
    return br_probe(words, km, k);
  }
  template <class T, int N>
  __device__ __forceinline__ uint32_t many(const T (&km)[N],
                                           const bool (&need)[N],
                                           int k) const {
    uint32_t word[N], bit[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {  // issue the loads
      const T bi = br_canonical(km[u], k) >> 1;  // br_probe's bit
      BR_CHECK((uint64_t)(bi >> 5) <
               ((1ull << (2 * k - 1)) + 31ull) / 32ull);
      word[u] = need[u] ? __ldg(words + (bi >> 5)) : 0u;
      bit[u] = (uint32_t)bi & 31u;
    }
    uint32_t m = 0;
#pragma unroll
    for (int u = 0; u < N; ++u) m |= ((word[u] >> bit[u]) & 1u) << u;
    return m;
  }
};

struct BrSortedProbe {
  const uint64_t* __restrict__ table;
  int levels;
  template <class T>
  static constexpr int kMaxK = 31;

  template <class T>
  __device__ __forceinline__ bool operator()(T km, int k) const {
    return br_probe_sorted(table, levels, km, k);
  }
  template <class T, int N>
  __device__ __forceinline__ uint32_t many(const T (&km)[N],
                                           const bool (&need)[N],
                                           int k) const {
    uint64_t cano[N];
    uint32_t pos[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      cano[u] = (uint64_t)br_canonical(km[u], k);
      pos[u] = 0;
    }
    for (int l = levels - 1; l >= 0; --l) {
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const uint32_t cand = pos[u] | (1u << l);
        if (need[u] && __ldg(table + cand) <= cano[u]) pos[u] = cand;
      }
    }
    uint32_t m = 0;
#pragma unroll
    for (int u = 0; u < N; ++u)
      m |= (uint32_t)(need[u] && __ldg(table + pos[u]) == cano[u]) << u;
    return m;
  }
};

// last r in [0, n) with a[r] <= x, or -1 (a sorted ascending)
__device__ __forceinline__ int br_slot_of(const int32_t* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

#define BR_FULL 0xffffffffu

// first i in [0, n) with a[i] >= x, or n: a 32-way search by one warp
// (every lane calls it with the same arguments and gets the answer)
__device__ __forceinline__ int br_warp_lower_bound(
    const int32_t* __restrict__ a, int n, int x, int lane) {
  int lo = 0, hi = n;  // the answer is in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + lane * step;
    const bool less = i < hi && a[i] < x;
    const int c = __popc(__ballot_sync(BR_FULL, less));
    if (c == 0) {
      hi = lo;
    } else {
      const int last = lo + (c - 1) * step;
      hi = min(hi, lo + c * step);
      lo = last + 1;
    }
  }
  return lo;
}

// the entry points' error text (ctypes side)
extern "C" const char* br_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
