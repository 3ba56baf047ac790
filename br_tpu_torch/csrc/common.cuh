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
// table holds the canonical k-mers as uint64, ascending, padded to a
// power of two entries with a sentinel above every k-mer (1 << min(2k+1,
// 63), br_tpu/set/hash.py:108); beside it its bucket index, 2^b + 1
// uint32 offsets: bucket i (the real entries whose top b bits of 2k are
// i) is [starts[i], starts[i+1]) (device_codec.SortedTable).
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

// Membership of N canonical k-mers in a sorted table, by its bucket
// index: the plain version is device_codec.make_hash_probe, and the
// answer is br_tpu's make_hash_probe's (br_tpu/correct/device_codec.py:
// 160-175, a branchless binary search of the whole table, levels + 1
// dependent loads: 22 at 2^21 entries, each a 32-byte sector for 8
// bytes).  Here a probe is one index load, its bucket's two offsets (one
// 8-byte load where the pair is aligned), then bucket_levels fixed steps
// from pos = lo - 1 (uint32 wrap-around; cand >= lo always): cand = pos
// + 2^l moves pos where cand < hi and table[cand] <= cano, and the key is
// found where a taken entry equals it.  Steps past the bucket load
// nothing, so a bucket of s entries costs at most bit_length(s) loads,
// inside one or two sectors.  The N index loads are issued first, then
// the N searches step together.  A key past 2k bits (its bucket 2^b or
// more; bit 63 set at k = 31) reads false and never indexes starts;
// entries of later buckets and the sentinels are above every key of a
// bucket, so the unsigned compares never leave it.  Those with need[u]
// false load nothing and read false; the result is a bit mask.
template <class T, int N>
__device__ __forceinline__ uint32_t br_probe_sorted(
    const uint64_t* __restrict__ table, const uint32_t* __restrict__ starts,
    uint32_t n, int shift, int bucket_levels, const T (&km)[N],
    const bool (&need)[N], int k) {
  uint64_t cano[N];
  uint32_t pos[N], hi[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {  // the index loads
    cano[u] = (uint64_t)br_canonical(km[u], k);
    uint32_t lo = 0, h = 0;
    if (need[u] && cano[u] <= br_kmask<uint64_t>(k)) {
      const uint64_t b = cano[u] >> shift;
      BR_CHECK(b < (1ull << (2 * k - shift)));
      if (b & 1) {
        lo = __ldg(starts + b);
        h = __ldg(starts + b + 1);
      } else {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(starts + b));
        lo = q.x;
        h = q.y;
      }
      BR_CHECK(lo <= h && h <= n);
    }
    pos[u] = lo - 1u;
    hi[u] = h;
  }
  uint32_t m = 0;
  for (int l = bucket_levels - 1; l >= 0; --l) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const uint32_t cand = pos[u] + (1u << l);
      if (cand < hi[u]) {
        BR_CHECK(cand < n);
        const uint64_t x = __ldg(table + cand);
        if (x <= cano[u]) {
          pos[u] = cand;
          m |= (uint32_t)(x == cano[u]) << u;
        }
      }
    }
  }
  return m;
}

// The probe policies every k-mer kernel is templated on: probe(km, k)
// is one membership test; many(km, need, k) makes N independent tests
// (those with need[u] false are not loaded and read false) and returns
// them as a bit mask, their loads interleaved: for the bitfield one load
// each, all issued before any is used; for the sorted table the N index
// loads, then the N bucket searches stepping together.  kMaxK is the
// largest k the policy takes in a register of type T, which sizes the
// code windows and the greedy DP.
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

// table: n uint64 entries; starts: its 2^(2k - shift) + 1 bucket offsets
// (8-byte aligned); bucket_levels: the bit length of its largest bucket.
struct BrSortedProbe {
  const uint64_t* __restrict__ table;
  const uint32_t* __restrict__ starts;
  uint32_t n;
  int shift;
  int bucket_levels;
  template <class T>
  static constexpr int kMaxK = 31;

  template <class T>
  __device__ __forceinline__ bool operator()(T km, int k) const {
    const T one[1] = {km};
    const bool all[1] = {true};
    return br_probe_sorted(table, starts, n, shift, bucket_levels, one,
                           all, k);
  }
  template <class T, int N>
  __device__ __forceinline__ uint32_t many(const T (&km)[N],
                                           const bool (&need)[N],
                                           int k) const {
    return br_probe_sorted(table, starts, n, shift, bucket_levels, km,
                           need, k);
  }
};

// A sorted-table entry point's trailing parameters before the stream
// (kernels.SORTED_ARGS), and the probe they make with its table.
#define BR_SORTED_PARAMS \
  const void *starts, int n, int shift, int bucket_levels
#define BR_SORTED_PROBE(table)                                           \
  (BrSortedProbe{(const uint64_t*)(table), (const uint32_t*)starts,      \
                 (uint32_t)n, shift, bucket_levels})

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
