// Shared device helpers of the port's kernels: 2-bit k-mer math in a
// register of type T, uint32_t for odd k <= 15 and uint64_t for k = 17
// (every helper is a template on T; the uint32_t instantiations are the
// k <= 15 code), the bitfield probe, slot lookups.
//
// Encoding (as in the JAX package): code = (ascii >> 1) & 3, so A=0 C=1
// T=2 G=3 and the complement of a code is code ^ 2; the canonical k-mer
// is whichever of {kmer, revcomp(kmer)} has an even popcount; its solid
// bit is bit (cano >> 1) & 31 of little-endian word (cano >> 1) >> 5 (at
// k = 17 the bit index reaches 2^33, its word index 2^28).
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
