// Shared device helpers of the port's kernels: 2-bit k-mer math in
// uint32 registers (odd k <= 15), the bitfield probe, slot lookups.
//
// Encoding (as in the JAX package): code = (ascii >> 1) & 3, so A=0 C=1
// T=2 G=3 and the complement of a code is code ^ 2; the canonical k-mer
// is whichever of {kmer, revcomp(kmer)} has an even popcount; its solid
// bit is bit (cano >> 1) & 31 of little-endian word (cano >> 1) >> 5.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define BR_BIG (1 << 30)
#define BR_SLOTS 8
#define BR_MAX_R 1024

// per-site cap reason codes (aux layout of the JAX pass)
#define BR_CAP_OVERFLOW 1
#define BR_CAP_ATTEMPT 2
#define BR_CAP_ROUNDS 4

__device__ __forceinline__ uint32_t br_kmask(int k) {
  return (1u << (2 * k)) - 1u;
}

// ((kmer << 2) & mask) ^ code  (reference add_nuc_to_end, mod.rs:110-112)
__device__ __forceinline__ uint32_t br_add(uint32_t km, uint32_t code,
                                           uint32_t kmask) {
  return ((km << 2) & kmask) ^ code;
}

// reverse complement: complement every base, then reverse the 2-bit
// groups (a full bit reversal swaps the two bits of each group back).
__device__ __forceinline__ uint32_t br_revcomp(uint32_t km, int k) {
  uint32_t x = km ^ (0xAAAAAAAAu & br_kmask(k));
  x = __brev(x);
  x = ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
  return x >> (32 - 2 * k);
}

__device__ __forceinline__ uint32_t br_canonical(uint32_t km, int k) {
  return (__popc(km) & 1) ? br_revcomp(km, k) : km;
}

__device__ __forceinline__ bool br_probe(const uint32_t* __restrict__ table,
                                         uint32_t km, int k) {
  uint32_t idx = br_canonical(km, k) >> 1;
  uint32_t w = __ldg(table + (idx >> 5));
  return (w >> (idx & 31u)) & 1u;
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
