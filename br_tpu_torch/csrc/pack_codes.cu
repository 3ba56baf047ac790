// K11 pack_codes: a chunk's 2-bit codes unpacked at the chain's entry and
// packed at its exit.
//
// Replaces: br_tpu/correct/engine3.py::make_unpack3_fn (:1951) and
// make_pack3_fn (:1961), the XLA programs around every chunk's chain
// (ROADMAP B7).  The host ships a chunk as 4 codes a byte, LSB first
// (CHUNK / 4 bytes), and fetches it back the same way.
// K11a unpack_codes: n packed bytes -> 4 n codes, one a byte (byte b's
//   code j = (b >> 2j) & 3).
// K11b pack_codes: 4 n codes -> n packed bytes, each code's bits above
//   its 2-bit code stripped (make_pack3_fn's `codes & 3`: a chain's codes
//   carry nothing else, but a byte past 3 must not reach its neighbour).
//
// A thread takes 4 packed bytes and their 16 codes: one 4-byte and one
// 16-byte access where n is a multiple of 4 and both buffers are aligned
// (the engine's chunks are), the bytes one by one otherwise.  The codes of
// one byte are spread to four bytes, and gathered back, by shifts of 6,
// 12 and 18 under the mask 0x03030303 (SWAR, no loop over codes).
//
// Bound on the H100: bytes.  n + 4 n bytes moved, 1.3 MB at CHUNK = 2^20:
// ~0.0004 ms at 3.35 TB/s, below a launch; the kernels are there so that
// the chain's entry and exit are one launch each and run on the device.
// The engine launches each once for a group of NC chunks, on its NC *
// CHUNK / 4 packed bytes as one flat array (a chunk's packed row is
// CHUNK / 4 bytes, so chunk boundaries need no alignment of their own),
// so the bound grows with NC and the launch stays one; lengths and
// offsets are long long, past 2^31 codes.
#include "common.cuh"

#define K11_THREADS 256

// the 4 codes of packed byte b as 4 bytes
__device__ __forceinline__ uint32_t k11_spread(uint32_t b) {
  return (b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u;
}

// 4 codes (one a byte, any bits above the code) as one packed byte
__device__ __forceinline__ uint32_t k11_gather(uint32_t x) {
  x &= 0x03030303u;
  return (x | (x >> 6) | (x >> 12) | (x >> 18)) & 0xFFu;
}

__global__ void __launch_bounds__(K11_THREADS) unpack_codes_kernel(
    const uint8_t* __restrict__ packed, long long n,
    uint8_t* __restrict__ codes, int vec) {
  const long long i = 4 * ((long long)blockIdx.x * K11_THREADS + threadIdx.x);
  if (i >= n) return;
  if (vec) {
    const uint32_t x = __ldcs(reinterpret_cast<const uint32_t*>(packed + i));
    uint4 o;
    o.x = k11_spread(x & 0xFFu);
    o.y = k11_spread((x >> 8) & 0xFFu);
    o.z = k11_spread((x >> 16) & 0xFFu);
    o.w = k11_spread(x >> 24);
    *reinterpret_cast<uint4*>(codes + 4 * i) = o;
    return;
  }
  for (long long j = i; j < n && j < i + 4; ++j) {
    const uint32_t c = k11_spread(packed[j]);
    for (int q = 0; q < 4; ++q) codes[4 * j + q] = (uint8_t)(c >> (8 * q));
  }
}

__global__ void __launch_bounds__(K11_THREADS) pack_codes_kernel(
    const uint8_t* __restrict__ codes, long long n,
    uint8_t* __restrict__ packed, int vec) {
  const long long i = 4 * ((long long)blockIdx.x * K11_THREADS + threadIdx.x);
  if (i >= n) return;
  if (vec) {
    const uint4 x = __ldcs(reinterpret_cast<const uint4*>(codes + 4 * i));
    *reinterpret_cast<uint32_t*>(packed + i) =
        k11_gather(x.x) | (k11_gather(x.y) << 8) | (k11_gather(x.z) << 16) |
        (k11_gather(x.w) << 24);
    return;
  }
  for (long long j = i; j < n && j < i + 4; ++j) {
    uint32_t x = 0;
    for (int q = 0; q < 4; ++q) x |= (uint32_t)codes[4 * j + q] << (8 * q);
    packed[j] = (uint8_t)k11_gather(x);
  }
}

static long long k11_blocks(long long n) {
  return ((n + 3) / 4 + K11_THREADS - 1) / K11_THREADS;
}

// packed: n bytes; codes: 4 n bytes
extern "C" int br_unpack_codes(const void* packed, long long n, void* codes,
                               void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int vec = n % 4 == 0 && (uintptr_t)packed % 4 == 0 &&
                  (uintptr_t)codes % 16 == 0;
  unpack_codes_kernel<<<(unsigned)k11_blocks(n), K11_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)packed, n, (uint8_t*)codes, vec);
  return (int)cudaGetLastError();
}

// codes: 4 n bytes; packed: n bytes
extern "C" int br_pack_codes(const void* codes, long long n, void* packed,
                             void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int vec = n % 4 == 0 && (uintptr_t)codes % 16 == 0 &&
                  (uintptr_t)packed % 4 == 0;
  pack_codes_kernel<<<(unsigned)k11_blocks(n), K11_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n, (uint8_t*)packed, vec);
  return (int)cudaGetLastError();
}
