// K8 solid_build: the solid set counted, thresholded and packed on the
// device; the bitfield never crosses the bus.
//
// Replaces: br_tpu/set/device_build.py::_solid_words_by_sort (:109),
// driven by build_solid_words_on_device (:158) over the reads packed by
// _pack_reads (:39): every canonical k-mer of the valid positions (pin >=
// k-1 inside its read), counted, kept where its count is above the
// abundance a, one bit each in the 2^(2k-1)-bit field.  The count is
// taken as the host Counter takes it, saturated at 255 (u8), so a >= 255
// gives an empty set; br_tpu's exact-count build differs there
// (device_build.py:14-17) and is not copied.
//
// The function is min(count, 255) > a, and for 0 <= a <= 254 that reads
// only min(count, a + 1): a k-mer's counter is w bits wide and saturates
// at s = a + 1, w the narrowest of 1, 2, 4, 8 with 2^w - 1 >= s (1 bit at
// a = 0, 2 at a = 1, 2; 4 at 3..14; 8 at 15..254), 32 / w counters a
// 32-bit word, counter i at bits [w (i % (32/w)), +w) of word i / (32/w).
// a < 0 (every bit) and a >= 255 (no bit) count nothing; the wrapper
// launches neither kernel there.
//
// Two kernels, each with an entry point:
// K8a solid_count: w-bit counters over one partition [pbase, pbase+psize)
//   of the canonical half-space.  A thread takes 16 consecutive
//   positions of the flat buffer of reads (the reads' 2-bit codes back
//   to back, 16 a 32-bit word, LSB first): its word and the previous one
//   (the k-1 <= 16 halo codes), the read of its first position by a
//   binary search of the read starts, then per position the rolled
//   k-mer, its canonical form and, where it is valid and falls in the
//   partition, one saturating update: a load from L2 (__ldcg), and only
//   where the counter is below s an atomicCAS loop on its word that
//   stops once the counter reaches s (at w = 1, an atomicOr of the bit).
//   uint32_t registers for k <= 15, uint64_t for k = 17 (the same code,
//   br_solid_count and br_solid_count64).
// K8b solid_pack (w = 2, 4, 8; at w = 1 the counters are the bitfield
//   and nothing is packed): bit i = (counter i >= s), 32 a word: a
//   thread makes one output word from w counter words (one 8- or
//   16-byte load, two at w = 8): per word, the counters at even and at
//   odd places are spread to 2w-bit slots and s subtracted by adding
//   2^w - s, so the carry out of a slot is the flag; the flags, w apart,
//   are gathered to 32 / w contiguous bits by shifts and masks.  With
//   `clear` the counters are zeroed behind the read for the next
//   partition.  A block takes 256 x K8_UNROLL consecutive output words
//   and issues all their loads before it uses the first.
//
// Why a load and a CAS loop (and not bit-planes or an atomicAdd): a
// field of w bits cannot take an unchecked atomicAdd (two adds at s - 1
// overflow it into its neighbour), and atomicCAS is the one atomic that
// stops at s.  Counters only grow inside the kernel, so the plain load
// can only under-read: a counter it reads as s is saturated and the
// atomic is skipped, which is every occurrence past the s-th (most of a
// 12x-covered corpus: the repeat k-mers and every read's true ones).  A
// failed CAS hands back the word's newer value, and a word takes at most
// 32/w x s successful updates, so the loop ends; one k-mer repeated 10^5
// times costs s CAS rounds, then loads.  a + 1 bit-planes updated by
// chained atomicOr would need no K8b, but touch up to a + 1 lines an
// occurrence and, at a = 2, 3 bits a k-mer in place of 2.
//
// Bound on the H100: bytes.  The function reads the packed reads (1/4
// byte a base) and the read starts once and writes the bitfield (1/8
// byte a k-mer of the half-space) once: 4 MiB at k = 13, 1 GiB at k = 17.
// The counters are the intermediate: 2^(2k-1) w / 8 bytes, 8 MiB at k =
// 13 and a = 2 (inside the 50 MB L2: every K8a update an L2 hit) and 2
// GiB at k = 17 (one partition under the 4 GiB default cap, where the
// u32 counts took 32 GiB in 8); zeroed once, read once by K8b.
#include "common.cuh"

#define K8_THREADS 256
#define K8_RUN 16
// output words a K8b thread has in flight
#define K8_UNROLL 4

template <class Reg>
__global__ void __launch_bounds__(K8_THREADS) solid_count_kernel(
    const uint32_t* __restrict__ packed, long long n_words,
    const long long* __restrict__ starts, int n_reads, long long n_bases,
    int k, long long pbase, long long psize, int w, uint32_t sat,
    uint32_t* __restrict__ counts) {
  const long long run = (long long)blockIdx.x * K8_THREADS + threadIdx.x;
  if (run >= n_words) return;
  const long long p0 = run * K8_RUN;
  if (p0 >= n_bases) return;
  const uint32_t cur = __ldg(packed + run);
  const uint32_t prev = run > 0 ? __ldg(packed + run - 1) : 0u;
  const Reg kmask = br_kmask<Reg>(k);
  const uint32_t fmask = (1u << w) - 1u;
  // the read of p0: the last start <= p0
  int lo = 0, hi = n_reads;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(starts + mid) <= p0) lo = mid + 1; else hi = mid;
  }
  int rid = lo - 1;
  long long next = rid + 1 < n_reads ? __ldg(starts + rid + 1) : n_bases;
  long long start = __ldg(starts + rid);
  Reg km = 0;
#pragma unroll
  for (int i = 0; i < K8_RUN; ++i) km = (km << 2) | ((prev >> (2 * i)) & 3u);
#pragma unroll
  for (int i = 0; i < K8_RUN; ++i) {
    const long long p = p0 + i;
    km = ((km << 2) | ((cur >> (2 * i)) & 3u)) & kmask;
    while (rid + 1 < n_reads && p >= next) {  // reads are back to back
      start = next;
      ++rid;
      next = rid + 1 < n_reads ? __ldg(starts + rid + 1) : n_bases;
    }
    if (p < n_bases && p - start >= k - 1) {
      const unsigned long long idx =
          (unsigned long long)(br_canonical(km, k) >> 1);
      const unsigned long long local = idx - (unsigned long long)pbase;
      if (local >= (unsigned long long)psize) continue;
      const unsigned long long bit = local * (unsigned)w;
      BR_CHECK(bit < (unsigned long long)psize * (unsigned)w);
      uint32_t* word = counts + (bit >> 5);
      const unsigned sh = (unsigned)(bit & 31);
      uint32_t old = __ldcg(word);
      if (w == 1) {
        if (!((old >> sh) & 1u)) atomicOr(word, 1u << sh);
        continue;
      }
      while (((old >> sh) & fmask) < sat) {
        const uint32_t seen = atomicCAS(word, old, old + (1u << sh));
        if (seen == old) break;
        old = seen;
      }
    }
  }
}

// the flag (counter >= sat) of each w-bit counter of x, at the counter's
// lowest bit
template <int W>
__device__ __forceinline__ uint32_t k8_flags(uint32_t x, uint32_t sat) {
  // the even counters, and the odd ones shifted down, each alone in a
  // 2W-bit slot: counter + 2^W - sat carries into the slot's bit W
  // exactly where counter >= sat (the sum stays below 2^(2W))
  constexpr uint32_t even = W == 2 ? 0x33333333u
                            : W == 4 ? 0x0F0F0F0Fu : 0x00FF00FFu;
  constexpr uint32_t low = W == 2 ? 0x11111111u
                           : W == 4 ? 0x01010101u : 0x00010001u;
  const uint32_t add = ((1u << W) - sat) * low;
  const uint32_t fe = (((x & even) + add) >> W) & low;
  const uint32_t fo = ((((x >> W) & even) + add) >> W) & low;
  return fe | (fo << W);
}

// the flags of k8_flags (bits 0, W, 2W, ...) gathered to bits 0 .. 32/W-1
template <int W>
__device__ __forceinline__ uint32_t k8_gather(uint32_t x) {
  if constexpr (W == 2) {
    x &= 0x55555555u;
    x = (x | (x >> 1)) & 0x33333333u;
    x = (x | (x >> 2)) & 0x0F0F0F0Fu;
    x = (x | (x >> 4)) & 0x00FF00FFu;
    return (x | (x >> 8)) & 0x0000FFFFu;
  } else if constexpr (W == 4) {
    x &= 0x11111111u;
    x = (x | (x >> 3)) & 0x03030303u;
    x = (x | (x >> 6)) & 0x000F000Fu;
    return (x | (x >> 12)) & 0x000000FFu;
  } else {
    x &= 0x01010101u;
    x = (x | (x >> 7)) & 0x00030003u;
    return (x | (x >> 14)) & 0x0000000Fu;
  }
}

// the W counter words of output word o: one vector load (two at W = 8)
template <int W>
__device__ __forceinline__ void k8_load(const uint32_t* counts, long long o,
                                        uint32_t (&v)[W]) {
  if constexpr (W == 2) {
    const uint2 x = __ldcs(reinterpret_cast<const uint2*>(counts) + o);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 x =
          __ldcs(reinterpret_cast<const uint4*>(counts) + o * (W / 4) + q);
      v[4 * q] = x.x; v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
    }
  }
}

template <int W>
__device__ __forceinline__ void k8_zero(uint32_t* counts, long long o) {
  if constexpr (W == 2) {
    reinterpret_cast<uint2*>(counts)[o] = make_uint2(0u, 0u);
  } else {
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      reinterpret_cast<uint4*>(counts)[o * (W / 4) + q] =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int W>
__global__ void __launch_bounds__(K8_THREADS) solid_pack_kernel(
    uint32_t* __restrict__ counts, long long n_out, uint32_t sat,
    uint32_t* __restrict__ words, int clear) {
  constexpr int PER = 32 / W;  // output bits of one counter word
  const long long tile = (long long)K8_THREADS * K8_UNROLL;
  for (long long t0 = (long long)blockIdx.x * tile; t0 < n_out;
       t0 += (long long)gridDim.x * tile) {
    uint32_t v[K8_UNROLL][W];
#pragma unroll
    for (int u = 0; u < K8_UNROLL; ++u) {  // the loads first, then their use
      const long long o = t0 + u * K8_THREADS + threadIdx.x;
      if (o < n_out) k8_load<W>(counts, o, v[u]);
    }
#pragma unroll
    for (int u = 0; u < K8_UNROLL; ++u) {
      const long long o = t0 + u * K8_THREADS + threadIdx.x;
      if (o >= n_out) break;
      if (clear) k8_zero<W>(counts, o);
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < W; ++j)
        word |= k8_gather<W>(k8_flags<W>(v[u][j], sat)) << (j * PER);
      words[o] = word;
    }
  }
}

template <class Reg>
static int solid_count_launch(const void* packed, long long n_words,
                              const void* starts, int n_reads,
                              long long n_bases, int k, long long pbase,
                              long long psize, int w, int a, void* counts,
                              void* stream) {
  if ((w != 1 && w != 2 && w != 4 && w != 8) || a < 0 ||
      a + 1 > (1 << w) - 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_words + K8_THREADS - 1) / K8_THREADS;
  if (blocks > 0)
    solid_count_kernel<Reg><<<(unsigned)blocks, K8_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const uint32_t*)packed, n_words, (const long long*)starts, n_reads,
        n_bases, k, pbase, psize, w, (uint32_t)(a + 1), (uint32_t*)counts);
  return (int)cudaGetLastError();
}

// counts: psize w-bit counters (psize w / 32 words), zeroed before the
// partition's first launch; a in [0, 2^w - 2]
extern "C" int br_solid_count(const void* packed, long long n_words,
                              const void* starts, int n_reads,
                              long long n_bases, int k, long long pbase,
                              long long psize, int w, int a, void* counts,
                              void* stream) {
  return solid_count_launch<uint32_t>(packed, n_words, starts, n_reads,
                                      n_bases, k, pbase, psize, w, a,
                                      counts, stream);
}

extern "C" int br_solid_count64(const void* packed, long long n_words,
                                const void* starts, int n_reads,
                                long long n_bases, int k, long long pbase,
                                long long psize, int w, int a, void* counts,
                                void* stream) {
  return solid_count_launch<uint64_t>(packed, n_words, starts, n_reads,
                                      n_bases, k, pbase, psize, w, a,
                                      counts, stream);
}

// counts: n_out * w words, 16-byte aligned; words: n_out; w = 2, 4, 8
extern "C" int br_solid_pack(void* counts, long long n_out, int w, int a,
                             void* words, int clear, void* stream) {
  if (w < 2 || a < 0 || a + 1 > (1 << w) - 1)
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)K8_THREADS * K8_UNROLL;
  long long blocks = (n_out + per_block - 1) / per_block;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride past 16 an SM
  if (blocks <= 0) return (int)cudaGetLastError();
  const uint32_t sat = (uint32_t)(a + 1);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* c = (uint32_t*)counts;
  uint32_t* o = (uint32_t*)words;
  switch (w) {
    case 2:
      solid_pack_kernel<2><<<(unsigned)blocks, K8_THREADS, 0, s>>>(
          c, n_out, sat, o, clear);
      break;
    case 4:
      solid_pack_kernel<4><<<(unsigned)blocks, K8_THREADS, 0, s>>>(
          c, n_out, sat, o, clear);
      break;
    case 8:
      solid_pack_kernel<8><<<(unsigned)blocks, K8_THREADS, 0, s>>>(
          c, n_out, sat, o, clear);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
