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
// Two kernels, each with an entry point:
// K8a solid_count: u32 counts over one partition [pbase, pbase+psize) of
//   the canonical half-space.  A thread takes 16 consecutive positions of
//   the flat buffer of reads (the reads' 2-bit codes back to back, 16 a
//   32-bit word, LSB first): its word and the previous one (the k-1 <= 16
//   halo codes), the read of its first position by a binary search of the
//   read starts, then per position the rolled k-mer, its canonical form
//   and one atomicAdd where it is valid and falls in the partition.
//   uint32_t registers for k <= 15, uint64_t for k = 17 (the same code,
//   br_solid_count and br_solid_count64).
// K8b solid_pack: bits = min(count, 255) > a, 32 a word: a warp reads 128
//   counts as one 16-byte load a lane, four ballots give four words
//   (count 4L+j of lane L is bit 4(L%8)+j of word L/8), lanes 0-3 write
//   them; with `clear` the counts are zeroed behind the read, so the
//   next partition needs no fill.  A warp issues the loads of K8_UNROLL
//   groups before it uses the first (one 512-byte load a warp in flight
//   ran at a fifth of the memory rate).
//
// Bound on the H100: bytes.  K8a reads 1/4 byte a position and makes one
// random atomic a valid position (the counts are 2^(2k+1) bytes, 128 MiB
// at k = 13: L2-missing read-modify-writes); K8b reads and clears 4 bytes
// a count and writes 1/8 byte: the half-space is 32 GiB of counts at
// k = 17, swept in partitions under a byte cap (the wrapper's
// max_count_bytes), each partition re-reading the packed reads.  A sort
// (br_tpu's design, made for the TPU's lack of scatter atomics) moves
// the k-mers several times; the atomics move each once.
#include "common.cuh"

#define K8_THREADS 256
#define K8_RUN 16
// groups of 128 counts a warp loads before it uses any (K8b)
#define K8_UNROLL 4

template <class Reg>
__global__ void __launch_bounds__(K8_THREADS) solid_count_kernel(
    const uint32_t* __restrict__ packed, long long n_words,
    const long long* __restrict__ starts, int n_reads, long long n_bases,
    int k, long long pbase, long long psize,
    uint32_t* __restrict__ counts) {
  const long long run = (long long)blockIdx.x * K8_THREADS + threadIdx.x;
  if (run >= n_words) return;
  const long long p0 = run * K8_RUN;
  if (p0 >= n_bases) return;
  const uint32_t cur = __ldg(packed + run);
  const uint32_t prev = run > 0 ? __ldg(packed + run - 1) : 0u;
  const Reg kmask = br_kmask<Reg>(k);
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
      if (local < (unsigned long long)psize) atomicAdd(counts + local, 1u);
    }
  }
}

__global__ void __launch_bounds__(K8_THREADS) solid_pack_kernel(
    uint32_t* __restrict__ counts, long long n_groups, int a,
    uint32_t* __restrict__ words, int clear) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (K8_THREADS / 32);
  const uint32_t lim = a < 0 ? 0u : (uint32_t)a;
  uint4* src = reinterpret_cast<uint4*>(counts);
  for (long long g0 = ((long long)blockIdx.x * (K8_THREADS / 32) +
                       (threadIdx.x >> 5)) * K8_UNROLL;
       g0 < n_groups; g0 += nwarps * K8_UNROLL) {
    uint4 c[K8_UNROLL];
#pragma unroll
    for (int u = 0; u < K8_UNROLL; ++u)  // the loads first, then their use
      c[u] = g0 + u < n_groups ? src[(g0 + u) * 32 + lane]
                               : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < K8_UNROLL; ++u) {
      const long long g = g0 + u;
      if (g >= n_groups) break;  // the same for the whole warp
      if (clear) src[g * 32 + lane] = make_uint4(0u, 0u, 0u, 0u);
      const uint32_t v[4] = {c[u].x, c[u].y, c[u].z, c[u].w};
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool s = a < 0 || min(v[j], 255u) > lim;
        const uint32_t b = __ballot_sync(0xffffffffu, s);
        // lanes 8q .. 8q+7 of ballot j to bits j, j+4, ..., j+28 of
        // word q
        uint32_t x = (b >> (8 * (lane & 3))) & 0xFFu;
        x = (x | (x << 12)) & 0x000F000Fu;
        x = (x | (x << 6)) & 0x03030303u;
        x = (x | (x << 3)) & 0x11111111u;
        word |= x << j;
      }
      if (lane < 4) words[g * 4 + lane] = word;
    }
  }
}

template <class Reg>
static int solid_count_launch(const void* packed, long long n_words,
                              const void* starts, int n_reads,
                              long long n_bases, int k, long long pbase,
                              long long psize, void* counts, void* stream) {
  const long long blocks = (n_words + K8_THREADS - 1) / K8_THREADS;
  if (blocks > 0)
    solid_count_kernel<Reg><<<(unsigned)blocks, K8_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const uint32_t*)packed, n_words, (const long long*)starts, n_reads,
        n_bases, k, pbase, psize, (uint32_t*)counts);
  return (int)cudaGetLastError();
}

extern "C" int br_solid_count(const void* packed, long long n_words,
                              const void* starts, int n_reads,
                              long long n_bases, int k, long long pbase,
                              long long psize, void* counts, void* stream) {
  return solid_count_launch<uint32_t>(packed, n_words, starts, n_reads,
                                      n_bases, k, pbase, psize, counts,
                                      stream);
}

extern "C" int br_solid_count64(const void* packed, long long n_words,
                                const void* starts, int n_reads,
                                long long n_bases, int k, long long pbase,
                                long long psize, void* counts,
                                void* stream) {
  return solid_count_launch<uint64_t>(packed, n_words, starts, n_reads,
                                      n_bases, k, pbase, psize, counts,
                                      stream);
}

// counts: psize = 128 * n_groups u32, 16-byte aligned; words: psize / 32
extern "C" int br_solid_pack(void* counts, long long n_groups, int a,
                             void* words, int clear, void* stream) {
  const long long per_block = K8_UNROLL * (K8_THREADS / 32);
  long long blocks = (n_groups + per_block - 1) / per_block;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride past 16 an SM
  if (blocks > 0)
    solid_pack_kernel<<<(unsigned)blocks, K8_THREADS, 0,
                        (cudaStream_t)stream>>>((uint32_t*)counts, n_groups,
                                                a, (uint32_t*)words, clear);
  return (int)cudaGetLastError();
}
