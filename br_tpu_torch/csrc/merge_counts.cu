// K10 merge_counts: the saturating counters of several shards merged into
// one.
//
// Replaces: br_tpu/parallel/mesh.py::count_sharded's psum (:70), the sum
// of the shards' local counts (_count_local, :37) that counts_to_u8 (:76)
// then saturates at 255, ROADMAP B10.  The port's shards count with K8a
// into w-bit counters that saturate at cap (csrc/solid_build.cu), so the
// merge is not a sum of integers: counter i of the output is min(sum over
// the shards of their counter i, cap), cap = a + 1 (255 for the host
// Counter's u8 view), and no field may carry into its neighbour.  NCCL and
// gloo reduce whole integers only, hence a kernel.  At w = 1 (cap 1) the
// merge is the OR of the shards' words.
//
// D rows of n int32 words in (row d at in + d n, on the merging device),
// n words out: 32 / w counters of w bits a word, LSB first (K8's layout).
//
// A thread takes 4 consecutive words (one 16-byte load a row, one 16-byte
// store) where n is a multiple of 4 and the rows are 16-byte aligned, one
// word otherwise (4-byte accesses).  Per word and row, SWAR: the counters
// at even and at odd places are spread to 2w-bit slots (x & E, (x >> w) &
// E); the running sum
// of a slot stays <= cap <= 2^w - 1, so one add leaves it below 2^(w+1)
// and inside its slot; the slots above cap are found by adding 2^(2w-1) -
// 1 - cap, which sets a slot's top bit exactly where its sum passed cap,
// and are set to cap (the flags spread to whole slots by one multiply).
//
// Bound on the H100: bytes.  The function reads the D rows once and
// writes one: (D + 1) n 4 bytes, 40 MiB at k = 13 (a = 2, 2-bit counters,
// 8 MiB a row) and D = 4, ~0.0125 ms at 3.35 TB/s.  The SWAR costs ~20
// integer operations a row and word, 4 a byte moved, below the card's
// integer rate at that bandwidth.
#include "common.cuh"

#define K10_THREADS 256

// one row's word x added to a word's running sums: ev and od hold the
// counters at even and at odd places in 2w-bit slots, each at most cap
template <int W>
__device__ __forceinline__ void k10_add(uint32_t& ev, uint32_t& od,
                                        uint32_t x, uint32_t cap) {
  // E: the even places' slots (2w bits each, their low w bits)
  constexpr uint32_t E = W == 1   ? 0x55555555u
                         : W == 2 ? 0x33333333u
                         : W == 4 ? 0x0F0F0F0Fu
                                  : 0x00FF00FFu;
  // ONE: a 1 at the bottom of each slot
  constexpr uint32_t ONE = W == 1   ? 0x55555555u
                           : W == 2 ? 0x11111111u
                           : W == 4 ? 0x01010101u
                                    : 0x00010001u;
  constexpr uint32_t SLOT = (1u << (2 * W)) - 1u;
  const uint32_t cap_r = cap * ONE;
  const uint32_t bias_r = ((1u << (2 * W - 1)) - 1u - cap) * ONE;
  ev += x & E;
  od += (x >> W) & E;
  const uint32_t fe = (((ev + bias_r) >> (2 * W - 1)) & ONE) * SLOT;
  const uint32_t fo = (((od + bias_r) >> (2 * W - 1)) & ONE) * SLOT;
  ev = (ev & ~fe) | (cap_r & fe);
  od = (od & ~fo) | (cap_r & fo);
}

template <int W>
__global__ void __launch_bounds__(K10_THREADS) merge_counts_kernel(
    const uint32_t* __restrict__ in, int d, long long n, uint32_t cap,
    uint32_t* __restrict__ out, int vec) {
  const long long t = (long long)blockIdx.x * K10_THREADS + threadIdx.x;
  if (vec) {
    const long long i = 4 * t;
    if (i >= n) return;
    uint32_t ev[4] = {0, 0, 0, 0}, od[4] = {0, 0, 0, 0};
    for (int r = 0; r < d; ++r) {
      const uint4 x =
          __ldcs(reinterpret_cast<const uint4*>(in + (long long)r * n + i));
      k10_add<W>(ev[0], od[0], x.x, cap);
      k10_add<W>(ev[1], od[1], x.y, cap);
      k10_add<W>(ev[2], od[2], x.z, cap);
      k10_add<W>(ev[3], od[3], x.w, cap);
    }
    *reinterpret_cast<uint4*>(out + i) =
        make_uint4(ev[0] | (od[0] << W), ev[1] | (od[1] << W),
                   ev[2] | (od[2] << W), ev[3] | (od[3] << W));
    return;
  }
  if (t >= n) return;
  uint32_t ev = 0, od = 0;
  for (int r = 0; r < d; ++r)
    k10_add<W>(ev, od, __ldcs(in + (long long)r * n + t), cap);
  out[t] = ev | (od << W);
}

// in: d rows of n words; out: n words apart from them;
// w = 1, 2, 4, 8 and 1 <= cap <= 2^w - 1
extern "C" int br_merge_counts(const void* in, int d, long long n, int w,
                               int cap, void* out, void* stream) {
  if ((w != 1 && w != 2 && w != 4 && w != 8) || d < 1 || cap < 1 ||
      cap > (1 << w) - 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int vec = n % 4 == 0 && (uintptr_t)in % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  const long long items = vec ? n / 4 : n;
  const long long blocks = (items + K10_THREADS - 1) / K10_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* i32 = (const uint32_t*)in;
  uint32_t* o32 = (uint32_t*)out;
  switch (w) {
    case 1:
      merge_counts_kernel<1><<<(unsigned)blocks, K10_THREADS, 0, s>>>(
          i32, d, n, (uint32_t)cap, o32, vec);
      break;
    case 2:
      merge_counts_kernel<2><<<(unsigned)blocks, K10_THREADS, 0, s>>>(
          i32, d, n, (uint32_t)cap, o32, vec);
      break;
    case 4:
      merge_counts_kernel<4><<<(unsigned)blocks, K10_THREADS, 0, s>>>(
          i32, d, n, (uint32_t)cap, o32, vec);
      break;
    default:
      merge_counts_kernel<8><<<(unsigned)blocks, K10_THREADS, 0, s>>>(
          i32, d, n, (uint32_t)cap, o32, vec);
      break;
  }
  return (int)cudaGetLastError();
}
