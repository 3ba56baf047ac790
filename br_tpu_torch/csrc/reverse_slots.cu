// K4 reverse_slots: in-slot reversal of every read between the forward
// and the reverse direction of a correction chain.
//
// Replaces: br_tpu/correct/engine3.py::make_reverse3_fn (:1920), the
// reversal of the length-n prefix of every slot (the reverse pass works
// on plain-reversed bytes, src/lib.rs:110-117).
//
// Position p of slot r (the last slot with rstart[r] <= p; none before
// the first) at offset o = p - rstart[r] takes codes[rstart[r] + n - 1 - o]
// for o < n = rlen[r], else codes[p] (the slack is copied); sources are
// clamped to the chunk.  The code is masked to its two bits, so nothing
// above the base crosses over (the JAX reversal also moves bit 2,
// engine3.py:1944).  rstart is non-decreasing, as every planner lays it
// out (unused slots: rstart = CHUNK, rlen = 0).
//
// Bound on the H100: bytes, one read and one write of the chunk plus the
// slot table, 2 MB at 2^20 (0.63 us at 3.35 TB/s).  The first design ran
// a thread per byte: every block of 256 staged the whole slot table in
// shared memory (4 KB of rstart/rlen loaded by each of 4,096 blocks), and
// every thread ran its own binary search, a 1-byte load and a 1-byte
// store.  This one:
//  * a thread owns 16 consecutive positions and stores them as one
//    16-byte vector; a warp owns 512 positions;
//  * one slot lookup a warp, with no staging of the slot table: the lanes
//    load 32 evenly spaced starts of rstart (R > 32 only), take the last
//    at or below the warp's first position, load the 32 slots from there
//    (start, length, next start), and each thread finds its own slot
//    among them by a 6-step shuffle search: two dependent loads before
//    the data at R = 512, one at R <= 32;
//  * a run inside one slot's read takes its 16 mirrored sources, an
//    unaligned range in general (rlen is arbitrary), from two aligned
//    16-byte loads, a funnel shift and a byte reversal (__byte_perm); a
//    run inside the slack is one aligned 16-byte copy; a run where the
//    read ends takes both and keeps the mirrored bytes up to the end (on
//    the byte path, one such run in a chunk set the kernel's time: its
//    warp's long chain of per-byte arithmetic);
//  * a run that crosses a slot boundary, the chunk's last partial run, a
//    run whose source the clamp reaches, and pointers that are not
//    16-byte aligned take the byte path: each byte's slot (moving forward
//    from the run's first) and source, then the loads;
//  * a thread whose slot lies past the 32 its warp loaded (more than 31
//    slots start in the warp's 512 positions) finds it by its own binary
//    search of rstart.
// A launch takes NC chunks of one geometry (a group), chunk blockIdx.y:
// codes and out at a stride of CHUNK, the slot table at R.
#include "common.cuh"

#define K4_THREADS 128
#define K4_RUN 16                      // positions a thread
#define K4_LO (-2147483647 - 1)        // "no slot before": start below all
#define K4_HI 2147483647               // "no slot after": start above all

// codes[s + 15 - i] for i = 0..15 (s >= -15, s + 15 < CHUNK, CHUNK a
// multiple of 16, codes 16-byte aligned; bytes below 0 read as 0), masked
// to 2 bits: the aligned 16 bytes at or below s and, unless s is aligned,
// the next 16; bytes s..s+15 by a funnel shift; then the words and the
// bytes in each reversed.
__device__ __forceinline__ uint4 k4_mirror16(const uint8_t* __restrict__ codes,
                                             int s) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const uint4* src = reinterpret_cast<const uint4*>(codes) + (s >> 4);
  const uint4 x = s >= 0 ? __ldg(src) : zero;
  const uint4 y = (s & 15) ? __ldg(src + 1) : zero;
  const uint32_t v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  const int q = (s >> 2) & 3, sh = 8 * (s & 3);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // words q+k and q+k+1, by selects
    uint32_t lo = v[k], hi = v[k + 1];
    lo = q == 1 ? v[k + 1] : lo;
    hi = q == 1 ? v[k + 2] : hi;
    lo = q == 2 ? v[k + 2] : lo;
    hi = q == 2 ? v[k + 3] : hi;
    lo = q == 3 ? v[k + 3] : lo;
    hi = q == 3 ? v[k + 4] : hi;
    w[k] = __funnelshift_r(lo, hi, sh);
  }
  return make_uint4(__byte_perm(w[3], 0, 0x0123) & 0x03030303u,
                    __byte_perm(w[2], 0, 0x0123) & 0x03030303u,
                    __byte_perm(w[1], 0, 0x0123) & 0x03030303u,
                    __byte_perm(w[0], 0, 0x0123) & 0x03030303u);
}

// codes[p0 .. p0+15] (p0 16-byte aligned) masked to 2 bits
__device__ __forceinline__ uint4 k4_copy16(const uint8_t* __restrict__ codes,
                                           int p0) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(codes + p0));
  return make_uint4(x.x & 0x03030303u, x.y & 0x03030303u, x.z & 0x03030303u,
                    x.w & 0x03030303u);
}

__global__ void __launch_bounds__(K4_THREADS) reverse_slots_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ rstart,
    const int32_t* __restrict__ rlen, uint8_t* __restrict__ out, int CHUNK,
    int R, int vec) {
  {  // this block's chunk
    const size_t y = blockIdx.y;
    const unsigned chunk = CHUNK, r = R;
    codes += y * chunk;
    out += y * chunk;
    rstart += y * r;
    rlen += y * r;
  }
  const int lane = threadIdx.x & 31;
  const int w0 = (blockIdx.x * K4_THREADS + (threadIdx.x & ~31)) * K4_RUN;
  if (w0 >= CHUNK) return;  // the whole warp
  const int p0 = w0 + lane * K4_RUN;

  // 32 slots from `base`, lane l holding slot base + l (its start, length
  // and the next slot's start): the whole table when R <= 32, else from
  // the last of 32 evenly sampled starts at or below the warp's first
  // position (one round trip of samples, then one of the window)
  int base = 0;
  if (R > 32) {
    const int step = (R + 31) >> 5;
    const bool le = lane * step < R && __ldg(rstart + lane * step) <= w0;
    const int c = __popc(__ballot_sync(BR_FULL, le));
    base = c ? (c - 1) * step : 0;
  }
  const int j = base + lane;
  const int ws = j < R ? __ldg(rstart + j) : K4_HI;
  const int wl = j < R ? __ldg(rlen + j) : 0;
  const int wn = j + 1 < R ? __ldg(rstart + j + 1) : K4_HI;
  // this thread's slot: the last in the window with start <= p0 (a
  // 6-step shuffle search of the window's sorted starts), or none
  int cnt = 0;
#pragma unroll
  for (int st = 32; st; st >>= 1) {
    const int v = __shfl_sync(BR_FULL, ws, min(cnt + st, 32) - 1);
    if (cnt + st <= 32 && v <= p0) cnt += st;
  }
  const int i = max(cnt - 1, 0);
  int r = base + cnt - 1;
  int rs = __shfl_sync(BR_FULL, ws, i);
  int n = __shfl_sync(BR_FULL, wl, i);
  int nx = __shfl_sync(BR_FULL, wn, i);
  if (cnt == 0) {  // before the first slot (base is 0 then)
    nx = rs;
    rs = K4_LO;
    n = 0;
  }
  if (p0 >= CHUNK) return;
  if (nx <= p0) {  // p0's slot lies past the 32 slots its warp loaded
    int lo = 0, hi = R;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(rstart + mid) <= p0) lo = mid + 1; else hi = mid;
    }
    r = lo - 1;
    rs = r < 0 ? K4_LO : __ldg(rstart + r);
    n = r < 0 ? 0 : __ldg(rlen + r);
    nx = r + 1 < R ? __ldg(rstart + r + 1) : K4_HI;
  }

  // a run inside one slot: a copy, a mirrored range, or the read's end
  // (its last bases mirrored from the read's start, then the slack)
  if (vec && p0 + K4_RUN <= CHUNK && nx > p0 + K4_RUN - 1) {
    const long long o0 = r < 0 ? 0 : (long long)p0 - rs;
    if (r < 0 || o0 >= n) {  // before the first slot, or the slack
      *reinterpret_cast<uint4*>(out + p0) = k4_copy16(codes, p0);
      return;
    }
    const long long s = (long long)rs + n - K4_RUN - o0;  // source of p0+15
    if (o0 + K4_RUN - 1 < n) {
      if (s >= 0 && s + K4_RUN - 1 < CHUNK) {
        *reinterpret_cast<uint4*>(out + p0) = k4_mirror16(codes, (int)s);
        return;
      }
    } else if (rs >= 0) {
      // bytes b < e = n - o0 take codes[rs + e - 1 - b], the rest their own
      const int e = (int)(n - o0);
      const uint4 m = k4_mirror16(codes, rs + e - K4_RUN);
      const uint4 cp = k4_copy16(codes, p0);
      uint32_t keep[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = e - 4 * q;  // mirrored bytes in word q
        keep[q] = t >= 4 ? 0xffffffffu : t <= 0 ? 0u : (1u << (8 * t)) - 1u;
      }
      *reinterpret_cast<uint4*>(out + p0) =
          make_uint4((m.x & keep[0]) | (cp.x & ~keep[0]),
                     (m.y & keep[1]) | (cp.y & ~keep[1]),
                     (m.z & keep[2]) | (cp.z & ~keep[2]),
                     (m.w & keep[3]) | (cp.w & ~keep[3]));
      return;
    }
  }

  // byte by byte: each byte's slot (moving forward from p0's) and source,
  // then the loads together
  const uint8_t* src[K4_RUN];
#pragma unroll
  for (int b = 0; b < K4_RUN; ++b) {
    const int g = p0 + b;
    src[b] = codes + min(g, CHUNK - 1);
    if (g >= CHUNK) continue;
    while (g >= nx) {
      ++r;
      rs = nx;
      n = __ldg(rlen + r);
      nx = r + 1 < R ? __ldg(rstart + r + 1) : K4_HI;
    }
    if (r < 0) continue;
    const long long o = (long long)g - rs;
    if (o < n) {
      const long long m = (long long)rs + n - 1 - o;
      src[b] = codes + (int)max(0LL, min(m, (long long)CHUNK - 1));
    }
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < K4_RUN; ++b)
    w[b >> 2] |= ((uint32_t)__ldg(src[b]) & 3u) << (8 * (b & 3));
  if (vec && p0 + K4_RUN <= CHUNK) {
    *reinterpret_cast<uint4*>(out + p0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int b = 0; b < K4_RUN; ++b)
      if (p0 + b < CHUNK)
        out[p0 + b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
  }
}

extern "C" int br_reverse_slots(int NC, const void* codes,
                                const void* rstart, const void* rlen,
                                void* out, int CHUNK, int R, void* stream) {
  const int vec = CHUNK % 16 == 0 &&
                  ((reinterpret_cast<uintptr_t>(codes) |
                    reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const int runs = (CHUNK + K4_RUN - 1) / K4_RUN;
  const int nblocks = (runs + K4_THREADS - 1) / K4_THREADS;
  reverse_slots_kernel<<<dim3(nblocks, NC), K4_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)rstart, (const int32_t*)rlen,
      (uint8_t*)out, CHUNK, R, vec);
  return (int)cudaGetLastError();
}
