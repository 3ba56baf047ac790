// K1 dense_probe: the dense stage of a correction pass.
//
// Replaces: scripts/pallas_probe_bench.py::_probe_kernel (the Pallas
// kernel, via probe_chunk_pallas) and the XLA dense stage of
// br_tpu/correct/engine3.py:1387-1448 (read geometry fills, rolling
// k-mers, bitfield probe, V/T masks, cumsum(T), the NS site cap).
//
// Per position p: the read slot r that holds p (rstart staged in shared
// memory), the end-indexed k-mer of codes[p-k+1 .. p] (zero where p is
// fewer than k-1 bases into its slot), its canonical form (popcount
// parity, 2-bit-group reversal) and its solid bit (one 4-byte __ldg of
// the bitfield), then
//   Vraw = probe, V = Vraw & k-1 <= pin < rlen, T = V[p-1] & !V[p] & pin >= k.
// The same launch turns T into the site list: site q < NS is written to
// s_pos[q]; a site of rank >= NS caps its read (cap_read), as
// engine3.py:1444-1448 does; the tile that holds the chunk's end writes
// n_sites and fills s_pos[n_sites:NS] with BIG (no other tile writes
// there).  No host synchronisation.
//
// Bound on the H100: bytes.  It reads the codes (1 B/position) and
// writes k-mers, Vraw, V, T (7 B/position), 8 MB at 2^20; the probes hit
// a bitfield of 2^(2k-6) bytes, 4 MiB at k=13, which stays in the 50 MB
// L2.  The first design gave each of 1024 threads of a tile one position:
// a 9-step slot search, 13 byte loads and 4 scalar stores per position,
// 1024 tiles whose site offsets came from a look-back run by one thread,
// one predecessor (a volatile device-memory load) per step.  Its time
// spread 2x between calls on one chunk (0.060-0.133 ms).
//
// This design gives each of 256 threads a run of K1_RUN = 16 consecutive
// positions (a tile of 4096, 256 tiles at 2^20, about two per SM):
//  * one 16-byte load of the run's codes, its k-1 halo from the previous
//    lane by a shuffle (lane 0 loads it); the k-mer rolls in a register,
//    one shift per position, and the run's 16 probes are issued together
//    (the probe policy's many(): for a sorted table the 16 binary
//    searches step level by level together, 16 loads in flight a step);
//  * one slot search per run, advanced position by position;
//  * k-mers as four int4 stores, Vraw, V, T as one 16-byte store each;
//  * T's predecessor bit from the previous lane's last probe (lane 0
//    probes its own predecessor k-mer, the tile-edge probe);
//  * the site ranks by a thread count, a warp scan and a block scan; the
//    tile's offset by a decoupled look-back that a whole warp runs: 32
//    predecessors' states read at once, a ballot for the nearest one with
//    a PREFIX, a warp sum of the aggregates up to it (as CUB's look-back).
//    Tiles take their index from an atomic ticket, so a tile only ever
//    waits on tiles already running.
// The wrapper keeps one zero fill: the look-back states, the ticket and
// cap_read (a read without a site of rank >= NS is written by no tile).
//
// A launch takes NC chunks of one geometry (a group), chunk blockIdx.y:
// its arrays at a stride of one chunk (codes, k-mers and the masks CHUNK,
// slots and cap_read R, sites NS, one n_sites), its own tile states
// (ntiles a chunk) and its own ticket (one 8-byte word a chunk, after
// all the states).  A tile takes its rank from its chunk's ticket, never
// from block order, so it waits only on tiles of its chunk already
// running, in whatever order the chunks' blocks are scheduled.  NC = 1 is
// the one-chunk layout: states, ticket, cap_read.
//
// Three instantiations from one source: br_dense_probe (uint32_t k-mers
// written as int32, a bitfield at k <= 15), br_dense_probe64 (uint64_t,
// int64, a bitfield at k = 17) and br_dense_probe_h (uint64_t, int64, the
// sorted table of a HashSet at any k <= 31: its probe is a search inside
// the k-mer's bucket, br_probe_sorted, the 16 of a run stepping
// together), the same code.  With 64-bit registers a run's k-1 <=
// 30 halo codes are the previous two lanes' runs (the second by a shuffle
// of two, lanes 0 and 1 load it), and lane 0's tile-edge k-mer (ending at
// p0-1) rolls over both; the k-mers are stored as eight 16-byte stores a
// thread (16 B a position, 25 MB at 2^20).
#include "common.cuh"

#define K1_THREADS 256
#define K1_RUN 16
#define K1_TILE (K1_THREADS * K1_RUN)
#define K1_WARPS (K1_THREADS / 32)
#define FLAG_AGG (1ull << 62)
#define FLAG_PREFIX (1ull << 63)
#define FULL_MASK 0xffffffffu

// the 16 codes of positions [p, p+16) as four little-endian words; bytes
// outside the chunk read as 0
__device__ __forceinline__ void k1_load_run(const uint8_t* __restrict__ codes,
                                            int p, int CHUNK, bool vec,
                                            uint32_t w[4]) {
  if (vec && p >= 0 && p + K1_RUN <= CHUNK) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes + p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < K1_RUN; ++i)
    if (p + i >= 0 && p + i < CHUNK)
      w[i >> 2] |= (uint32_t)codes[p + i] << (8 * (i & 3));
}

__device__ __forceinline__ uint32_t k1_code(const uint32_t w[4], int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 3u;
}

// bits [0, 16) of m as 16 bytes of 0/1
__device__ __forceinline__ uint4 k1_bytes(uint32_t m) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t b = (m >> (4 * j)) & 0xfu;
    w[j] = (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <class Reg, class P>
__global__ void __launch_bounds__(K1_THREADS) dense_probe_kernel(
    const uint8_t* __restrict__ codes, P probe,
    const int32_t* __restrict__ rstart, const int32_t* __restrict__ rlen,
    int CHUNK, int R, int k, int NS,
    void* __restrict__ kmers_out, uint8_t* __restrict__ vraw,
    uint8_t* __restrict__ V, uint8_t* __restrict__ T,
    int32_t* __restrict__ s_pos, uint8_t* __restrict__ cap_read,
    int32_t* __restrict__ n_sites,
    unsigned long long* __restrict__ tile_state,
    unsigned long long* __restrict__ tickets) {
  __shared__ int32_t sh_start[BR_MAX_R];
  __shared__ int32_t sh_len[BR_MAX_R];
  __shared__ int sh_warp[K1_WARPS];
  __shared__ int sh_tile, sh_total, sh_excl;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (CHUNK + K1_TILE - 1) / K1_TILE;
  {  // this block's chunk
    const size_t y = blockIdx.y;
    codes += y * CHUNK;
    rstart += y * R;
    rlen += y * R;
    kmers_out = static_cast<char*>(kmers_out) + y * CHUNK * sizeof(Reg);
    vraw += y * CHUNK;
    V += y * CHUNK;
    T += y * CHUNK;
    s_pos += y * NS;
    cap_read += y * R;
    n_sites += y;
    tile_state += y * ntiles;
    tickets += y;
  }
  if (tid == 0)
    sh_tile = (int)atomicAdd(reinterpret_cast<unsigned int*>(tickets), 1u);
  for (int r = tid; r < R; r += K1_THREADS) {
    sh_start[r] = rstart[r];
    sh_len[r] = rlen[r];
  }
  __syncthreads();
  const int tile = sh_tile;
  const int p0 = tile * K1_TILE + tid * K1_RUN;
  const Reg kmask = br_kmask<Reg>(k);
  const bool vec = (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;

  // the run's codes and the 16 before it (the previous lane's run)
  uint32_t cur[4], prev[4];
  k1_load_run(codes, p0, CHUNK, vec, cur);
#pragma unroll
  for (int i = 0; i < 4; ++i) prev[i] = __shfl_up_sync(FULL_MASK, cur[i], 1);
  if (lane == 0) k1_load_run(codes, p0 - K1_RUN, CHUNK, vec, prev);

  // rolling k-mers: the predecessor's, then one per position; all probes
  // issued together
  Reg km = 0;
  if constexpr (sizeof(Reg) == 8) {  // k - 1 > 16: the 16 codes before
    uint32_t prev2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      prev2[i] = __shfl_up_sync(FULL_MASK, cur[i], 2);
    if (lane < 2) k1_load_run(codes, p0 - 2 * K1_RUN, CHUNK, vec, prev2);
#pragma unroll
    for (int i = 0; i < K1_RUN; ++i)
      km = ((km << 2) | k1_code(prev2, i)) & kmask;
  }
#pragma unroll
  for (int i = 0; i < K1_RUN; ++i) km = ((km << 2) | k1_code(prev, i)) & kmask;
  const Reg km_prev = km;
  Reg kms[K1_RUN];
#pragma unroll
  for (int i = 0; i < K1_RUN; ++i) {
    km = ((km << 2) | k1_code(cur, i)) & kmask;
    kms[i] = km;
  }
  bool all[K1_RUN];
#pragma unroll
  for (int i = 0; i < K1_RUN; ++i) all[i] = true;
  const uint32_t hit = probe.many(kms, all, k);
  // solid bit of the k-mer ending at p0-1 (meaningful where T needs it:
  // pin >= k, so p0-1 is in the same slot and at least k-1 bases in)
  uint32_t hprev = __shfl_up_sync(FULL_MASK, hit >> (K1_RUN - 1), 1) & 1u;
  if (lane == 0) hprev = probe(km_prev, k);

  // read geometry, masks
  const int rid0 = p0 < CHUNK ? br_slot_of(sh_start, R, p0) : -1;
  int rid = rid0;
  uint32_t fullm = 0, vm = 0, tm = 0;
#pragma unroll
  for (int i = 0; i < K1_RUN; ++i) {
    const int p = p0 + i;
    while (rid + 1 < R && sh_start[rid + 1] <= p) ++rid;
    const int pin = p - (rid >= 0 ? sh_start[rid] : 0);
    const int len = rid >= 0 ? sh_len[rid] : 0;
    const bool inc = p < CHUNK;
    const bool h = (hit >> i) & 1u;
    const bool hp = i ? ((hit >> (i - 1)) & 1u) : hprev;
    fullm |= (uint32_t)(inc && pin >= k - 1) << i;
    vm |= (uint32_t)(inc && h && pin >= k - 1 && pin < len) << i;
    tm |= (uint32_t)(inc && hp && !h && pin >= k && pin < len) << i;
  }
  const uint32_t vrawm = fullm & hit;

  if (p0 + K1_RUN <= CHUNK) {
    if constexpr (sizeof(Reg) == 8) {
      longlong2* kp =
          reinterpret_cast<longlong2*>(static_cast<int64_t*>(kmers_out) + p0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int b = 2 * j;
        kp[j] = make_longlong2(
            (fullm >> b) & 1u ? (long long)kms[b] : 0,
            (fullm >> (b + 1)) & 1u ? (long long)kms[b + 1] : 0);
      }
    } else {
      int4* kp = reinterpret_cast<int4*>(static_cast<int32_t*>(kmers_out) +
                                         p0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = 4 * j;
        kp[j] = make_int4((fullm >> b) & 1u ? (int)kms[b] : 0,
                          (fullm >> (b + 1)) & 1u ? (int)kms[b + 1] : 0,
                          (fullm >> (b + 2)) & 1u ? (int)kms[b + 2] : 0,
                          (fullm >> (b + 3)) & 1u ? (int)kms[b + 3] : 0);
      }
    }
    *reinterpret_cast<uint4*>(vraw + p0) = k1_bytes(vrawm);
    *reinterpret_cast<uint4*>(V + p0) = k1_bytes(vm);
    *reinterpret_cast<uint4*>(T + p0) = k1_bytes(tm);
  } else {
    for (int i = 0; i < K1_RUN && p0 + i < CHUNK; ++i) {
      const Reg v = (fullm >> i) & 1u ? kms[i] : Reg(0);
      if constexpr (sizeof(Reg) == 8)
        static_cast<int64_t*>(kmers_out)[p0 + i] = (int64_t)v;
      else
        static_cast<int32_t*>(kmers_out)[p0 + i] = (int32_t)v;
      vraw[p0 + i] = (vrawm >> i) & 1u;
      V[p0 + i] = (vm >> i) & 1u;
      T[p0 + i] = (tm >> i) & 1u;
    }
  }

  // rank of the run's first transition inside the tile
  const int cnt = __popc(tm);
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sh_warp[warp] = incl;
  __syncthreads();

  // warp 0: the warps' offsets, the tile's total, then the look-back
  if (warp == 0) {
    const int c = lane < K1_WARPS ? sh_warp[lane] : 0;
    int wincl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, wincl, off);
      if (lane >= off) wincl += y;
    }
    if (lane < K1_WARPS) sh_warp[lane] = wincl - c;
    const int total = __shfl_sync(FULL_MASK, wincl, 31);
    int excl = 0;
    if (tile == 0) {
      if (lane == 0)
        atomicExch(&tile_state[0], FLAG_PREFIX | (unsigned long long)total);
    } else {
      if (lane == 0)
        atomicExch(&tile_state[tile], FLAG_AGG | (unsigned long long)total);
      for (int base = tile - 1;; base -= 32) {
        const int j = base - lane;  // lane 0: the nearest predecessor
        unsigned long long s = FLAG_PREFIX;  // before tile 0: prefix 0
        if (j >= 0) {
          do {
            s = *reinterpret_cast<volatile unsigned long long*>(
                &tile_state[j]);
          } while (s == 0);
        }
        const unsigned pm = __ballot_sync(FULL_MASK, (s & FLAG_PREFIX) != 0);
        int v = (int)(s & 0xffffffffull);
        if (pm && lane > __ffs(pm) - 1) v = 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(FULL_MASK, v, off);
        excl += v;
        if (pm) break;
      }
      if (lane == 0)
        atomicExch(&tile_state[tile],
                   FLAG_PREFIX | (unsigned long long)(excl + total));
    }
    if (lane == 0) {
      sh_excl = excl;
      sh_total = total;
      if (tile == ntiles - 1) n_sites[0] = excl + total;
    }
  }
  __syncthreads();

  // the run's sites
  int q = sh_excl + sh_warp[warp] + incl - cnt;
  if (tm) {
    rid = rid0;
    for (uint32_t m = tm; m; m &= m - 1, ++q) {
      const int p = p0 + __ffs(m) - 1;
      if (q < NS) {
        s_pos[q] = p;
      } else {
        while (rid + 1 < R && sh_start[rid + 1] <= p) ++rid;
        cap_read[rid] = 1;
      }
    }
  }
  // the chunk's last tile: BIG past the listed sites
  if (tile == ntiles - 1) {
    for (int i = min(sh_excl + sh_total, NS) + tid; i < NS; i += K1_THREADS)
      s_pos[i] = BR_BIG;
  }
}

template <class Reg, class P>
static int dense_probe_launch(
    int NC, const void* codes, P probe, const void* rstart,
    const void* rlen, int CHUNK, int R, int k, int NS, void* kmers,
    void* vraw, void* V, void* T, void* s_pos, void* cap_read,
    void* n_sites, void* tile_state, void* tickets, void* stream) {
  const dim3 grid((CHUNK + K1_TILE - 1) / K1_TILE, NC);
  dense_probe_kernel<Reg, P><<<grid, K1_THREADS, 0,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)codes, probe,
      (const int32_t*)rstart, (const int32_t*)rlen, CHUNK, R, k, NS, kmers,
      (uint8_t*)vraw, (uint8_t*)V, (uint8_t*)T, (int32_t*)s_pos,
      (uint8_t*)cap_read, (int32_t*)n_sites,
      (unsigned long long*)tile_state, (unsigned long long*)tickets);
  return (int)cudaGetLastError();
}

#define K1_ARGS                                                           \
  int NC, const void *codes, const void *table, const void *rstart,       \
      const void *rlen, int CHUNK, int R, int k, int NS, void *kmers,     \
      void *vraw, void *V, void *T, void *s_pos, void *cap_read,          \
      void *n_sites, void *tile_state, void *tickets
#define K1_PASS(probe)                                                    \
  NC, codes, probe, rstart, rlen, CHUNK, R, k, NS, kmers, vraw, V, T,     \
      s_pos, cap_read, n_sites, tile_state, tickets, stream

extern "C" int br_dense_probe(K1_ARGS, void* stream) {
  return dense_probe_launch<uint32_t>(
      K1_PASS(BrBitProbe{(const uint32_t*)table}));
}
extern "C" int br_dense_probe64(K1_ARGS, void* stream) {
  return dense_probe_launch<uint64_t>(
      K1_PASS(BrBitProbe{(const uint32_t*)table}));
}
extern "C" int br_dense_probe_h(K1_ARGS, BR_SORTED_PARAMS, void* stream) {
  return dense_probe_launch<uint64_t>(K1_PASS(BR_SORTED_PROBE(table)));
}
