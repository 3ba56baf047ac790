// K3 chain_splice: which sites the scan machine visits, and the spliced
// output of every read.
//
// Replaces: the whole-read chain walk of br_tpu/correct/engine3.py:
// 1723-1749 (pointer doubling over the site successors) and the splice
// of :1751-1839 with _compact (:195) and _lower_bound (:183): record
// compaction, per-read output offsets, out_len and cap, the shift fill
// and the combined gather.
//
// A read's visited sites are its head site (the first listed site at or
// after rstart[r], as nt[rstart] at :1734) and its successors while they
// grow and stay below the read's end; their records, in (site, slot)
// order, lay the read out: for record j the verbatim segment
// codes[pe_j, p_j) and then its emitted bases, with pe_0 = rstart and
// pe_j = p_{j-1} + consumed_{j-1}, then the tail codes[pe_last, rend),
// then zeros to the end of the slot.  Emitted base e of a record is bits
// 2*(e%16) of its word e/16 (a walk record's up to walk_max+1 bases in
// EW words splice like a scenario's one word).
// Cap rules as in the JAX pass: any capped site of the read, visited or
// not (:1748-1749); a negative verbatim length (:1770); out_len > rcap or
// a negative tail (:1784-1785); and K1's NS overflow.  Unlike :1822-1827
// nothing is clipped to rstart+rcap-1: a read that fills its slot exactly
// keeps its last emitted base (the fault recorded in ROADMAP C).
// aux gets entries 0 (sites), 1-3 (capped sites by reason), 4 (visited
// sites) and 7 (raw site count); entries 5 and 6 need every read's record
// count (the NR record capacity) and are finished by the pass.
//
// Bound on the H100: bytes, the read bases copied and the chunk written
// once, plus the site tables: about 2.6 MB at 2^20, under a microsecond.
// What sets the time is the read with the longest chain.  The first
// design had thread 0 of each block binary-search s_pos in device memory twice
// and walk the chain, one dependent device-memory load of succ per
// visited site plus its rec_p, rec_c and rec_s, while 255 threads waited;
// then the block searched a segment table in device memory for every
// base of its slot: 0.68-0.74 ms a launch on 2^20 and 2^18 chunks alike.
//
// This design is two kernels, launched one after the other by the entry
// point (the wrapper counts two chain_splice launches a call):
// K3a (splice_walk_kernel), one block per read slot, the whole block:
//  1. warp 0 and warp 1 find the read's site range [lo, hi) by 32-way
//     searches of s_pos (three dependent loads each at NS = 32768);
//  2. the chain only moves forward (succ > x), so the block takes it in
//     windows of K3_W sites that start at the chain's next site: it stages
//     the window's successors into shared memory (coalesced), marks the
//     visited sites there, and moves to the window where the chain goes
//     next, skipping whole windows the chain jumps over; a read may hold
//     up to NS sites;
//  3. visited sites are marked by binary lifting over the window (jump
//     tables of 2^l steps in shared memory, the JAX pass's pointer
//     doubling, :1725-1744): O(log W) block-wide rounds instead of one
//     dependent step per site.  A serial walk over the staged successors
//     by one thread was slower on the card in every run (0.058 against
//     0.035 ms on the smoke corpus's first chunk, PERF.md), and is gone;
//  4. each thread owns K3_SPT consecutive sites and loads their 8 rec_p,
//     rec_c and rec_s as 16-byte vectors; a block-wide "last record end"
//     scan gives every thread its first record's verbatim start, a
//     block-wide sum scan its record index and output offset; the start,
//     the body length and the record count carry from window to window.
//     The read's segment table (output offset, verbatim start and length,
//     record index) goes to the scratch at its own site range, so reads
//     never share scratch, and its body length, last record end, table
//     start and size to rtab.
// K3b (splice_copy_kernel), one thread per 16-byte run of the chunk, all
// SMs: the run's slot from rstart in shared memory; a run of zeros, of
// consecutive codes (inside one verbatim segment or the tail) or of one
// record's emitted bases takes one binary search of the read's segment
// table, one or two 16-byte loads and one 16-byte store; a run that
// crosses from one source to the next finds each byte's source, issues
// its 16 loads together and only then unpacks them.  K3b writes every
// position of the chunk, so the wrapper zero-fills nothing.
// A one-kernel version of this design kept the copy in K3a, 16 bytes a
// thread from a segment table in shared memory: the copy of the longest
// read then ran on one SM with 8 warps and set the kernel's time.
//
// A call takes NC chunks of one geometry (a group): both kernels run
// chunk blockIdx.y, its arrays at a stride of one chunk (codes and out
// CHUNK; slots, cap_dense and the per-read results R, rtab 4 R; sites
// NS, one n_sites; records NS * SLOTS, the segment tables 4 NS * SLOTS,
// emit words NS * SLOTS * EW; eight aux words).
#include "common.cuh"

#define K3_THREADS 256
#define K3_WARPS (K3_THREADS / 32)
#define K3_W 512                       // sites per window
#define K3_SPT (K3_W / K3_THREADS)     // sites per thread
#define K3_REC (K3_SPT * BR_SLOTS)     // record entries per thread
#define K3_LV 9                        // jump levels: 2^K3_LV >= K3_W
#define K3_NONE K3_W                   // "leaves the window"
#define K3_NOEND (-2147483647 - 1)     // no record end
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ void k3_load8(const int32_t* __restrict__ a,
                                         size_t i, bool vec, int v[8]) {
  if (vec) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(a + i));
    const int4 y = __ldg(reinterpret_cast<const int4*>(a + i) + 1);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s) v[s] = __ldg(a + i + s);
  }
}

__device__ __forceinline__ int k3_warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

__global__ void __launch_bounds__(K3_THREADS) splice_walk_kernel(
    const int32_t* __restrict__ rstart, const int32_t* __restrict__ rlen,
    const int32_t* __restrict__ s_pos, const int32_t* __restrict__ n_sites,
    const int32_t* __restrict__ succ, const int32_t* __restrict__ s_cap,
    const int32_t* __restrict__ rec_p, const int32_t* __restrict__ rec_c,
    const int32_t* __restrict__ rec_s, const uint8_t* __restrict__ cap_dense,
    int CHUNK, int R, int NS, int32_t* __restrict__ seg,
    int32_t* __restrict__ rtab, int32_t* __restrict__ out_len,
    uint8_t* __restrict__ cap, int32_t* __restrict__ rec_cnt,
    int32_t* __restrict__ aux) {
  __shared__ int32_t sh_sraw[K3_W];        // succ of the window's sites
  __shared__ int16_t sh_jump[K3_LV][K3_W + 1];
  __shared__ uint8_t sh_vis[K3_W];
  __shared__ int sh_lo, sh_hi, sh_last;
  __shared__ int sh_cnt[4];  // capped sites: overflow, attempt, rounds, any
  __shared__ int sh_nvis;
  __shared__ int sh_end[K3_WARPS];
  __shared__ int2 sh_sum[K3_WARPS];

  {  // this block's chunk
    const size_t y = blockIdx.y;
    const unsigned r = R, ns = NS, nrec = ns * BR_SLOTS;
    rstart += y * r;
    rlen += y * r;
    s_pos += y * ns;
    n_sites += y;
    succ += y * ns;
    s_cap += y * ns;
    rec_p += y * nrec;
    rec_c += y * nrec;
    rec_s += y * nrec;
    cap_dense += y * r;
    seg += y * (4 * nrec);
    rtab += y * (4 * r);
    out_len += y * r;
    cap += y * r;
    rec_cnt += y * r;
    aux += y * 8;
  }

  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NSEG = NS * BR_SLOTS;
  int32_t* __restrict__ seg_o = seg;
  int32_t* __restrict__ seg_pe = seg + NSEG;
  int32_t* __restrict__ seg_v = seg + 2 * NSEG;
  int32_t* __restrict__ seg_r = seg + 3 * NSEG;
  const int rs = rstart[r];
  const int n = rlen[r];
  const int n_eff = min(n_sites[0], NS);
  if (r == 0 && tid == 0) {
    aux[0] = n_eff;
    aux[7] = n_sites[0];
  }
  if (rs >= CHUNK) {  // unused slot
    if (tid == 0) {
      out_len[r] = 0;
      cap[r] = cap_dense[r];
      rec_cnt[r] = 0;
      rtab[r] = rtab[R + r] = rtab[2 * R + r] = rtab[3 * R + r] = 0;
    }
    return;
  }
  const int rnext = r + 1 < R ? rstart[r + 1] : CHUNK;
  const int rcap = rnext - rs;
  const int rend = rs + n;

  // 1. the read's listed sites [lo, hi)
  if (warp == 0) {
    const int v = br_warp_lower_bound(s_pos, n_eff, rs, lane);
    if (lane == 0) sh_lo = v;
  } else if (warp == 1 && n > 0) {
    const int v = br_warp_lower_bound(s_pos, n_eff, rend, lane);
    if (lane == 0) sh_hi = v;
  }
  if (tid < 4) sh_cnt[tid] = 0;
  if (tid == 0) sh_nvis = 0;
  for (int l = tid; l < K3_LV; l += K3_THREADS) sh_jump[l][K3_NONE] = K3_NONE;
  __syncthreads();
  const int lo = sh_lo, hi = n > 0 ? sh_hi : lo;
  const int sbase = lo * BR_SLOTS;  // the read's segment table

  // capped sites of this read, visited or not
  {
    int c1 = 0, c2 = 0, c4 = 0, ca = 0;
#pragma unroll 4
    for (int x = lo + tid; x < hi; x += K3_THREADS) {
      const int sc = s_cap[x];
      c1 += sc == BR_CAP_OVERFLOW;
      c2 += sc == BR_CAP_ATTEMPT;
      c4 += sc == BR_CAP_ROUNDS;
      ca += sc > 0;
    }
    c1 = k3_warp_sum(c1);
    c2 = k3_warp_sum(c2);
    c4 = k3_warp_sum(c4);
    ca = k3_warp_sum(ca);
    if (lane == 0 && ca) {
      atomicAdd(&sh_cnt[0], c1);
      atomicAdd(&sh_cnt[1], c2);
      atomicAdd(&sh_cnt[2], c4);
      atomicAdd(&sh_cnt[3], ca);
    }
  }

  const bool vec = ((reinterpret_cast<uintptr_t>(rec_p) |
                     reinterpret_cast<uintptr_t>(rec_c) |
                     reinterpret_cast<uintptr_t>(rec_s)) & 15u) == 0;
  int x = lo;      // the chain's next site
  int pe = rs;     // end of the last record so far
  int body = 0;    // output length of the records so far
  int m = 0;       // records so far
  bool vneg = false;
  int nvis = 0;
  while (x < hi) {
    // 2. stage the window [x, x + nw)
    const int w0 = x, nw = min(K3_W, hi - w0);
    for (int i = tid; i < nw; i += K3_THREADS) {
      const int s = succ[w0 + i];
      sh_sraw[i] = s;
      sh_jump[0][i] = (s > w0 + i && s < w0 + nw) ? (int16_t)(s - w0)
                                                  : (int16_t)K3_NONE;
      sh_vis[i] = 0;
    }
    __syncthreads();

    // 3. visited sites of the window: the chain from its site 0
    int lv = 1;
    while ((1 << lv) < nw) ++lv;
    for (int l = 1; l < lv; ++l) {
      for (int i = tid; i < nw; i += K3_THREADS)
        sh_jump[l][i] = sh_jump[l - 1][sh_jump[l - 1][i]];
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < K3_SPT; ++u) {
      const int y = tid * K3_SPT + u;
      if (y < nw) {
        int z = 0;
        for (int l = lv - 1; l >= 0; --l) {
          const int z2 = sh_jump[l][z];
          if (z2 <= y) z = z2;
        }
        if (z == y) {
          sh_vis[y] = 1;
          if (sh_jump[0][y] == K3_NONE) sh_last = y;
        }
      }
    }
    __syncthreads();

    // 4. the thread's records, in (site, slot) order
    int P[K3_REC], Cn[K3_REC], Sh[K3_REC];
    uint32_t used = 0;
#pragma unroll
    for (int u = 0; u < K3_SPT; ++u) {
      const int y = tid * K3_SPT + u;
      if (y < nw && sh_vis[y]) {
        ++nvis;
        const size_t e0 = (size_t)(w0 + y) * BR_SLOTS;
        k3_load8(rec_p, e0, vec, P + u * BR_SLOTS);
        k3_load8(rec_c, e0, vec, Cn + u * BR_SLOTS);
        k3_load8(rec_s, e0, vec, Sh + u * BR_SLOTS);
#pragma unroll
        for (int s = 0; s < BR_SLOTS; ++s)
          used |= (uint32_t)(P[u * BR_SLOTS + s] < BR_BIG)
                  << (u * BR_SLOTS + s);
      }
    }
    int my_end = K3_NOEND;
#pragma unroll
    for (int e = 0; e < K3_REC; ++e)
      if ((used >> e) & 1u) my_end = P[e] + Sh[e];

    // end of the last record before this thread's first: a block-wide
    // scan of "last valid"
    int incl_end = my_end;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl_end, off);
      if (lane >= off && incl_end == K3_NOEND) incl_end = y;
    }
    int pin_end = __shfl_up_sync(FULL_MASK, incl_end, 1);
    if (lane == 0) pin_end = K3_NOEND;
    if (lane == 31) sh_end[warp] = incl_end;
    __syncthreads();
    int win_end = pe;
    for (int w = 0; w < K3_WARPS; ++w) {
      const int v = sh_end[w];
      if (w == warp && pin_end == K3_NOEND) pin_end = win_end;
      if (v != K3_NOEND) win_end = v;
    }

    // the thread's records: count and output length
    int cnt = 0, sl = 0;
    {
      int q = pin_end;
#pragma unroll
      for (int e = 0; e < K3_REC; ++e) {
        if ((used >> e) & 1u) {
          int v = P[e] - q;
          vneg |= v < 0;
          v = max(0, min(v, CHUNK));
          sl += v + Cn[e];
          ++cnt;
          q = P[e] + Sh[e];
        }
      }
    }
    // record index and output offset: block-wide exclusive sums
    int ic = cnt, is = sl;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int yc = __shfl_up_sync(FULL_MASK, ic, off);
      const int ys = __shfl_up_sync(FULL_MASK, is, off);
      if (lane >= off) {
        ic += yc;
        is += ys;
      }
    }
    if (lane == 31) sh_sum[warp] = make_int2(ic, is);
    __syncthreads();
    int rb = ic - cnt, ob = is - sl, nrec = 0, wlen = 0;
    for (int w = 0; w < K3_WARPS; ++w) {
      const int2 t = sh_sum[w];
      if (w < warp) {
        rb += t.x;
        ob += t.y;
      }
      nrec += t.x;
      wlen += t.y;
    }
    {
      int q = pin_end, o = body + ob, jj = sbase + m + rb;
#pragma unroll
      for (int e = 0; e < K3_REC; ++e) {
        if ((used >> e) & 1u) {
          const int v = max(0, min(P[e] - q, CHUNK));
          seg_o[jj] = o;
          seg_pe[jj] = q;
          seg_v[jj] = v;
          seg_r[jj] = (w0 + tid * K3_SPT) * BR_SLOTS + e;
          o += v + Cn[e];
          q = P[e] + Sh[e];
          ++jj;
        }
      }
    }

    // the window where the chain goes next
    const int last = sh_last;
    const int s_last = sh_sraw[last];
    x = s_last > w0 + last ? s_last : hi;
    body += wlen;
    m += nrec;
    pe = win_end;
    __syncthreads();  // the next window reuses shared memory
  }

  const int tail = rend - pe;
  int outl = body + tail;
  vneg = __syncthreads_or(vneg);
  const bool capped = cap_dense[r] || vneg ||
                      (n > 0 && (outl > rcap || tail < 0)) || sh_cnt[3] > 0;
  outl = n > 0 ? max(0, min(outl, rcap)) : 0;

  nvis = k3_warp_sum(nvis);
  if (lane == 0 && nvis) atomicAdd(&sh_nvis, nvis);
  __syncthreads();
  if (tid == 0) {
    out_len[r] = outl;
    cap[r] = capped;
    rec_cnt[r] = m;
    rtab[r] = body;
    rtab[R + r] = pe;
    rtab[2 * R + r] = sbase;
    rtab[3 * R + r] = m;
    if (sh_nvis) atomicAdd(&aux[4], sh_nvis);
    if (sh_cnt[3]) {
      atomicAdd(&aux[1], sh_cnt[0]);
      atomicAdd(&aux[2], sh_cnt[1]);
      atomicAdd(&aux[3], sh_cnt[2]);
    }
  }
}

// 16 consecutive codes from codes[s] (any alignment), masked to 2 bits,
// as 4 words of bytes: two aligned 16-byte loads and a funnel shift.  The
// aligned 32 bytes around s must lie in the chunk.
__device__ __forceinline__ void k3_codes16(const uint8_t* __restrict__ codes,
                                           int s, uint32_t w[4]) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(codes + (s & ~15)));
  const uint4 y =
      __ldg(reinterpret_cast<const uint4*>(codes + (s & ~15)) + 1);
  const uint32_t v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  const int q = (s >> 2) & 3, sh = 8 * (s & 3);
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // words q+k and q+k+1, by selects
    uint32_t lo = v[k], hi = v[k + 1];
    lo = q == 1 ? v[k + 1] : lo;
    hi = q == 1 ? v[k + 2] : hi;
    lo = q == 2 ? v[k + 2] : lo;
    hi = q == 2 ? v[k + 3] : hi;
    lo = q == 3 ? v[k + 3] : lo;
    hi = q == 3 ? v[k + 4] : hi;
    w[k] = __funnelshift_r(lo, hi, sh) & 0x03030303u;
  }
}

// bases e .. e+15 of an emit row (base e is bits 2*(e%16) of word e/16) as
// 4 words of bytes; the row holds word (e+15)/16
__device__ __forceinline__ void k3_emit16(const int32_t* __restrict__ row,
                                          int e, uint32_t w[4]) {
  const int sh = 2 * (e & 15);
  const uint32_t lo = (uint32_t)__ldg(row + (e >> 4));
  const uint32_t hi = sh ? (uint32_t)__ldg(row + (e >> 4) + 1) : 0u;
  const uint32_t v = __funnelshift_r(lo, hi, sh);
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // 4 two-bit fields to 4 bytes
    uint32_t t = (v >> (8 * k)) & 0xffu;
    t = (t | (t << 12)) & 0x000f000fu;
    w[k] = (t | (t << 6)) & 0x03030303u;
  }
}

// last j in [0, n) with a[j] <= o, where a[0] <= o
__device__ __forceinline__ int k3_seg_search(const int32_t* __restrict__ a,
                                             int n, int o) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= o) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

__global__ void __launch_bounds__(K3_THREADS) splice_copy_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ rstart,
    const int32_t* __restrict__ rec_e, const int32_t* __restrict__ seg,
    const int32_t* __restrict__ rtab, const int32_t* __restrict__ out_len,
    int CHUNK, int R, int NS, int EW, uint8_t* __restrict__ out) {
  __shared__ int32_t sh_start[BR_MAX_R];
  {  // this block's chunk
    const size_t y = blockIdx.y;
    const unsigned chunk = CHUNK, r = R, nrec = (unsigned)NS * BR_SLOTS;
    codes += y * chunk;
    rstart += y * r;
    rec_e += y * (nrec * (unsigned)EW);
    seg += y * (4 * nrec);
    rtab += y * (4 * r);
    out_len += y * r;
    out += y * chunk;
  }
  for (int i = threadIdx.x; i < R; i += K3_THREADS) sh_start[i] = rstart[i];
  __syncthreads();
  const int gc = (blockIdx.x * K3_THREADS + threadIdx.x) << 4;
  if (gc >= CHUNK) return;
  const int NSEG = NS * BR_SLOTS;
  const int32_t* __restrict__ seg_o = seg;
  const int32_t* __restrict__ seg_pe = seg + NSEG;
  const int32_t* __restrict__ seg_v = seg + 2 * NSEG;
  const int32_t* __restrict__ seg_r = seg + 3 * NSEG;
  const bool cvec = (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;
  int r = br_slot_of(sh_start, R, gc);

  // a run inside one slot and one source: a few wide operations
  if (r >= 0 && gc + 16 <= CHUNK &&
      (r + 1 >= R || gc + 16 <= sh_start[r + 1])) {
    const int o0 = gc - sh_start[r], outl = out_len[r], body = rtab[r];
    int fast = 0, fs = 0, row = 0;  // 1 codes from fs, 2 emit, 3 zeros
    if (o0 >= outl) {
      fast = 3;
    } else if (o0 + 15 < outl && o0 >= body) {
      fs = rtab[R + r] + (o0 - body);
      fast = 1;
    } else if (o0 + 15 < outl && o0 + 15 < body) {
      const int base = rtab[2 * R + r], nseg = rtab[3 * R + r];
      const int j = k3_seg_search(seg_o + base, nseg, o0);
      const int so = seg_o[base + j], vl = seg_v[base + j];
      const int nxt = j + 1 < nseg ? seg_o[base + j + 1] : body;
      if (o0 + 15 < nxt) {
        const int d = o0 - so;
        if (d + 15 < vl) {
          fs = seg_pe[base + j] + d;
          fast = 1;
        } else if (d >= vl && ((d - vl + 15) >> 4) < EW) {
          fs = d - vl;
          row = seg_r[base + j];
          fast = 2;
        }
      }
    }
    if (fast == 1 && !(cvec && fs >= 0 && (fs & ~15) + 32 <= CHUNK))
      fast = 0;  // the byte path clamps at the chunk's ends
    if (fast) {
      uint32_t w[4] = {0, 0, 0, 0};
      if (fast == 1) k3_codes16(codes, fs, w);
      else if (fast == 2) k3_emit16(rec_e + (size_t)row * EW, fs, w);
      *reinterpret_cast<uint4*>(out + gc) = make_uint4(w[0], w[1], w[2], w[3]);
      return;
    }
  }

  // byte by byte: each byte's source, then the 16 loads together
  const uint8_t* src[16];
  uint32_t wr = 0, live = 0, shift = 0;  // bit masks; 2 bits a byte
  int cr = -1, rs = 0, outl = 0, body = 0, last = 0, base = 0, nseg = 0;
  int j = -1, so = 0, vl = 0, pe0 = 0, row = 0, nxt = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int g = gc + i;
    src[i] = codes;  // a valid address where nothing is read
    if (g >= CHUNK) continue;
    wr |= 1u << i;
    while (r + 1 < R && sh_start[r + 1] <= g) ++r;
    if (r < 0) continue;  // before the first slot: 0
    if (r != cr) {
      cr = r;
      rs = sh_start[r];
      outl = out_len[r];
      body = rtab[r];
      last = rtab[R + r];
      base = rtab[2 * R + r];
      nseg = rtab[3 * R + r];
      j = -1;
    }
    const int o = g - rs;
    if (o >= outl) continue;  // past out_len: 0
    live |= 1u << i;
    if (o >= body) {  // the tail
      src[i] = codes + max(0, min(last + (o - body), CHUNK - 1));
      continue;
    }
    if (j < 0) {
      j = k3_seg_search(seg_o + base, nseg, o);
      so = seg_o[base + j];
      vl = seg_v[base + j];
      pe0 = seg_pe[base + j];
      row = seg_r[base + j];
      nxt = j + 1 < nseg ? seg_o[base + j + 1] : body;
    }
    while (o >= nxt) {  // next segment (past empty ones)
      ++j;
      so = nxt;
      vl = seg_v[base + j];
      pe0 = seg_pe[base + j];
      row = seg_r[base + j];
      nxt = j + 1 < nseg ? seg_o[base + j + 1] : body;
    }
    const int d = o - so;
    if (d < vl) {
      src[i] = codes + max(0, min(pe0 + d, CHUNK - 1));
    } else {  // base e: bits 2*(e%16) of word e/16
      const int e = d - vl;
      src[i] = reinterpret_cast<const uint8_t*>(
                   rec_e + (size_t)row * EW + min(e >> 4, EW - 1)) +
               ((e >> 2) & 3);
      shift |= (uint32_t)(e & 3) << (2 * i);
    }
  }
  uint32_t raw[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) raw[i] = __ldg(src[i]);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t v = (raw[i] >> (2 * ((shift >> (2 * i)) & 3u))) & 3u;
    w[i >> 2] |= ((live >> i) & 1u ? v : 0u) << (8 * (i & 3));
  }
  if (wr == 0xffffu) {
    *reinterpret_cast<uint4*>(out + gc) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if ((wr >> i) & 1u)
        out[gc + i] = (uint8_t)((w[i >> 2] >> (8 * (i & 3))) & 3u);
  }
}

extern "C" int br_chain_splice(
    int NC, const void* codes, const void* rstart, const void* rlen,
    const void* s_pos, const void* n_sites, const void* succ,
    const void* s_cap, const void* rec_p, const void* rec_c,
    const void* rec_s, const void* rec_e, const void* cap_dense, int CHUNK,
    int R, int NS, int EW, void* seg, void* rtab, void* out,
    void* out_len, void* cap, void* rec_cnt, void* aux, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  splice_walk_kernel<<<dim3(R, NC), K3_THREADS, 0, st>>>(
      (const int32_t*)rstart, (const int32_t*)rlen, (const int32_t*)s_pos,
      (const int32_t*)n_sites, (const int32_t*)succ, (const int32_t*)s_cap,
      (const int32_t*)rec_p, (const int32_t*)rec_c, (const int32_t*)rec_s,
      (const uint8_t*)cap_dense, CHUNK, R, NS, (int32_t*)seg,
      (int32_t*)rtab, (int32_t*)out_len, (uint8_t*)cap, (int32_t*)rec_cnt,
      (int32_t*)aux);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int runs = (CHUNK + 15) / 16;
  splice_copy_kernel<<<dim3((runs + K3_THREADS - 1) / K3_THREADS, NC),
                       K3_THREADS, 0, st>>>(
      (const uint8_t*)codes, (const int32_t*)rstart, (const int32_t*)rec_e,
      (const int32_t*)seg, (const int32_t*)rtab, (const int32_t*)out_len,
      CHUNK, R, NS, EW, (uint8_t*)out);
  return (int)cudaGetLastError();
}
