// Shared device code of the site kernels: K2 one_sites, K5 two_sites,
// K6 walk_sites and K7 greedy_sites.
//
// The site chain (the site-block queue of br_tpu/correct/engine3.py:
// 1592-1708, with the JAX queue's generation capacities NQA / MAXB ->
// CAP_ROUNDS having no counterpart), br_site_chain_warp: one warp per
// listed site id sid < NS runs its site's whole chain of nested attempts
// to the end, with the same state held alike in every lane, and the lanes
// sharing each step's independent loads: the gate's 4 probes on lanes 0-3
// and a ballot; the attempt's probes (the kernel's own functor, which
// spreads them over the lanes and reads its codes from a window held in
// every lane, br_window_warp); the dirty simulation's up to k probes at
// once (lane m rolls the register m+1 steps by a shuffle scan of the
// codes, a ballot finds the first event); the successor among the next
// 32 listed sites in one load (a 32-way warp search past them).  A
// warp's chain has as many dependent L2 round trips as it has gates,
// attempt rounds and dirty windows, in place of one per probe, and NS
// warps (2 a block for K2 and K5, 8 for K6 and K7, whose warps hold
// shared memory) keep every SM's schedulers fed.  A launch takes a group
// of NC chunks of one geometry against one table: blockIdx.y is the
// chunk, and br_sites_chunk moves a block to its chunk's arrays, so a
// chunk's chains are those of a launch of its own.
//
// A chain step is: the exactly-one-alternative gate (_alt_info32_arr,
// :966); the strategy's attempt; a repair record when it applies (at most
// SLOTS per site, beyond that CAP_OVERFLOW); an attempt that hits an
// engineered bound caps the site with CAP_ATTEMPT; then the dirty
// simulation (dirty_sim, :1526-1564) for k steps past the last repair,
// which either finds a nested site (attempt again there), reaches the
// read end, or hands over to the successor: the first listed site at or
// after the stop position inside the read (a lower bound over s_pos, in
// place of the JAX nt table).
//
// Every function on a k-mer is a template on its register type T and on
// the set's probe policy P (common.cuh): BrBitProbe, the bitfield, with
// T = uint32_t for k <= 15 and uint64_t for k = 17; BrSortedProbe, the
// sorted table of a HashSet, with T = uint64_t for any k <= 31.  Each
// site kernel's source instantiates all three and has one entry point for
// each (the sorted one named <entry>_h, which takes the table's bucket
// index, BR_SORTED_PARAMS).
//
// Records: rec_p / rec_c / rec_s (NS*SLOTS) hold position, emitted base
// count and consumed positions; rec_e (NS*SLOTS, EW) the emitted bases,
// 16 2-bit bases per 32-bit word, LSB first.  An attempt writes its emit
// words into the record row it is given (none past SLOTS).  A record's
// rec_c, rec_s and first ceil(rec_c/16) emit words are written; an unused
// slot gets rec_p = BR_BIG and nothing else, and words past a record's
// count are left as they are: K3 stops at the rec_p sentinel and at
// rec_c, so nothing reads them (sites.defined is what is compared).
#pragma once

#include "common.cuh"

#define BR_SITE_THREADS 256
// sites per block of a warp-per-site kernel with shared memory per warp
// (K6, K7)
#define BR_WARP_SITES (BR_SITE_THREADS / 32)
// sites per block of K2 and K5, which hold no shared memory: a block
// frees its SM slot as soon as the slower of its two chains ends
#define BR_PAIR_SITES 2
#define BR_BPW 16
#define BR_DONE_PURE 0
#define BR_DONE_END 1
#define BR_PENDING 2

// The code at flat position i, clipped into the chunk like the JAX window
// gathers (_code_at, engine3.py:179).  Past a read's end this is the next
// slot's or stale slack's code: only each attempt's rem gating keeps such
// bases out of a result, never their values.
__device__ __forceinline__ uint32_t code_at(const uint8_t* codes, int i,
                                            int CHUNK) {
  i = i < 0 ? 0 : (i < CHUNK ? i : CHUNK - 1);
  return codes[i] & 3u;
}

// Everything a site kernel reads and writes.  kmers is K1's output:
// int32 k-mers for a bitfield at k <= 15, int64 past it and for a sorted
// table (br_kmer_at); probe is the set's membership test.
template <class P>
struct BrSites {
  const uint8_t* codes;
  P probe;
  const void* kmers;
  const int32_t* s_pos;
  const int32_t* n_sites;
  const int32_t* rstart;
  const int32_t* rlen;
  int CHUNK, R, k, NS, EW;
  int32_t* succ;
  int32_t* s_cap;
  int32_t* rec_p;
  int32_t* rec_c;
  int32_t* rec_s;
  int32_t* rec_e;
};

// One attempt's result (AttemptOut3, engine3.py:220).
template <class T>
struct BrAttempt {
  bool ok;            // the repair applies
  bool cap;           // an engineered bound was hit: the site caps
  T new_kmer;         // the register after the emitted bases
  int consumed;       // input positions skipped
  int cnt;            // emitted bases
};

// K1's k-mer at position p in the register type.
template <class T, class P>
__device__ __forceinline__ T br_kmer_at(const BrSites<P>& a, int p) {
  if constexpr (sizeof(T) == 8)
    return (T)static_cast<const int64_t*>(a.kmers)[p];
  else
    return (T)static_cast<const int32_t*>(a.kmers)[p];
}

// codes a register holds (16 or 32); the window lag of the One attempt,
// the most codes before a probe's last one, k - 1 <= 14, 16 or 30 (the
// largest k of the instantiation, kMaxK); and the 32-code words of an
// attempt's code window, two where a round's codes pass 32 positions
template <class T>
__host__ __device__ constexpr int br_reg_codes() {
  return 4 * (int)sizeof(T);
}
template <class T, class P>
__host__ __device__ constexpr int br_lag() {
  return P::template kMaxK<T> - 1;
}
template <class T, class P>
__host__ __device__ constexpr int br_win_words() {
  return br_lag<T, P>() > 16 ? 2 : 1;
}

// ---------------------------------------------------------------------
// The warp-per-site chain.  Every lane of the warp calls these with the
// same arguments and gets the same results; lane is threadIdx.x & 31.
// ---------------------------------------------------------------------

// Alternatives for the last base of km (mod.rs:114-116), lane a < 4
// probing base ^ a: returns how many of base ^ a are solid; *repl = base
// ^ (sum of those a), the one alternative when the count is 1.
template <class T, class P>
__device__ __forceinline__ int br_alt_last_warp(const P& probe, T km, int k,
                                                int lane, T* repl) {
  const T base = (km >> 2) << 2;
  const bool v = lane < 4 && probe(base ^ (T)lane, k);
  const uint32_t m = __ballot_sync(BR_FULL, v) & 0xFu;
  *repl = base ^ (T)(((m >> 1) & 1u) + 2u * ((m >> 2) & 1u) + 3u * (m >> 3));
  return __popc(m);
}

// Successors of km (mod.rs:118-128), lane a < 4 probing add(km, a):
// returns how many are solid; *code = the sum of those a, the one
// successor's base when the count is 1.
template <class T, class P>
__device__ __forceinline__ int br_alt_next_warp(const P& probe, T km, int k,
                                                T kmask, int lane,
                                                uint32_t* code) {
  const bool v = lane < 4 && probe(br_add(km, lane, kmask), k);
  const uint32_t m = __ballot_sync(BR_FULL, v) & 0xFu;
  *code = ((m >> 1) & 1u) + 2u * ((m >> 2) & 1u) + 3u * (m >> 3);
  return __popc(m);
}

// Lane m < NB-1 (NB = br_reg_codes<T>(): 15 lanes for uint32_t, 31 for
// uint64_t): the register km after the m+1 adds of code_at(from), ...,
// code_at(from + m), by an inclusive shuffle scan of the lanes' codes
// (each lane loads one).  Other lanes get a value nobody may use.  The
// dirty simulation and err_len take lanes m < k <= 31: at k = 31 lane 30
// rolls 31 codes (62 bits) into km, all of it inside uint64_t.
template <class T>
__device__ __forceinline__ T br_roll_warp(const uint8_t* codes, int CHUNK,
                                          T km, int from, int lane,
                                          T kmask) {
  constexpr int NB = br_reg_codes<T>();
  T x = code_at(codes, from + lane, CHUNK);
#pragma unroll
  for (int d = 1; d < NB; d <<= 1) {
    const T y = __shfl_up_sync(BR_FULL, x, d);
    if (lane >= d) x |= y << (2 * d);
  }
  const T hi = lane < NB - 1 ? km << (2 * (lane + 1)) : T(0);
  return (hi | x) & kmask;
}

// 32 * NW codes of an attempt's window, at i+base .. i+base+32*NW-1
// (code_at, so clipped into the chunk), held alike in every lane: bit j
// of lo[w] / hi[w] is the low / high bit of the code at i+base+32w+j,
// loaded one code a lane a word and gathered by two ballots a word.  An
// attempt orders its probes so that a round of 32 lanes needs codes
// within 13 positions past its first probe's last code, plus the k - 1
// before it, and loads the window again for a round past it: any confirm
// count c works with the codes in registers.  One word holds that for
// k <= 17 (29 positions), two for k <= 31 (43 positions).
template <int NW>
struct BrWindow {
  uint32_t lo[NW], hi[NW];
  int base;
};

template <int NW>
__device__ __forceinline__ BrWindow<NW> br_window_warp(const uint8_t* codes,
                                                       int CHUNK, int i,
                                                       int base, int lane) {
  BrWindow<NW> w;
#pragma unroll
  for (int v = 0; v < NW; ++v) {
    const uint32_t x = code_at(codes, i + base + 32 * v + lane, CHUNK);
    w.lo[v] = __ballot_sync(BR_FULL, x & 1u);
    w.hi[v] = __ballot_sync(BR_FULL, x >> 1);
  }
  w.base = base;
  return w;
}

// bits s .. s+15 of a window's bit plane
template <int NW>
__device__ __forceinline__ uint32_t br_plane(const uint32_t (&x)[NW],
                                             int s) {
  if constexpr (NW == 1) {
    return x[0] >> s;
  } else {
    return (uint32_t)((((uint64_t)x[1] << 32) | x[0]) >> s);
  }
}

// The n (1..16) codes of the window ending at i+e, the first in the high
// bits: a register's last n bases after it absorbed them (i+base <= i+e-n+1,
// e < base+32*NW).
template <int NW>
__device__ __forceinline__ uint32_t br_span(const BrWindow<NW>& w, int e,
                                            int n) {
  const int s = e - n + 1 - w.base;
  const uint32_t m = (1u << n) - 1u;
  const uint32_t l = __brev(br_plane(w.lo, s) & m) >> (32 - n);
  const uint32_t h = __brev(br_plane(w.hi, s) & m) >> (32 - n);
  // bits l and h of each code to the even and odd bits
  uint32_t x = l | (h << 16);
  x = (x & 0xFF0000FFu) | ((x & 0x00FF0000u) >> 8) | ((x & 0x0000FF00u) << 8);
  x = (x & 0xF00FF00Fu) | ((x & 0x0F000F00u) >> 4) | ((x & 0x00F000F0u) << 4);
  x = (x & 0xC3C3C3C3u) | ((x & 0x30303030u) >> 2) | ((x & 0x0C0C0C0Cu) << 2);
  x = (x & 0x99999999u) | ((x & 0x44444444u) >> 1) | ((x & 0x22222222u) << 1);
  return x;
}

// br_span of n (1..32) codes in the register type: past 16 codes, the
// first n-16 in the high word.
template <class T, int NW>
__device__ __forceinline__ T br_span_t(const BrWindow<NW>& w, int e, int n) {
  if constexpr (sizeof(T) == 8) {
    if (n > 16)
      return ((uint64_t)br_span(w, e - 16, n - 16) << 32) | br_span(w, e, 16);
  }
  return br_span(w, e, n);
}

// km after absorbing the m >= 1 codes of the window ending at i+e: the m
// br_adds of a thread in one step, since only the last k codes remain.
template <class T, int NW>
__device__ __forceinline__ T br_roll_window(const BrWindow<NW>& w, T km,
                                            int e, int m, int k, T kmask) {
  const T hi = m < k ? km << (2 * m) : T(0);
  return (hi | br_span_t<T>(w, e, m < k ? m : k)) & kmask;
}

// The One attempt (exist/one.rs; make_one_attempt32_arr, engine3.py:300):
// scenarios D (offset 0), S (1), I (2), each scored over c+1 k-mers of
// the code window i+off .. i+off+c; a unique perfect score, or a unique
// one_more among several.  corr is the gated alternative k-mer.  Its
// 1 + 3*(c+1) probes are independent: lane idx = 3*s + off takes k-mer s
// of scenario off (rounds of 32 past 32 probes, a round's codes within
// s0-L .. s0+13 for its first s0, L = br_lag<T, P>() >= k-1), and the
// scenario masks are OR-reduced.
template <class T, class P>
__device__ __forceinline__ BrAttempt<T> br_one_attempt_warp(
    const BrSites<P>& a, int c, int i, T corr, int lenf, int32_t* erow,
    int lane) {
  constexpr int L = br_lag<T, P>();
  constexpr int NW = br_win_words<T, P>();
  const T kmask = br_kmask<T>(a.k);
  const int rem = lenf - i;
  const bool corr_ok = a.probe(corr, a.k);
  const int tot = 3 * (c + 1);
  uint32_t failm = 0, lastm = 0;
  for (int r0 = 0; r0 < tot; r0 += 32) {
    const int s0 = r0 / 3;
    const BrWindow<NW> w = br_window_warp<NW>(a.codes, a.CHUNK, i,
                                              s0 > L ? s0 - L : 0, lane);
    const int idx = r0 + lane;
    if (idx < tot) {
      const int s = idx / 3, off = idx - 3 * s;
      const T km = br_roll_window(w, corr, off + s, s + 1, a.k, kmask);
      const bool v = a.probe(km, a.k);
      if (s < c) {
        if (!v) failm |= 1u << off;
      } else if (v) {
        lastm |= 1u << off;
      }
    }
  }
  failm = __reduce_or_sync(BR_FULL, failm);
  lastm = __reduce_or_sync(BR_FULL, lastm);
  // scenario masks, bit off: keep, and keep with one_more
  uint32_t keepm = 0, keep2m = 0;
  for (int off = 0; off < 3; ++off) {
    const bool kp = (off + c <= rem) && corr_ok && !((failm >> off) & 1u);
    const bool more = (rem > c + off + 1) && ((lastm >> off) & 1u);
    keepm |= (uint32_t)kp << off;
    keep2m |= (uint32_t)(kp && more) << off;
  }
  const int nk = __popc(keepm), nk2 = __popc(keep2m);
  const uint32_t sel = nk == 1 ? keepm : keep2m;
  BrAttempt<T> r;
  r.ok = (nk == 1) || (nk > 1 && nk2 == 1);
  r.consumed = (sel & 2u) ? 1 : ((sel & 4u) ? 2 : 0);
  r.cap = false;
  r.new_kmer = corr;
  r.cnt = 1;
  if (r.ok && erow && lane == 0) erow[0] = (int32_t)(corr & 3u);
  return r;
}

// The whole chain of site sid, run by one warp (every lane calls it with
// the same sid).  attempt(i, reg, corr, lenf, erow) is called by every
// lane and returns the same result in every lane; erow is the record row
// of the next record, or null past SLOTS.  Lane 0 writes the records,
// succ and s_cap; lanes nrec..SLOTS-1 the rec_p sentinels.  The site's
// read is found by a 32-way warp search of rstart (two dependent loads
// for 512 slots, no staging in shared memory).
template <class T, class P, class Attempt>
__device__ __forceinline__ void br_site_chain_warp(const BrSites<P>& a,
                                                   int sid, int lane,
                                                   Attempt& attempt) {
  const int n_eff = min(a.n_sites[0], a.NS);
  const int rb = sid * BR_SLOTS;
  const int k = a.k;
  int nrec = 0, cap = 0, nxt = a.NS;

  if (sid < n_eff) {
    const T kmask = br_kmask<T>(k);
    const int pos = a.s_pos[sid];
    T reg = br_kmer_at<T>(a, pos);
    // the last slot starting at or before pos
    const int rid = br_warp_lower_bound(a.rstart, a.R, pos + 1, lane) - 1;
    const int lenf = a.rstart[rid] + a.rlen[rid];
    int i = pos, t = k;
    while (true) {
      T corr;
      BrAttempt<T> r = {false, false, T(0), 0, 0};
      if (br_alt_last_warp(a.probe, reg, k, lane, &corr) == 1) {
        int32_t* erow = nrec < BR_SLOTS
                            ? a.rec_e + (size_t)(rb + nrec) * a.EW
                            : nullptr;
        r = attempt(i, reg, corr, lenf, erow);
        if (r.cap) { cap = BR_CAP_ATTEMPT; break; }
      }
      const bool applied = r.ok;
      if (applied) {
        if (nrec >= BR_SLOTS) { cap = BR_CAP_OVERFLOW; break; }
        if (lane == 0) {
          a.rec_p[rb + nrec] = i;
          a.rec_c[rb + nrec] = r.cnt;
          a.rec_s[rb + nrec] = r.consumed;
        }
        ++nrec;
      }
      // dirty simulation: lane m takes step m of the scan machine
      // (register after m+1 codes, si0+m, st0+m); the first lane with an
      // event (st >= k, the read end, or !v && prev) decides
      const int si0 = applied ? i + r.consumed : i + 1;
      const T sreg0 = applied ? r.new_kmer : reg;
      const int st0 = applied ? 0 : t;
      const T sm = br_roll_warp(a.codes, a.CHUNK, sreg0, si0, lane, kmask);
      const bool live = lane < k && st0 + lane < k && si0 + lane < lenf;
      const bool v = live && a.probe(sm, k);
      const uint32_t vm = __ballot_sync(BR_FULL, v);
      const bool prev = lane == 0 ? applied : ((vm >> (lane - 1)) & 1u);
      const bool ev = lane < k && (!live || (!v && prev));
      const uint32_t em = __ballot_sync(BR_FULL, ev);
      const int f = em ? __ffs(em) - 1 : k;
      const T sreg_f = __shfl_sync(BR_FULL, sm, f & 31);
      const int si = si0 + f;
      int state = BR_DONE_PURE;
      if (f < k && st0 + f < k)
        state = si >= lenf ? BR_DONE_END : BR_PENDING;
      if (state == BR_PENDING) {  // nested site: attempt again there
        i = si;
        reg = sreg_f;
        t = st0 + f + 1;
        continue;
      }
      if (state == BR_DONE_PURE && si < a.CHUNK) {
        // the successor, the first listed site at or after si (none
        // before sid is: si >= pos): among the 32 from sid in one load,
        // else by a warp search past them
        const int sp = sid + lane < n_eff ? a.s_pos[sid + lane] : BR_BIG;
        const uint32_t ge = __ballot_sync(BR_FULL, sp >= si);
        int q, sq;
        if (ge) {
          q = sid + __ffs(ge) - 1;
          sq = __shfl_sync(BR_FULL, sp, __ffs(ge) - 1);
        } else {
          q = sid + 32 + br_warp_lower_bound(a.s_pos + sid + 32,
                                             n_eff - sid - 32, si, lane);
          sq = q < n_eff ? a.s_pos[q] : BR_BIG;
        }
        if (q < n_eff && sq < lenf) nxt = q;
      }
      break;
    }
  }
  if (lane == 0) {
    a.succ[sid] = nxt;
    a.s_cap[sid] = cap;
  }
  if (lane >= nrec && lane < BR_SLOTS) a.rec_p[rb + lane] = BR_BIG;
}

// The entry points' struct, from the C arguments every site kernel takes
// and the set's probe.
template <class P>
static inline BrSites<P> br_sites_args(
    const void* codes, P probe, const void* kmers,
    const void* s_pos, const void* n_sites, const void* rstart,
    const void* rlen, int CHUNK, int R, int k, int NS, int EW, void* succ,
    void* s_cap, void* rec_p, void* rec_c, void* rec_s, void* rec_e) {
  BrSites<P> a;
  a.codes = (const uint8_t*)codes;
  a.probe = probe;
  a.kmers = kmers;
  a.s_pos = (const int32_t*)s_pos;
  a.n_sites = (const int32_t*)n_sites;
  a.rstart = (const int32_t*)rstart;
  a.rlen = (const int32_t*)rlen;
  a.CHUNK = CHUNK;
  a.R = R;
  a.k = k;
  a.NS = NS;
  a.EW = EW;
  a.succ = (int32_t*)succ;
  a.s_cap = (int32_t*)s_cap;
  a.rec_p = (int32_t*)rec_p;
  a.rec_c = (int32_t*)rec_c;
  a.rec_s = (int32_t*)rec_s;
  a.rec_e = (int32_t*)rec_e;
  return a;
}

// The chunk of a group that a block works on: a site kernel takes NC
// chunks of one geometry in one launch, chunk blockIdx.y.  Every
// per-chunk array is advanced to that chunk's, at a stride of one chunk:
// codes and K1's k-mers CHUNK, slots R, sites NS, one n_sites, records
// NS * SLOTS, emit words NS * SLOTS * EW.  The table is the group's.
// Each site kernel has a grouped instantiation (G), which does this, and
// a one-chunk one, launched for NC = 1, which reads its arguments as they
// are.  A short chain's warp pays the moves in its setup, and the moved
// pointers in registers: with the grouped code alone, NC = 1 ran K2 9 %,
// K6 14-16 % and K7 12 % slower than without a chunk axis on an H100
// (chip_smoke.py --baseline).  K1, K3 and K4 have the grouped code
// alone: at NC = 1 it ran them at 1.00-1.02x.
template <class T, class P>
__device__ __forceinline__ BrSites<P> br_sites_chunk(BrSites<P> a) {
  const size_t y = blockIdx.y;
  const size_t ns = (size_t)a.NS, nrec = ns * BR_SLOTS;
  a.codes += y * a.CHUNK;
  a.kmers = static_cast<const char*>(a.kmers) + y * a.CHUNK * sizeof(T);
  a.s_pos += y * ns;
  a.n_sites += y;
  a.rstart += y * a.R;
  a.rlen += y * a.R;
  a.succ += y * ns;
  a.s_cap += y * ns;
  a.rec_p += y * nrec;
  a.rec_c += y * nrec;
  a.rec_s += y * nrec;
  a.rec_e += y * nrec * a.EW;
  return a;
}

// the grid of a warp-per-site kernel with per_block sites a block: x the
// chunk's site blocks, y its NC chunks
static inline dim3 br_warp_site_grid(int NS, int per_block, int NC) {
  return dim3((NS + per_block - 1) / per_block, NC);
}

// The three entry points of a site kernel: <entry> (uint32_t, bitfield),
// <entry>64 (uint64_t, bitfield) and <entry>_h (uint64_t, sorted table,
// its index before the stream); ARGS is the parameter list up to the stream,
// whose second parameter is `const void* table`, and LAUNCH(T, probe)
// the launch with the register type and the probe in the table's place.
#define BR_SITE_ENTRIES(entry, ARGS, LAUNCH)                              \
  extern "C" int entry(ARGS, void* stream) {                              \
    return LAUNCH(uint32_t, BrBitProbe{(const uint32_t*)table});          \
  }                                                                       \
  extern "C" int entry##64(ARGS, void* stream) {                          \
    return LAUNCH(uint64_t, BrBitProbe{(const uint32_t*)table});          \
  }                                                                       \
  extern "C" int entry##_h(ARGS, BR_SORTED_PARAMS, void* stream) {      \
    return LAUNCH(uint64_t, BR_SORTED_PROBE(table));                      \
  }
