// K6 walk_sites: every attempt site of a `graph` or `gap-size` pass, with
// its whole chain of nested repairs.  One kernel; a mode argument picks
// the strategy.
//
// Replaces, in br_tpu/correct/engine3.py: the site-block queue
// (:1592-1708) for strategies "graph" and "gap-size"; their attempts
// make_graph_attempt32_arr (:1179-1195) and make_gap_attempt32_arr
// (:1198-1229); the exact error length err_fn (:1459-1499); and the walk
// semantics of _tiered_walk32 (:1099-1176) with _walk_phase32 (:983-1028)
// and _brent_walk32 (:1031-1088).
//
// error_len (mod.rs:130-152): at most k explicit absorbs from the site's
// register, then the next valid position at or after i+k+1 inside the
// read.  JAX reads that from nv, a reverse cummin over the chunk; here the
// warp scans K1's V mask forward from i+k+1 to the read end, which spares
// K1 a reverse scan across tiles for every pass when only the walk passes
// need it.  The k-mer there comes from K1's kmers.
//
// The walk, from the gated alternative: each step probes the 4
// successors; a branch (not exactly one) or a revisit DECLINEs, reaching
// first_correct ACCEPTs (graph mode), walking max_steps completes a fill
// (fill mode), and the step taken at walk_max CAPs, CAP outranking ACCEPT
// (:1020-1022).  The JAX tiers keep the full history up to walk_max, so
// revisits are exact there; so here.  Past walk_max the walk goes on as
// _brent_walk32 does: a branch or a Brent cycle DECLINEs (and the site is
// not capped); arriving at first_correct, completing a fill or passing
// T3_CAP stays CAP; a graph walk that capped exactly on first_correct
// stays CAP (:1163-1167).  Emit: word 0 holds the alternative's base, step
// n writes bits 2*(n%16) of word n/16; cnt = n; consumed is err_len+1 for
// graph, n for a fill (:1222-1224).  gap-size dispatches on err_len
// (gap_size.rs:97-108): graph mode below k, the One attempt at k, a fill
// of err_len-k steps above.
//
// One warp per site, the warp site chain of sites_common.cuh: NS warps,
// BR_WARP_SITES a block.  The JAX capacities with no counterpart: the
// queue's generations (NQA, MAXB -> CAP_ROUNDS), tier 2's lanes per round
// (NW2) and tier 3's lanes (NW3 = BLK): each warp walks its own site to
// the end.
//
// Bound on the H100: the walks' dependent steps, one L2 round trip for a
// step's 4 successor probes, and nothing else that the data allows to
// overlap.  What the warp does about the rest:
//  - err_len: lanes j = 1..k roll and probe the k explicit absorbs at once
//    (a ballot takes the first hit, with the j >= rem rule), then the V
//    scan reads 512 positions a step, 16 bytes a lane, and a warp minimum
//    takes the first valid one before min(lenf, CHUNK);
//  - gap-size's One attempt at err_len == k spreads its probes over lanes;
//  - the exact history of the walk is the warp's slice of dynamic shared
//    memory, walk_max+1 words (1 KB at 248, 8 KB at 2040); at each step
//    that did not branch every lane compares its stride of it against the
//    new k-mer and a vote decides: ceil(n/32) shared loads a lane in place
//    of the n global loads a thread made from a [step][site] scratch in
//    the thread-per-site design;
//  - Brent past walk_max stays one loop of the warp, its 4 probes on 4
//    lanes.
//
// Three instantiations from one source: br_walk_sites (uint32_t, a
// bitfield at k <= 15), br_walk_sites64 (uint64_t, a bitfield at k = 17)
// and br_walk_sites_h (uint64_t, a HashSet's sorted table at any k <=
// 31), the same code.  The history holds k-mers in the register type, so
// with 64-bit registers a warp's slice is (walk_max+1) * 8 bytes: 130,624
// B a block of 8 warps at walk_max 2040, inside the 227 KB a block may ask
// for, at one block an SM where the 32-bit history fits one more.  With a
// sorted table a walk step's 4 successor probes are 4 bucket searches on
// lanes 0-3, an index load and up to bucket_levels loads inside the
// bucket where the bitfield takes one.
#include "sites_common.cuh"

#define WALK_RUN 0
#define WALK_ACCEPT 1
#define WALK_DECLINE 2
#define WALK_CAP 3
#define T3_CAP (1 << 14)
#define MODE_GRAPH 0
#define MODE_GAP 1
#define NO_POS 0x7fffffff

struct WalkCtx {
  const uint8_t* V;  // K1's validity mask (16-byte aligned, CHUNK % 16 == 0)
  int walk_max;
};

// error_len: (j, k-mer after j), engine3.py:1459-1499
template <class T, class P>
__device__ __forceinline__ void err_len_warp(const BrSites<P>& a,
                                             const WalkCtx& w, int i,
                                             T kmer, int lenf, int lane,
                                             int* j_out, T* km_out) {
  const int k = a.k;
  const int rem = lenf - i;
  // lane m: absorb j = m+1 (its k-mer after the codes i+1 .. i+j)
  const T kmj = br_roll_warp(a.codes, a.CHUNK, kmer, i + 1, lane,
                             br_kmask<T>(k));
  const int j = lane + 1;
  const bool hit = lane < k && j < rem && a.probe(kmj, k);
  const uint32_t em = __ballot_sync(BR_FULL, lane < k && (j >= rem || hit));
  const T km_before = __shfl_up_sync(BR_FULL, kmj, 1);
  if (em) {
    const int f = __ffs(em) - 1;
    const T km_hit = __shfl_sync(BR_FULL, kmj, f);
    const T km_end = f == 0 ? kmer : (T)__shfl_sync(BR_FULL, km_before, f);
    *j_out = f + 1;
    *km_out = f + 1 >= rem ? km_end : km_hit;
    return;
  }
  // the next valid position in [i+k+1, min(lenf, CHUNK)), 16 bytes a lane
  const int from = i + k + 1, to = min(lenf, a.CHUNK);
  for (int base = from & ~15; base < to; base += 512) {
    const int p = base + 16 * lane;
    int q = NO_POS;
    if (p < to) {
      const uint4 v = *reinterpret_cast<const uint4*>(w.V + p);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 15; b >= 0; --b) {
        const int x = p + b;
        if (x >= from && x < to && ((words[b >> 2] >> (8 * (b & 3))) & 0xFFu))
          q = x;
      }
    }
    q = __reduce_min_sync(BR_FULL, q);
    if (q != NO_POS) {
      *j_out = q - i;
      *km_out = br_kmer_at<T>(a, q);
      return;
    }
  }
  *j_out = rem;
  int e = rem >= 2 ? i + rem - 1 : i;
  e = e < 0 ? 0 : (e < a.CHUNK ? e : a.CHUNK - 1);
  *km_out = br_kmer_at<T>(a, e);
}

// The walk from corr: status, and (n, wk) after it.  hist is the warp's
// history slice (walk_max+1 words).  Emit words go to erow (when given):
// ceil(n/16) of them, written by lane 0.
template <class T, class P>
__device__ __forceinline__ int walk_warp(const BrSites<P>& a,
                                         const WalkCtx& w,
                                         int lane, T* hist, T corr, T fc,
                                         bool use_fc, int max_steps,
                                         int32_t* erow, int* n_out,
                                         T* wk_out) {
  const int k = a.k;
  const T kmask = br_kmask<T>(k);
  T wk = corr;
  int n = 1, status = WALK_RUN;
  uint32_t cur = (uint32_t)corr & 3u;  // the emit word being filled
  if (lane == 0) hist[0] = corr;
  __syncwarp();
  // tiers 1 and 2: exact history up to walk_max
  while (status == WALK_RUN && (use_fc || n - 1 < max_steps) &&
         n <= w.walk_max) {
    uint32_t sa;
    const int ns = br_alt_next_warp(a.probe, wk, k, kmask, lane, &sa);
    const T wk2 = br_add(wk, sa, kmask);
    bool decline = ns != 1;
    if (!decline) {
      bool seen = false;
      for (int j = lane; j < n; j += 32) seen |= hist[j] == wk2;
      decline = __any_sync(BR_FULL, seen);
    }
    if (lane == 0) hist[n] = wk2;
    __syncwarp();
    cur |= sa << (2 * (n % BR_BPW));
    if (n % BR_BPW == BR_BPW - 1) {
      if (erow && lane == 0) erow[n / BR_BPW] = (int32_t)cur;
      cur = 0;
    }
    status = decline ? WALK_DECLINE
                     : (n >= w.walk_max ? WALK_CAP
                                        : (use_fc && wk2 == fc ? WALK_ACCEPT
                                                               : WALK_RUN));
    wk = wk2;
    ++n;
  }
  if (status != WALK_CAP && n % BR_BPW && erow && lane == 0)
    erow[n / BR_BPW] = (int32_t)cur;
  // tier 3: past walk_max, Brent cycle detection
  if (status == WALK_CAP && !(use_fc && wk == fc)) {
    status = WALK_RUN;
    T saved = wk;
    int lam = 0, power = 1;
    while (status == WALK_RUN) {
      uint32_t sa;
      const int ns = br_alt_next_warp(a.probe, wk, k, kmask, lane, &sa);
      const T wk2 = br_add(wk, sa, kmask);
      const bool accept = use_fc && wk2 == fc;
      const bool done_fill = !use_fc && n >= max_steps;
      if (ns != 1 || wk2 == saved) status = WALK_DECLINE;
      else if (accept || done_fill || n + 1 >= T3_CAP) status = WALK_CAP;
      wk = wk2;
      ++n;
      if (++lam >= power) {
        saved = wk;
        power *= 2;
        lam = 0;
      }
    }
  }
  *n_out = n;
  *wk_out = wk;
  return status;
}

template <class T, class P>
__device__ __forceinline__ BrAttempt<T> walk_attempt(
    const BrSites<P>& a, const WalkCtx& w, int mode, int c, int lane, T* hist,
    int i, T reg, T corr, int lenf, int32_t* erow) {
  int err_len;
  T fc;
  err_len_warp(a, w, i, reg, lenf, lane, &err_len, &fc);
  bool use_fc = true;
  int max_steps = w.walk_max;
  if (mode == MODE_GAP) {
    if (err_len == a.k)
      return br_one_attempt_warp(a, c, i, corr, lenf, erow, lane);
    use_fc = err_len < a.k;
    max_steps = use_fc ? 0 : err_len - a.k;
  }
  int n;
  T wk;
  const int st = walk_warp(a, w, lane, hist, corr, fc, use_fc, max_steps,
                           erow, &n, &wk);
  BrAttempt<T> r;
  r.new_kmer = wk;
  r.ok = use_fc ? st == WALK_ACCEPT : st == WALK_RUN;
  r.cap = st == WALK_CAP;
  r.cnt = n;
  r.consumed = use_fc ? err_len + 1 : n;
  return r;
}

template <class T, class P, bool G>
__global__ void __launch_bounds__(BR_SITE_THREADS)
    walk_sites_kernel(BrSites<P> a, WalkCtx w, int mode, int c) {
  // BR_WARP_SITES x (walk_max+1) k-mers of type T
  extern __shared__ __align__(8) unsigned char sh_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sid = blockIdx.x * BR_WARP_SITES + warp;
  if (sid >= a.NS) return;
  if constexpr (G) a = br_sites_chunk<T>(a);
  if constexpr (G) w.V += (size_t)blockIdx.y * a.CHUNK;
  T* hist = reinterpret_cast<T*>(sh_raw) + (size_t)warp * (w.walk_max + 1);
  auto attempt = [&](int i, T reg, T corr, int lenf, int32_t* erow) {
    return walk_attempt<T>(a, w, mode, c, lane, hist, i, reg, corr, lenf,
                           erow);
  };
  br_site_chain_warp<T>(a, sid, lane, attempt);
}

template <class T, class P>
static int walk_sites_launch(
    int NC, const void* codes, P probe, const void* kmers,
    const void* V, const void* s_pos, const void* n_sites,
    const void* rstart, const void* rlen, int CHUNK, int R, int k, int c,
    int NS, int mode, int walk_max, int EW, void* succ, void* s_cap,
    void* rec_p, void* rec_c, void* rec_s, void* rec_e, void* stream) {
  BrSites<P> a = br_sites_args(codes, probe, kmers, s_pos, n_sites, rstart,
                               rlen, CHUNK, R, k, NS, EW, succ, s_cap, rec_p,
                               rec_c, rec_s, rec_e);
  WalkCtx w;
  w.V = (const uint8_t*)V;
  w.walk_max = walk_max;
  const size_t smem = (size_t)BR_WARP_SITES * (walk_max + 1) * sizeof(T);
  auto kern = NC > 1 ? &walk_sites_kernel<T, P, true>
                     : &walk_sites_kernel<T, P, false>;
  // above 48 KB of dynamic shared memory a kernel has to ask for it
  static size_t granted[2] = {48 * 1024, 48 * 1024};
  if (smem > granted[NC > 1]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted[NC > 1] = smem;
  }
  kern<<<br_warp_site_grid(NS, BR_WARP_SITES, NC), BR_SITE_THREADS, smem,
         (cudaStream_t)stream>>>(a, w, mode, c);
  return (int)cudaGetLastError();
}

#define WALK_ARGS                                                         \
  int NC, const void *codes, const void *table, const void *kmers,      \
      const void *V, const void *s_pos, const void *n_sites,              \
      const void *rstart, const void *rlen, int CHUNK, int R, int k,      \
      int c, int NS, int mode,                                            \
      int walk_max, int EW, void *succ, void *s_cap, void *rec_p,         \
      void *rec_c, void *rec_s, void *rec_e
#define WALK_LAUNCH(T, probe)                                             \
  walk_sites_launch<T>(NC, codes, probe, kmers, V, s_pos, n_sites,        \
                       rstart, rlen, CHUNK, R, k, c, NS, mode, walk_max,  \
                       EW, succ, s_cap, rec_p, rec_c, rec_s, rec_e,       \
                       stream)

BR_SITE_ENTRIES(br_walk_sites, WALK_ARGS, WALK_LAUNCH)
