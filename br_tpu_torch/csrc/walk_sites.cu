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
// read.  JAX reads that from nv, a reverse cummin over the chunk; here
// the thread scans K1's V mask forward from i+k+1 to the read end.  That
// costs the length of the error stretch, which the walk that follows
// costs again, and it spares K1 a reverse scan across tiles for every
// pass when only the walk passes need it.  The k-mer there comes from
// K1's kmers.
//
// The walk, from the gated alternative: each step probes the 4
// successors; a branch (not exactly one) or a revisit DECLINEs, reaching
// first_correct ACCEPTs (graph mode), walking max_steps completes a fill
// (fill mode), and the step taken at walk_max CAPs, CAP outranking ACCEPT
// (:1020-1022).  The JAX tiers keep the full history up to walk_max, so
// revisits are exact there; the port keeps the same history per thread:
// walk_max+1 k-mers (249 by default, 2041 in the wide profile) in a
// scratch the wrapper allocates, laid out [step][site] so a warp's
// threads at equal steps touch one line, and searched linearly: O(n^2)
// per walk, paid only by the rare walk that runs long.  Past walk_max the
// walk goes on as _brent_walk32 does: a branch or a Brent cycle DECLINEs
// (and the site is not capped); arriving at first_correct, completing a
// fill or passing T3_CAP stays CAP; a graph walk that capped exactly on
// first_correct stays CAP (:1163-1167).  Emit: word 0 holds the
// alternative's base, step n writes bits 2*(n%16) of word n/16; cnt = n;
// consumed is err_len+1 for graph, n for a fill (:1222-1224).
// gap-size dispatches on err_len (gap_size.rs:97-108): graph mode below
// k, the One attempt of sites_common.cuh at k, a fill of err_len-k steps
// above.
//
// One thread per site, the site chain of sites_common.cuh.  The JAX
// capacities with no counterpart: the queue's generations (NQA, MAXB ->
// CAP_ROUNDS), tier 2's lanes per round (NW2) and tier 3's lanes (NW3 =
// BLK): each thread walks its own site to the end.
//
// Bound on the H100: the walks' probes, 4 independent bitfield reads from
// L2 per step and a chain of dependent steps per thread: latency.  The
// design issues a step's 4 probes together, searches the history only on
// a step that did not branch, and lets the threads of long walks run on
// while the others retire.
#include "sites_common.cuh"

#define WALK_RUN 0
#define WALK_ACCEPT 1
#define WALK_DECLINE 2
#define WALK_CAP 3
#define T3_CAP (1 << 14)
#define MODE_GRAPH 0
#define MODE_GAP 1

struct WalkCtx {
  const uint8_t* V;    // K1's validity mask
  uint32_t* hist;      // (walk_max+1, NS) walked k-mers, [step][site]
  int walk_max;
};

// error_len: (j, k-mer after j), engine3.py:1459-1499
__device__ __forceinline__ void err_len_of(const BrSites& a, const WalkCtx& w,
                                           int i, uint32_t kmer, int lenf,
                                           int* j_out, uint32_t* km_out) {
  const int k = a.k;
  const uint32_t kmask = br_kmask(k);
  const int rem = lenf - i;
  uint32_t km = kmer;
  for (int j = 1; j <= k; ++j) {
    if (j >= rem) { *j_out = j; *km_out = km; return; }
    km = br_add(km, code_at(a.codes, i + j, a.CHUNK), kmask);
    if (br_probe(a.table, km, k)) { *j_out = j; *km_out = km; return; }
  }
  const int to = min(lenf, a.CHUNK);
  for (int q = i + k + 1; q < to; ++q) {
    if (w.V[q]) { *j_out = q - i; *km_out = (uint32_t)a.kmers[q]; return; }
  }
  *j_out = rem;
  int e = rem >= 2 ? i + rem - 1 : i;
  e = e < 0 ? 0 : (e < a.CHUNK ? e : a.CHUNK - 1);
  *km_out = (uint32_t)a.kmers[e];
}

// The walk from corr: status, and (n, wk) after it.  Emit words go to
// erow (when given): ceil(n/16) of them.
__device__ int walk(const BrSites& a, const WalkCtx& w, int sid,
                    uint32_t corr, uint32_t fc, bool use_fc, int max_steps,
                    int32_t* erow, int* n_out, uint32_t* wk_out) {
  const int k = a.k;
  const uint32_t kmask = br_kmask(k);
  uint32_t* hist = w.hist + sid;
  const size_t hs = (size_t)a.NS;
  uint32_t wk = corr;
  int n = 1, status = WALK_RUN;
  uint32_t cur = corr & 3u;  // the emit word being filled
  hist[0] = corr;
  // tiers 1 and 2: exact history up to walk_max
  while (status == WALK_RUN && (use_fc || n - 1 < max_steps) &&
         n <= w.walk_max) {
    uint32_t sa;
    const int ns = br_alt_next(a.table, wk, k, kmask, &sa);
    const uint32_t wk2 = br_add(wk, sa, kmask);
    bool decline = ns != 1;
    if (!decline) {
      for (int j = 0; j < n; ++j) {
        if (hist[j * hs] == wk2) { decline = true; break; }
      }
    }
    hist[n * hs] = wk2;
    cur |= sa << (2 * (n % BR_BPW));
    if (n % BR_BPW == BR_BPW - 1) {
      if (erow) erow[n / BR_BPW] = (int32_t)cur;
      cur = 0;
    }
    status = decline ? WALK_DECLINE
                     : (n >= w.walk_max ? WALK_CAP
                                        : (use_fc && wk2 == fc ? WALK_ACCEPT
                                                               : WALK_RUN));
    wk = wk2;
    ++n;
  }
  if (status != WALK_CAP && n % BR_BPW && erow) erow[n / BR_BPW] = (int32_t)cur;
  // tier 3: past walk_max, Brent cycle detection
  if (status == WALK_CAP && !(use_fc && wk == fc)) {
    status = WALK_RUN;
    uint32_t saved = wk;
    int lam = 0, power = 1;
    while (status == WALK_RUN) {
      uint32_t sa;
      const int ns = br_alt_next(a.table, wk, k, kmask, &sa);
      const uint32_t wk2 = br_add(wk, sa, kmask);
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

__device__ __forceinline__ BrAttempt walk_attempt(const BrSites& a,
                                                  const WalkCtx& w, int mode,
                                                  int c, int sid, int i,
                                                  uint32_t reg, uint32_t corr,
                                                  int lenf, int32_t* erow) {
  int err_len;
  uint32_t fc;
  err_len_of(a, w, i, reg, lenf, &err_len, &fc);
  bool use_fc = true;
  int max_steps = w.walk_max;
  if (mode == MODE_GAP) {
    if (err_len == a.k) return br_one_attempt(a, c, i, corr, lenf, erow);
    use_fc = err_len < a.k;
    max_steps = use_fc ? 0 : err_len - a.k;
  }
  BrAttempt r;
  int n;
  const int st = walk(a, w, sid, corr, fc, use_fc, max_steps, erow, &n,
                      &r.new_kmer);
  r.ok = use_fc ? st == WALK_ACCEPT : st == WALK_RUN;
  r.cap = st == WALK_CAP;
  r.cnt = n;
  r.consumed = use_fc ? err_len + 1 : n;
  return r;
}

__global__ void __launch_bounds__(BR_SITE_THREADS)
    walk_sites_kernel(BrSites a, WalkCtx w, int mode, int c) {
  __shared__ int32_t sh_start[BR_MAX_R];
  __shared__ int32_t sh_len[BR_MAX_R];
  br_stage_slots(a, sh_start, sh_len);
  const int sid = blockIdx.x * BR_SITE_THREADS + threadIdx.x;
  if (sid >= a.NS) return;
  auto attempt = [&](int i, uint32_t reg, uint32_t corr, int lenf,
                     int32_t* erow) {
    return walk_attempt(a, w, mode, c, sid, i, reg, corr, lenf, erow);
  };
  br_site_chain(a, sid, sh_start, sh_len, attempt);
}

extern "C" int br_walk_sites(
    const void* codes, const void* table, const void* kmers,
    const void* V, const void* s_pos, const void* n_sites,
    const void* rstart, const void* rlen, int CHUNK, int R, int k, int c,
    int NS, int mode, int walk_max, int EW, void* hist, void* succ,
    void* s_cap, void* rec_p, void* rec_c, void* rec_s, void* rec_e,
    void* stream) {
  BrSites a = br_sites_args(codes, table, kmers, s_pos, n_sites, rstart,
                            rlen, CHUNK, R, k, NS, EW, succ, s_cap, rec_p,
                            rec_c, rec_s, rec_e);
  WalkCtx w;
  w.V = (const uint8_t*)V;
  w.hist = (uint32_t*)hist;
  w.walk_max = walk_max;
  walk_sites_kernel<<<br_site_blocks(NS), BR_SITE_THREADS, 0,
                      (cudaStream_t)stream>>>(a, w, mode, c);
  return (int)cudaGetLastError();
}
