// K7 greedy_sites: every attempt site of a `greedy` pass, with its whole
// chain of nested repairs.
//
// Replaces: the site-block queue of br_tpu/correct/engine3.py:1592-1708
// for strategy "greedy", whose attempt is make_greedy_attempt32_arr
// (:719-965, bit-identical to make_greedy_attempt32, :493-716), and the
// global alignment it runs, global_align_ops (br_tpu/correct/
// alignment.py:32: rust-bio's Gotoh aligner with match +1, mismatch -1,
// gap open -1, gap extend -1).
//
// The attempt (greedy.rs:129-173): an ms-step unique-successor walk from
// the gated alternative (a branch or a revisit of the walk's own k-mers
// fails that step, :750-770); then one three-layer Gotoh DP of
// r = before + read[i .. i+ms-2] against c = before + path (before: the
// k-1 bases of the register ahead of the error), (k-1+ms) x (k-1+ms+2)
// cells, 19 x 21 at k = 13, ms = 7.  A DP over whole strings holds the DP
// of every prefix, so step `it`'s alignment is the traceback from cell
// (k-1+it, k-1+it+2).  rust-bio's tie-breaks (alignment.py:1-18): in a
// cell Match/Subst before Ins before Del, and a gap layer opens from S on
// a tie with extending.  The first step that fails, runs out of read, or
// finds two consecutive Matches past the before bases with its nb = c
// validation probes solid decides; the offset rule of reference.py:
// 524-552 gives consumed = cnt + offset, and a negative one caps the site
// (CAP_ATTEMPT, as :700-702).
//
// One warp per site runs the warp site chain of sites_common.cuh (NS
// warps, BR_WARP_SITES a block).  The JAX queue's generation capacities
// have no counterpart.  JAX refuses ms + 1 > 16 (one emit word,
// :726-727); so does the wrapper.
//
// Three instantiations from one source: br_greedy_sites (uint32_t, a
// bitfield at k <= 15), br_greedy_sites64 (uint64_t, a bitfield at
// k = 17) and br_greedy_sites_h (uint64_t, a HashSet's sorted table at any
// k <= 31).  At k = 31 the DP has Lc + 1 = k + 2 + it_max columns, 40 at
// ms = 7 and 47 at ms = 15, and up to 45 rows: the sorted instantiation
// gives each lane two groups of 32 (G = 2), columns j + 1 and j + 33 and
// rows j and j + 32; group 1's lane 0 takes its left neighbour from group
// 0's lane 31, which on the anti-diagonal is the same shuffle distance,
// so the wavefront runs Lr + Lc steps as before.  At k = 17 the DP
// has Lc + 1 = ms + 18 columns, 33 at ms = 15, one more than a warp has
// lanes: there lane j owns column j + 1 (COL0 = 1), and column 0, whose
// cells are closed-form (the Ins run from the start), is computed by lane
// 0 where it needs its left neighbour, and written to the traceback table
// by lane 0 as the wavefront passes its rows.  Written instead by a loop
// of all lanes before the wavefront, `for (r = lane; r <= Lr; r += 32)`,
// the stores faulted: a build that printed them showed rows r = lane + 96
// at Lr = 22 (nvcc 12.9 ran the loop's four-times-unrolled body where its
// trip count was 1); the same loop with Lr broadcast from lane 0 by a
// shuffle ran right.  So no loop here is bounded by a lane's own Lr or
// Lc: the wavefront's step count is lane 0's too.  At k <= 15
// (Lc + 1 <= 30) lane j owns column j, as before.
//
// Bound on the H100: a chain of dependent steps (the walk's ms probe
// rounds, the DP's cells, a traceback of up to ~58 cells) per attempt,
// not bytes.  The warp shortens each:
//  - the walk stays serial, its 4 probes a step on lanes 0-3; lane p
//    holds wks[p] and path[p], and the revisit test is one vote; the walk
//    stops at its first failure, after which no step can decide;
//  - the DP runs as an anti-diagonal wavefront, lane j owning column j
//    (Lc + 1 <= 30 lanes at k <= 15; column j + 1 at k = 17, below):
//    S, I, D and the S code of the left column come
//    by __shfl_up_sync, the diagonal S is the left lane's previous one;
//    Lr + Lc + 1 steps in place of Lr * Lc serial cells, and only the rows
//    and columns the deciding steps can reach (it < min(fail_step,
//    rem + 1));
//  - the traceback codes go to the warp's slice of shared memory
//    (<= 1.8 KB, 2 KB at k = 17, 4.2 KB with the sorted table), not
//    local memory;
//  - lanes it = 0..ms-1 trace back from cell (k-1+it, k-1+it+2) at once,
//    each in registers only: a delay line of the last k-1 ops holds back
//    the before-part, so the first Match pair past it and the offset come
//    out in one backward pass; each lane then sends its nb validation
//    probes, and a ballot takes the smallest deciding it: the serial
//    loop's answer in one traceback time.
#include "sites_common.cuh"

#define OP_MATCH 0
#define OP_SUBST 1
#define OP_DEL 2
#define OP_INS 3
#define TB_START 4
#define GAP_OPEN (-1)
#define GAP_EXT (-1)
#define NEG_SCORE (-(1 << 14))
// ms + 1 <= 16, and k - 1 <= KM1 = 14 (uint32_t), 16 (uint64_t with the
// bitfield) or 30 (the sorted table): br_lag, the instantiation's largest
// k less one
#define MAX_MS 15
template <class T, class P>
__host__ __device__ constexpr int greedy_max_lr() {
  return br_lag<T, P>() + MAX_MS - 1;
}
template <class T, class P>
__host__ __device__ constexpr int greedy_max_lc() {
  return br_lag<T, P>() + MAX_MS + 1;
}

// traceback codes of a cell: S layer in bits 0-2, I in 3-5, D in 6-8
#define TB(s, i, d) ((uint16_t)((s) | ((i) << 3) | ((d) << 6)))
#define TB_S(x) ((x) & 7)
#define TB_I(x) (((x) >> 3) & 7)
#define TB_D(x) (((x) >> 6) & 7)

// traceback codes of one warp's DP: (MAX_LR+1) x (MAX_LC+1), padded
template <class T, class P>
__host__ __device__ constexpr int greedy_tb_words() {
  return (greedy_max_lr<T, P>() + 1) * (greedy_max_lc<T, P>() + 1) + 5;
}

// The offset of step it's alignment, by the lane that traces it back from
// (r, j) through tb (NC columns): whether two consecutive Matches follow
// the first k-1 (before) ops, and the offset of reference.py:534-551.
// The traceback yields ops from the last to the first.  An op is "past
// the before part" (forward index >= k-1) once k-1 more ops follow it,
// so the last k-1 ops seen wait in a 2-bit delay line; each op leaving it
// is checked against the op that left before it (the next one forward),
// and the last such Match pair found is the first one forward.  offset
// sums the indels past the before part up to that pair; corr, the
// indels that end the alignment, is the leading run of the backward ops.
// The delay line is of type T: 2(k-1) = 32 bits at k = 17, 60 at k = 31.
// WORDS is the traceback table's size (the checked build's bound).
template <class T, int WORDS>
__device__ __forceinline__ bool greedy_offset(const uint16_t* tb, int NC,
                                              int k, int r, int j,
                                              int* off) {
  const int dl = k - 1;
  const T dmask = (T(1) << (2 * dl)) - T(1);
  T line = 0;
  int nline = 0, prev = -1, sum = 0, sum_at = 0, corr = 0;
  bool found = false, lead = true;
  // every op moves up or left (r + j falls), so the walk ends if it
  // stays in the table
#define GREEDY_TB_CHECK()                                                 \
  BR_CHECK(r >= 0 && j >= 0 && j < NC &&                                 \
           r * NC + j < WORDS - 5)
  GREEDY_TB_CHECK();
  int layer = TB_S(tb[r * NC + j]);
  while (layer != TB_START) {
    BR_CHECK(layer < TB_START);
    GREEDY_TB_CHECK();
    const int op = layer;
    if (lead) {
      if (op == OP_INS) ++corr;
      else if (op == OP_DEL) --corr;
      else lead = false;
    }
    int past = op;  // the op whose forward index is now known >= k-1
    if (dl > 0) {
      past = nline == dl ? (int)((line >> (2 * (dl - 1))) & 3u) : -1;
      if (nline < dl) ++nline;
      line = ((line << 2) | (T)op) & dmask;
    }
    if (past >= 0) {
      if (past == OP_MATCH && prev == OP_MATCH) {
        found = true;
        sum_at = sum;
      }
      sum += past == OP_INS ? 1 : (past == OP_DEL ? -1 : 0);
      prev = past;
    }
    if (op == OP_INS) {
      layer = TB_I(tb[r * NC + j]);
      --r;
    } else if (op == OP_DEL) {
      layer = TB_D(tb[r * NC + j]);
      --j;
    } else {
      --r;
      --j;
      GREEDY_TB_CHECK();
      layer = TB_S(tb[r * NC + j]);
    }
  }
#undef GREEDY_TB_CHECK
  *off = (sum - sum_at) - corr;
  return found;
}

template <class T, class P>
__device__ __forceinline__ BrAttempt<T> greedy_attempt(
    const BrSites<P>& a, int ms, int nb, int lane, uint16_t* tb, int i, T reg,
    T corr, int lenf, int32_t* erow) {
  // the column of lane 0: 1 where Lc + 1 can pass 32 (k >= 17)
  constexpr int COL0 = sizeof(T) == 8 ? 1 : 0;
  // the groups of 32 columns (and of 32 rows) a lane owns: two where Lc
  // can pass 32 + COL0 (a sorted table: k <= 31, Lc <= 46)
  constexpr int G = greedy_max_lc<T, P>() > 32 ? 2 : 1;
  constexpr int WORDS = greedy_tb_words<T, P>();
  const int k = a.k;
  const T kmask = br_kmask<T>(k);
  const int rem = lenf - i;
  BrAttempt<T> res = {false, false, T(0), 0, 0};

  // the ms-step walk: lane p holds wks[p] and path[p]
  T my_wk = corr, wk = corr;
  uint32_t my_path = (uint32_t)corr & 3u;
  int fail_step = ms;
  for (int s = 0; s < ms; ++s) {
    uint32_t sa;
    const int ns = br_alt_next_warp(a.probe, wk, k, kmask, lane, &sa);
    const bool bf = ns != 1;
    const T nxt = bf ? wk : br_add(wk, sa, kmask);
    const bool revisit =
        __any_sync(BR_FULL, lane <= s && my_wk == nxt);
    if (lane == s + 1) {
      my_wk = nxt;
      my_path = sa;
    }
    wk = nxt;
    if (bf || revisit) {  // no step from here on decides
      fail_step = s;
      break;
    }
  }
  // the deciding steps: it <= it_max
  const int it_max = min(min(ms - 1, fail_step - 1), rem);
  if (it_max < 0) return res;

  // the DP of r_full (rows) against c_full (columns), rows 0..Lr and
  // columns 0..Lc as far as the deciding steps reach
  const int Lr = k - 1 + it_max, Lc = k + 1 + it_max, NC = Lc + 1;
  const T pre = reg >> 2;
  // lane t: x[t + 32g], the base of row t + 32g + 1; lane j - COL0 - 32g:
  // y[j-1], the base of its column j of group g
  uint32_t xl[G], yj[G];
  int jg[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int t = lane + 32 * g;
    xl[g] = t < k - 1 ? (uint32_t)(pre >> (2 * (k - 2 - t))) & 3u
                      : code_at(a.codes, i + t - (k - 1), a.CHUNK);
    const int j = lane + COL0 + 32 * g;
    const uint32_t pth = __shfl_sync(BR_FULL, my_path, (j - k) & 31);
    jg[g] = j;
    yj[g] = j == 0 ? 0u
            : j - 1 < k - 1
                ? (uint32_t)(pre >> (2 * (k - 2 - (j - 1)))) & 3u
                : pth;
  }
  int S[G], Sold[G], I[G], D[G], sb[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    S[g] = 0;
    Sold[g] = 0;
    I[g] = NEG_SCORE;
    D[g] = NEG_SCORE;
    sb[g] = TB_START;
  }
  // the step count comes from lane 0 and the loop stays rolled: written
  // as `d <= Lr + Lc`, nvcc (12.9, sm_90a) cut this loop after 11 steps
  // (a loop bound by a lane's own Lr miscompiles, see the header)
  const int steps = __shfl_sync(BR_FULL, Lr + Lc + 1 - COL0, 0);
#pragma unroll 1
  for (int d = 0; d < steps; ++d) {
    // every left neighbour before any cell of this step is written
    int lS[G], lSold[G], lD[G], lsb[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      lS[g] = __shfl_up_sync(BR_FULL, S[g], 1);
      lSold[g] = __shfl_up_sync(BR_FULL, Sold[g], 1);
      lD[g] = __shfl_up_sync(BR_FULL, D[g], 1);
      lsb[g] = __shfl_up_sync(BR_FULL, sb[g], 1);
    }
    if constexpr (G == 2) {  // group 1's lane 0: group 0's lane 31
      const int tS = __shfl_sync(BR_FULL, S[0], 31);
      const int tSold = __shfl_sync(BR_FULL, Sold[0], 31);
      const int tD = __shfl_sync(BR_FULL, D[0], 31);
      const int tsb = __shfl_sync(BR_FULL, sb[0], 31);
      if (lane == 0) {
        lS[1] = tS;
        lSold[1] = tSold;
        lD[1] = tD;
        lsb[1] = tsb;
      }
    }
    if constexpr (COL0 == 1) {
      if (lane == 0) {  // column 0 (Ins from the start): its cell at row
        // r, and the left neighbour of column 1 at rows r and r-1
        const int r = d;
        BR_CHECK(r > Lr || r * NC < WORDS - 5);
        if (r <= Lr)
          tb[r * NC] = r == 0 ? TB(TB_START, TB_START, TB_START)
                              : TB(OP_INS, r > 1 ? OP_INS : TB_START,
                                   TB_START);
        lS[0] = r == 0 ? 0 : GAP_OPEN + GAP_EXT * r;
        lSold[0] = r <= 1 ? 0 : GAP_OPEN + GAP_EXT * (r - 1);
        lD[0] = NEG_SCORE;
        lsb[0] = r == 0 ? TB_START : OP_INS;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = d - lane - 32 * g, j = jg[g];
      uint32_t xr = __shfl_sync(BR_FULL, xl[0], (r - 1) & 31);
      if constexpr (G == 2) {
        const uint32_t x1 = __shfl_sync(BR_FULL, xl[1], (r - 1) & 31);
        if (r - 1 >= 32) xr = x1;
      }
      if (j <= Lc && r >= 0 && r <= Lr) {
        int nS, nI, nD, nsb;
        uint16_t code;
        if (r == 0) {  // the first row: Del from the start
          nS = j == 0 ? 0 : GAP_OPEN + GAP_EXT * j;
          nI = NEG_SCORE;
          nD = NEG_SCORE;
          nsb = j == 0 ? TB_START : OP_DEL;
          code = TB(nsb, TB_START, j > 1 ? OP_DEL : TB_START);
        } else if (j == 0) {  // the first column: Ins from the start
          nS = GAP_OPEN + GAP_EXT * r;
          nI = nS;
          nD = NEG_SCORE;
          nsb = OP_INS;
          code = TB(OP_INS, r > 1 ? OP_INS : TB_START, TB_START);
        } else {
          // Ins: consume x against a gap (from row r-1, this lane's cell)
          int ext = I[g] + GAP_EXT, opn = S[g] + GAP_OPEN + GAP_EXT;
          nI = ext > opn ? ext : opn;
          const int ib = ext > opn ? OP_INS : sb[g];
          // Del: consume y against a gap (from column j-1, the left lane)
          ext = lD[g] + GAP_EXT;
          opn = lS[g] + GAP_OPEN + GAP_EXT;
          nD = ext > opn ? ext : opn;
          const int db = ext > opn ? OP_DEL : lsb[g];
          const bool m = xr == yj[g];
          int best = lSold[g] + (m ? 1 : -1);
          nsb = m ? OP_MATCH : OP_SUBST;
          if (nI > best) { best = nI; nsb = OP_INS; }
          if (nD > best) { best = nD; nsb = OP_DEL; }
          nS = best;
          code = TB(nsb, ib, db);
        }
        BR_CHECK(r * NC + j < WORDS - 5);
        tb[r * NC + j] = code;
        Sold[g] = S[g];
        S[g] = nS;
        I[g] = nI;
        D[g] = nD;
        sb[g] = nsb;
      }
    }
  }
  __syncwarp();

  // every deciding step at once: lane it traces back and validates
  const T wnext = __shfl_sync(BR_FULL, my_wk, (lane + 1) & 31);
  bool good = false;
  int off = 0;
  if (lane <= it_max &&
      greedy_offset<T, WORDS>(tb, NC, k, k - 1 + lane, k + 1 + lane,
                              &off)) {
    bool okc = rem - lane >= nb;
    T km = wnext;
#pragma unroll 4
    for (int t = 0; t < nb; ++t) {
      km = br_add(km, code_at(a.codes, i + lane + t, a.CHUNK), kmask);
      okc &= a.probe(km, k);
    }
    good = okc;
  }
  __syncwarp();  // the next attempt overwrites tb
  const uint32_t gm = __ballot_sync(BR_FULL, good);
  if (!gm) return res;
  const int it_sel = __ffs(gm) - 1;
  const int o = __shfl_sync(BR_FULL, off, it_sel);
  const T nk = __shfl_sync(BR_FULL, my_wk, it_sel + 1);
  const int cnt = it_sel + 2;
  const int raw = cnt + o;
  const uint32_t emit =
      __reduce_or_sync(BR_FULL, lane < cnt ? my_path << (2 * lane) : 0u);
  res.ok = true;
  res.cap = raw < 0;
  res.consumed = raw < 0 ? 0 : raw;
  res.cnt = cnt;
  res.new_kmer = nk;
  if (erow && lane == 0) erow[0] = (int32_t)emit;
  return res;
}

template <class T, class P, bool G>
__global__ void __launch_bounds__(BR_SITE_THREADS)
    greedy_sites_kernel(BrSites<P> a, int ms, int nb) {
  __shared__ uint16_t sh_tb[BR_WARP_SITES][greedy_tb_words<T, P>()];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sid = blockIdx.x * BR_WARP_SITES + warp;
  if (sid >= a.NS) return;
  if constexpr (G) a = br_sites_chunk<T>(a);
  uint16_t* tb = sh_tb[warp];
  auto attempt = [&](int i, T reg, T corr, int lenf, int32_t* erow) {
    return greedy_attempt<T>(a, ms, nb, lane, tb, i, reg, corr, lenf,
                             erow);
  };
  br_site_chain_warp<T>(a, sid, lane, attempt);
}

template <class T, class P>
static int greedy_sites_launch(
    int NC, const void* codes, P probe, const void* kmers,
    const void* s_pos, const void* n_sites, const void* rstart,
    const void* rlen, int CHUNK, int R, int k, int ms, int nb, int NS,
    void* succ, void* s_cap, void* rec_p, void* rec_c, void* rec_s,
    void* rec_e, void* stream) {
  BrSites<P> a = br_sites_args(codes, probe, kmers, s_pos, n_sites, rstart,
                               rlen, CHUNK, R, k, NS, 1, succ, s_cap, rec_p,
                               rec_c, rec_s, rec_e);
  auto kern = NC > 1 ? &greedy_sites_kernel<T, P, true>
                     : &greedy_sites_kernel<T, P, false>;
  kern<<<br_warp_site_grid(NS, BR_WARP_SITES, NC), BR_SITE_THREADS, 0,
         (cudaStream_t)stream>>>(a, ms, nb);
  return (int)cudaGetLastError();
}

#define GREEDY_ARGS                                                       \
  int NC, const void *codes, const void *table, const void *kmers,      \
      const void *s_pos, const void *n_sites, const void *rstart,         \
      const void *rlen, int CHUNK, int R, int k, int ms, int nb, int NS,  \
      void *succ, void *s_cap, void *rec_p, void *rec_c, void *rec_s,     \
      void *rec_e
#define GREEDY_LAUNCH(T, probe)                                           \
  greedy_sites_launch<T>(NC, codes, probe, kmers, s_pos, n_sites,         \
                         rstart, rlen, CHUNK, R, k, ms, nb, NS, succ,     \
                         s_cap, rec_p, rec_c, rec_s, rec_e, stream)

BR_SITE_ENTRIES(br_greedy_sites, GREEDY_ARGS, GREEDY_LAUNCH)
