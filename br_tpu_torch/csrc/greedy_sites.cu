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
// One thread per site runs the site chain of sites_common.cuh; the
// thread's DP keeps two score rows in registers and the traceback codes
// of every cell (3 x 3 bits) in 16-bit local memory.  The JAX queue's
// generation capacities have no counterpart.  JAX refuses ms + 1 > 16
// (one emit word, :726-727); so does the wrapper.
//
// Bound on the H100: the DP's operations, ~400 cells x ~12 integer ops
// per attempt, and the walk's 4*ms dependent probes.  The design runs the
// traceback only for the steps up to the first event (a failure or an
// accept), and keeps the DP rows in registers.
#include "sites_common.cuh"

#define OP_MATCH 0
#define OP_SUBST 1
#define OP_DEL 2
#define OP_INS 3
#define TB_START 4
#define GAP_OPEN (-1)
#define GAP_EXT (-1)
#define NEG_SCORE (-(1 << 14))
// ms + 1 <= 16 and k <= 15
#define MAX_MS 15
#define MAX_LR (14 + MAX_MS - 1)
#define MAX_LC (14 + MAX_MS + 1)

// traceback codes of a cell: S layer in bits 0-2, I in 3-5, D in 6-8
#define TB(s, i, d) ((uint16_t)((s) | ((i) << 3) | ((d) << 6)))
#define TB_S(x) ((x) & 7)
#define TB_I(x) (((x) >> 3) & 7)
#define TB_D(x) (((x) >> 6) & 7)

// The alignment of step `it`: whether two consecutive Matches follow the
// before bases, and the offset of reference.py:534-551.
__device__ __forceinline__ bool greedy_offset(const uint16_t* tb, int NC,
                                              int k, int it, int* off) {
  int ops[MAX_LR + MAX_LC];
  int r = k - 1 + it, j = k - 1 + it + 2, nops = 0;
  int layer = TB_S(tb[r * NC + j]);
  while (layer != TB_START) {
    ops[nops++] = layer;
    if (layer == OP_INS) {
      layer = TB_I(tb[r * NC + j]);
      --r;
    } else if (layer == OP_DEL) {
      layer = TB_D(tb[r * NC + j]);
      --j;
    } else {
      --r;
      --j;
      layer = TB_S(tb[r * NC + j]);
    }
  }
  // ops[] is reversed: forward op w is ops[nops-1-w]
  int offset = 0;
  bool exists = false;
  for (int w = k - 1; w + 1 <= nops - 1; ++w) {
    const int op0 = ops[nops - 1 - w], op1 = ops[nops - 2 - w];
    if (op0 == OP_MATCH && op1 == OP_MATCH) { exists = true; break; }
    offset += op0 == OP_INS ? 1 : (op0 == OP_DEL ? -1 : 0);
  }
  if (!exists) return false;
  int corr = 0;
  for (int t = 0; t < nops; ++t) {
    if (ops[t] == OP_INS) ++corr;
    else if (ops[t] == OP_DEL) --corr;
    else break;
  }
  *off = offset - corr;
  return true;
}

__device__ __forceinline__ BrAttempt greedy_attempt(const BrSites& a, int ms,
                                                    int nb, int i,
                                                    uint32_t reg,
                                                    uint32_t corr, int lenf,
                                                    int32_t* erow) {
  const int k = a.k;
  const uint32_t kmask = br_kmask(k);
  const int rem = lenf - i;
  BrAttempt res = {false, false, 0u, 0, 0};

  // the ms-step walk
  uint32_t wks[MAX_MS + 1];
  uint8_t path[MAX_MS + 1];
  wks[0] = corr;
  path[0] = corr & 3u;
  int fail_step = ms;
  for (int s = 0; s < ms; ++s) {
    uint32_t sa;
    const int ns = br_alt_next(a.table, wks[s], k, kmask, &sa);
    const bool bf = ns != 1;
    const uint32_t nxt = bf ? wks[s] : br_add(wks[s], sa, kmask);
    bool revisit = false;
    for (int p = 0; p <= s; ++p) revisit |= nxt == wks[p];
    if (fail_step == ms && (bf || revisit)) fail_step = s;
    wks[s + 1] = nxt;
    path[s + 1] = (uint8_t)sa;
  }

  // the DP of r_full (rows) against c_full (columns)
  const int Lr = k - 1 + ms - 1, Lc = k - 1 + ms + 1, NC = Lc + 1;
  uint8_t x[MAX_LR], y[MAX_LC];
  const uint32_t pre = reg >> 2;
  for (int t = 0; t < k - 1; ++t) {
    x[t] = y[t] = (pre >> (2 * (k - 2 - t))) & 3u;
  }
  for (int t = 0; t < ms - 1; ++t)
    x[k - 1 + t] = code_at(a.codes, i + t, a.CHUNK);
  for (int t = 0; t <= ms; ++t) y[k - 1 + t] = path[t];

  uint16_t tb[(MAX_LR + 1) * (MAX_LC + 1)];
  int S[MAX_LC + 1], I[MAX_LC + 1];
  S[0] = 0;
  I[0] = NEG_SCORE;
  tb[0] = TB(TB_START, TB_START, TB_START);
  for (int j = 1; j <= Lc; ++j) {
    S[j] = GAP_OPEN + GAP_EXT * j;
    I[j] = NEG_SCORE;
    tb[j] = TB(OP_DEL, TB_START, j > 1 ? OP_DEL : TB_START);
  }
  for (int r = 1; r <= Lr; ++r) {
    const uint8_t xi = x[r - 1];
    const uint16_t* up = tb + (r - 1) * NC;
    uint16_t* row = tb + r * NC;
    int diag = S[0];  // S[r-1][j-1]
    S[0] = GAP_OPEN + GAP_EXT * r;
    I[0] = S[0];
    int D = NEG_SCORE;
    int sb_left = OP_INS;
    row[0] = TB(OP_INS, r > 1 ? OP_INS : TB_START, TB_START);
    for (int j = 1; j <= Lc; ++j) {
      // Ins: consume x against a gap (from row r-1)
      int ext = I[j] + GAP_EXT, opn = S[j] + GAP_OPEN + GAP_EXT;
      const int In = ext > opn ? ext : opn;
      const int ib = ext > opn ? OP_INS : TB_S(up[j]);
      // Del: consume y against a gap (from column j-1)
      ext = D + GAP_EXT;
      opn = S[j - 1] + GAP_OPEN + GAP_EXT;
      const int Dn = ext > opn ? ext : opn;
      const int db = ext > opn ? OP_DEL : sb_left;
      const bool m = xi == y[j - 1];
      int best = diag + (m ? 1 : -1);
      int sb = m ? OP_MATCH : OP_SUBST;
      if (In > best) { best = In; sb = OP_INS; }
      if (Dn > best) { best = Dn; sb = OP_DEL; }
      diag = S[j];
      S[j] = best;
      I[j] = In;
      D = Dn;
      sb_left = sb;
      row[j] = TB(sb, ib, db);
    }
  }

  // the first event decides
  int it_sel = -1, off = 0;
  for (int it = 0; it < ms; ++it) {
    if (fail_step == it || rem < it) break;
    int o;
    if (!greedy_offset(tb, NC, k, it, &o)) continue;
    bool okc = rem - it >= nb;
    uint32_t km = wks[it + 1];
    for (int t = 0; t < nb && okc; ++t) {
      km = br_add(km, code_at(a.codes, i + it + t, a.CHUNK), kmask);
      okc = br_probe(a.table, km, k);
    }
    if (okc) {
      it_sel = it;
      off = o;
      break;
    }
  }
  if (it_sel < 0) return res;
  const int cnt = it_sel + 2;
  const int raw = cnt + off;
  res.ok = true;
  res.cap = raw < 0;
  res.consumed = raw < 0 ? 0 : raw;
  res.cnt = cnt;
  res.new_kmer = wks[it_sel + 1];
  uint32_t emit = 0;
  for (int t = 0; t < cnt; ++t) emit |= (uint32_t)path[t] << (2 * t);
  if (erow) erow[0] = (int32_t)emit;
  return res;
}

__global__ void __launch_bounds__(BR_SITE_THREADS)
    greedy_sites_kernel(BrSites a, int ms, int nb) {
  __shared__ int32_t sh_start[BR_MAX_R];
  __shared__ int32_t sh_len[BR_MAX_R];
  br_stage_slots(a, sh_start, sh_len);
  const int sid = blockIdx.x * BR_SITE_THREADS + threadIdx.x;
  if (sid >= a.NS) return;
  auto attempt = [&](int i, uint32_t reg, uint32_t corr, int lenf,
                     int32_t* erow) {
    return greedy_attempt(a, ms, nb, i, reg, corr, lenf, erow);
  };
  br_site_chain(a, sid, sh_start, sh_len, attempt);
}

extern "C" int br_greedy_sites(
    const void* codes, const void* table, const void* kmers,
    const void* s_pos, const void* n_sites, const void* rstart,
    const void* rlen, int CHUNK, int R, int k, int ms, int nb, int NS,
    void* succ, void* s_cap, void* rec_p, void* rec_c, void* rec_s,
    void* rec_e, void* stream) {
  BrSites a = br_sites_args(codes, table, kmers, s_pos, n_sites, rstart,
                            rlen, CHUNK, R, k, NS, 1, succ, s_cap, rec_p,
                            rec_c, rec_s, rec_e);
  greedy_sites_kernel<<<br_site_blocks(NS), BR_SITE_THREADS, 0,
                        (cudaStream_t)stream>>>(a, ms, nb);
  return (int)cudaGetLastError();
}
