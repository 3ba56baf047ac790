// K5 two_sites: every attempt site of a `two` pass, with its whole chain
// of nested repairs.
//
// Replaces: the site-block queue of br_tpu/correct/engine3.py:1592-1708
// for strategy "two", whose attempt is make_two_attempt32 (:359-490):
// the 13 two-error scenarios of exist/two.rs (II IS SS SD DD ICI ICS ICD
// SCI SCS SCD DCI DCD, in declaration order).  Each scenario's apply step
// (a candidate register km2 and its gate, :383-411) is scored over c+1
// k-mers from APPLY_OFF (:415); its emitted bases (the last 1-3 bases of
// corr or km2, none for DCI, which consumes 1 and emits nothing,
// PARITY.md:29) and CORRECT_OFF (:416) give the record and the one_more
// probe.  A unique perfect score applies; among several, a unique
// one_more (:470-476).
//
// One warp per site (BR_PAIR_SITES a block) runs the warp chain of
// sites_common.cuh with two_attempt_warp, which makes the attempt's
// probes in two dependent rounds, every lane one probe at a time:
// round A, the apply steps' 25 probes (the alternatives of the last base
// of t1 and of t2, the successors of corr, second, t1 and t0, and t3);
// round B, for every scenario its candidate, its c window k-mers and its
// one_more k-mer, 13*(c+2) probes that depend only on round A's
// candidates and on codes.  The codes come from a window of 32 codes (64
// for a sorted table, k <= 31) held in every lane (br_window_warp), from
// i and, for a pass of round B past its first 96 probes (c > 5), from
// further on; the window reaches
// past the read's end
// into the next slot or stale slack, and only the rem gating (:389-411,
// :444, :468), applied to the masks after the probes, keeps those bases
// out, exactly as in JAX.  Round B loads no probe of a scenario whose
// gate failed or whose window passes the read (it could not keep), and
// none of DCI's score, which is SCI's (the same candidate, gate and
// APPLY_OFF).  The JAX queue's generation capacities have no
// counterpart (each warp finishes its own chain).
//
// Bound on the H100: the probes, dependent loads from L2, and on a full
// 2^20 chunk the instructions a warp issues for its site (64 warps share
// an SM's four schedulers).  A chain step is four L2 round trips (gate,
// rounds A and B, dirty window), in place of up to ~13*(c+2) + 27 one
// after another in a thread; the 91 probes of round B at c=5 go out
// together (three rounds of 32 lanes unrolled, their loads issued before
// any is used); a lane's probe is set up without branches (its
// scenario's candidate and one_more register by shuffle from lane s);
// NS warps, 2 a block, fill every SM.
//
// Three instantiations from one source: br_two_sites (uint32_t, a
// bitfield at k <= 15), br_two_sites64 (uint64_t, a bitfield at k = 17)
// and br_two_sites_h (uint64_t, a HashSet's sorted table at any k <= 31),
// the same code; a pass's probes go out together through the probe
// policy's many() (for the sorted table its searches step together).
#include "sites_common.cuh"

#define N_SCEN 13
enum { II, IS, SS, SD, DD, ICI, ICS, ICD, SCI, SCS, SCD, DCI, DCD };
// Per-scenario tables as bit fields (scenario s at bits s*width), so that
// a lane reads its own scenario's entry from a register.
constexpr int APPLY_OFF_[N_SCEN] = {3, 2, 2, 1, 0, 4, 3, 3, 4, 3, 2, 4, 1};
constexpr int CORRECT_OFF_[N_SCEN] = {2, 2, 2, 1, 0, 3, 4, 2, 4, 3, 2, 1,
                                      1};
// emitted bases: how many, and whether they are the last bases of corr
// (else of the scenario's km2)
constexpr int EMIT_N_[N_SCEN] = {1, 1, 2, 2, 2, 1, 2, 2, 3, 3, 3, 0, 3};
constexpr int EMIT_CORR_[N_SCEN] = {1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0};

constexpr uint64_t pack_fields(const int* v, int width) {
  uint64_t x = 0;
  for (int s = N_SCEN - 1; s >= 0; --s) x = (x << width) | (uint64_t)v[s];
  return x;
}
constexpr uint64_t APPLY_OFF = pack_fields(APPLY_OFF_, 3);
constexpr uint64_t CORRECT_OFF = pack_fields(CORRECT_OFF_, 3);
constexpr uint64_t EMIT_N = pack_fields(EMIT_N_, 2);
constexpr uint64_t EMIT_CORR = pack_fields(EMIT_CORR_, 1);

// the scenarios whose offset in v is at most o
constexpr uint32_t off_le(const int* v, int o) {
  uint32_t m = 0;
  for (int s = 0; s < N_SCEN; ++s) m |= (uint32_t)(v[s] <= o) << s;
  return m;
}
constexpr uint32_t APPLY_LE0 = off_le(APPLY_OFF_, 0);
constexpr uint32_t APPLY_LE1 = off_le(APPLY_OFF_, 1);
constexpr uint32_t APPLY_LE2 = off_le(APPLY_OFF_, 2);
constexpr uint32_t APPLY_LE3 = off_le(APPLY_OFF_, 3);
constexpr uint32_t CORRECT_LE0 = off_le(CORRECT_OFF_, 0);
constexpr uint32_t CORRECT_LE1 = off_le(CORRECT_OFF_, 1);
constexpr uint32_t CORRECT_LE2 = off_le(CORRECT_OFF_, 2);
constexpr uint32_t CORRECT_LE3 = off_le(CORRECT_OFF_, 3);

__device__ __forceinline__ int field(uint64_t table, int s, int width) {
  return (int)((table >> (s * width)) & ((1u << width) - 1u));
}

// the scenarios whose offset (0..4) is at most lim, from the masks of
// offsets at most 0..3
__device__ __forceinline__ uint32_t off_at_most(int lim, uint32_t le0,
                                                uint32_t le1, uint32_t le2,
                                                uint32_t le3) {
  return lim < 0 ? 0u : lim == 0 ? le0 : lim == 1 ? le1 : lim == 2 ? le2
         : lim == 3 ? le3 : (1u << N_SCEN) - 1u;
}

// rounds of 32 probes whose loads go out before any result is used: 96
// >= the 13*(c+2) = 91 probes of round B at the default c = 5
#define TWO_UNROLL 3

// make_two_attempt32 for one site, called by every lane of the warp with
// the same arguments; every lane returns the same result.
template <class T, class P>
__device__ __forceinline__ BrAttempt<T> two_attempt_warp(
    const BrSites<P>& a, int c, int lane, int i, T reg, T corr, int lenf,
    int32_t* erow) {
  constexpr int L = br_lag<T, P>() + 1;
  constexpr int NW = br_win_words<T, P>();
  const int k = a.k;
  const T kmask = br_kmask<T>(k);
  const int rem = lenf - i;
  BrWindow<NW> w = br_window_warp<NW>(a.codes, a.CHUNK, i, 0, lane);
  auto add = [&](T km, uint32_t code) { return br_add(km, code, kmask); };
  auto alt = [](uint32_t m) {  // the sum of the bases a whose bit is set
    return ((m >> 1) & 1u) + 2u * ((m >> 2) & 1u) + 3u * (m >> 3);
  };

  // the apply steps' registers (absorb(km, i+j) is add(km, code j))
  const T t0 = add(corr, br_span(w, 0, 1));
  const T t1 = add(corr, br_span(w, 1, 1));
  const T second = add(corr, br_span(w, 2, 1));
  const T t3 = add(corr, br_span(w, 3, 1));
  const T t2 = add(t1, br_span(w, 2, 1));
  const T sci = add(t1, br_span(w, 3, 1));
  const T b1 = (t1 >> 2) << 2, b2 = (t2 >> 2) << 2;

  // round A: lanes 4g+a probe alt_last(t1), alt_last(t2) (g = 0, 1) and
  // the successors of corr, second, t1, t0 (g = 2..5); lane 24 t3
  const int g = lane >> 2;
  const uint32_t la = lane & 3u;
  const T nb = g == 2 ? corr : g == 3 ? second : g == 4 ? t1 : t0;
  const T qa = g == 0 ? b1 ^ (T)la : g == 1 ? b2 ^ (T)la
               : g < 6 ? add(nb, la) : t3;
  const uint32_t M =
      __ballot_sync(BR_FULL, lane < 25 && a.probe(qa, k));
  const uint32_t m1 = M & 0xFu, m2 = (M >> 4) & 0xFu;
  const uint32_t mc = (M >> 8) & 0xFu, msec = (M >> 12) & 0xFu;
  const uint32_t mt1 = (M >> 16) & 0xFu, mt0 = (M >> 20) & 0xFu;
  const bool t1v = (m1 >> (t1 & 3u)) & 1u;
  const bool t2v = (m2 >> (t2 & 3u)) & 1u;
  const bool t3v = (M >> 24) & 1u;
  const bool n1 = __popc(m1) == 1;
  const uint32_t aok =
      (1u << II) | (1u << IS)
      | (uint32_t)(rem >= 2 && !t1v && n1) << SS
      | (uint32_t)(rem >= 1 && __popc(mc) == 1) << SD
      | (uint32_t)(__popc(mc) == 1) << DD
      | (uint32_t)(rem >= 4 && t3v) << ICI
      | (uint32_t)(rem >= 4 && !t1v && n1) << ICS
      | (uint32_t)(rem >= 4 && __popc(msec) == 1) << ICD
      | (uint32_t)(rem >= 4) << SCI
      | (uint32_t)(rem >= 3 && t1v && __popc(m2) == 1 && !t2v) << SCS
      | (uint32_t)(rem >= 2 && __popc(mt1) == 1) << SCD
      | (uint32_t)(rem >= 4) << DCI
      | (uint32_t)(rem >= 2 && __popc(mt0) == 1) << DCD;
  // scenarios within the read: the score's (APPLY_OFF + c <= rem) and
  // the one_more's (rem > c + CORRECT_OFF + 1)
  const uint32_t fit_a = off_at_most(rem - c, APPLY_LE0, APPLY_LE1,
                                     APPLY_LE2, APPLY_LE3);
  const uint32_t fit_c = off_at_most(rem - c - 2, CORRECT_LE0, CORRECT_LE1,
                                     CORRECT_LE2, CORRECT_LE3);
  // DCI scores as SCI (the same candidate, gate and APPLY_OFF): only its
  // one_more is probed
  const uint32_t scored = aok & fit_a & ~(1u << DCI);
  const uint32_t mored = aok & fit_a & fit_c;

  // lane s < 13: scenario s's candidate km2 and its one_more register
  // before the c+1 codes (corr >> 2 and the emitted bases)
  const int ls = lane < N_SCEN ? lane : 0;
  const T km2v =
      ls <= IS ? corr : (ls == SS || ls == ICS) ? (b1 ^ (T)alt(m1))
      : (ls == SD || ls == DD) ? add(corr, alt(mc)) : ls == ICI ? t3
      : ls == ICD ? add(second, alt(msec)) : (ls == SCI || ls == DCI) ? sci
      : ls == SCS ? (b2 ^ (T)alt(m2)) : ls == SCD ? add(t1, alt(mt1))
      : add(t0, alt(mt0));
  const int ne = field(EMIT_N, ls, 2);
  const T src = field(EMIT_CORR, ls, 1) ? corr : km2v;
  const T mbv =
      (((corr >> 2) << (2 * ne)) | (src & (T)((1u << (2 * ne)) - 1u))) &
      kmask;

  // round B: probe j of scenario s, on lane-wise index 13*j + s: j = 0
  // its candidate, 1..c the window k-mer after j codes from APPLY_OFF,
  // c+1 the one_more k-mer after c+1 codes from CORRECT_OFF.  A pass of
  // TWO_UNROLL rounds spans j0 .. j0+8, so its codes lie within
  // j0-L .. j0+11 (L = k_max, 15, 17 or 31): the window is loaded again at
  // j0-L past the first.
  // Probes of scenarios that cannot keep are not loaded (they count as
  // failed, which changes nothing).
  const int NP = N_SCEN * (c + 2);
  uint32_t failm = 0, morem = 0;
  for (int b0 = 0; b0 < NP; b0 += 32 * TWO_UNROLL) {
    const int j0 = b0 / N_SCEN;
    if (b0 > 0)
      w = br_window_warp<NW>(a.codes, a.CHUNK, i, j0 > L ? j0 - L : 0,
                             lane);
    T kms[TWO_UNROLL];
    bool needs[TWO_UNROLL];
    int sc[TWO_UNROLL];
    bool om[TWO_UNROLL];
#pragma unroll
    for (int u = 0; u < TWO_UNROLL; ++u) {  // set up the probes
      const int idx = b0 + 32 * u + lane;
      const bool in = idx < NP;
      const int id = in ? idx : NP - 1;  // idle lanes: a probe of this pass
      const int j = id / N_SCEN, s = id - N_SCEN * j;
      const T k2 = __shfl_sync(BR_FULL, km2v, s);
      const T mb = __shfl_sync(BR_FULL, mbv, s);
      const bool more = j > c;
      const int m = more ? c + 1 : j;  // codes absorbed, 0 for km2 itself
      const int off = more ? field(CORRECT_OFF, s, 3)
                           : field(APPLY_OFF, s, 3);
      const T base = more ? mb : k2;
      const T rolled = br_roll_window(w, base, off + (m ? m : 1) - 1,
                                      m ? m : 1, k, kmask);
      kms[u] = m ? rolled : base;
      needs[u] = in && (((more ? mored : scored) >> s) & 1u);
      sc[u] = in ? s : 31;
      om[u] = more;
    }
    // all of the pass's probes at once, then their results
    const uint32_t hits = a.probe.many(kms, needs, k);
#pragma unroll
    for (int u = 0; u < TWO_UNROLL; ++u) {
      const uint32_t v = (hits >> u) & 1u;
      failm |= (uint32_t)(!om[u] && !v) << sc[u];
      morem |= (uint32_t)(om[u] && v) << sc[u];
    }
  }
  failm = __reduce_or_sync(BR_FULL, failm);
  morem = __reduce_or_sync(BR_FULL, morem);
  failm = (failm & ~(1u << DCI)) | ((failm >> SCI) & 1u) << DCI;

  const uint32_t keepm = aok & fit_a & ~failm;
  const uint32_t keep2m = keepm & fit_c & morem;
  const int nk1 = __popc(keepm), nk2 = __popc(keep2m);
  BrAttempt<T> res = {false, false, T(0), 0, 0};
  res.ok = nk1 == 1 || (nk1 > 1 && nk2 == 1);
  if (!res.ok) return res;
  const int s = __ffs(nk1 == 1 ? keepm : keep2m) - 1;
  const int nes = field(EMIT_N, s, 2);
  const T srcs = field(EMIT_CORR, s, 1) ? corr
                                         : (T)__shfl_sync(BR_FULL, km2v, s);
  uint32_t emit = 0;
  T nkm = reg >> 2;
  for (int t = 0; t < nes; ++t) {
    const uint32_t b = (uint32_t)(srcs >> (2 * (nes - 1 - t))) & 3u;
    emit |= b << (2 * t);
    nkm = add(nkm, b);
  }
  res.new_kmer = nkm;
  res.consumed = field(CORRECT_OFF, s, 3);
  res.cnt = nes;
  if (erow && lane == 0) erow[0] = (int32_t)emit;
  return res;
}

template <class T, class P, bool G>
__global__ void __launch_bounds__(32 * BR_PAIR_SITES)
    two_sites_kernel(BrSites<P> a, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sid = blockIdx.x * BR_PAIR_SITES + warp;
  if (sid >= a.NS) return;
  if constexpr (G) a = br_sites_chunk<T>(a);
  auto attempt = [&](int i, T reg, T corr, int lenf, int32_t* erow) {
    return two_attempt_warp<T>(a, c, lane, i, reg, corr, lenf, erow);
  };
  br_site_chain_warp<T>(a, sid, lane, attempt);
}

template <class T, class P>
static int two_sites_launch(
    int NC, const void* codes, P probe, const void* kmers,
    const void* s_pos, const void* n_sites, const void* rstart,
    const void* rlen, int CHUNK, int R, int k, int c, int NS, void* succ,
    void* s_cap, void* rec_p, void* rec_c, void* rec_s, void* rec_e,
    void* stream) {
  BrSites<P> a = br_sites_args(codes, probe, kmers, s_pos, n_sites, rstart,
                               rlen, CHUNK, R, k, NS, 1, succ, s_cap, rec_p,
                               rec_c, rec_s, rec_e);
  auto kern = NC > 1 ? &two_sites_kernel<T, P, true>
                     : &two_sites_kernel<T, P, false>;
  kern<<<br_warp_site_grid(NS, BR_PAIR_SITES, NC), 32 * BR_PAIR_SITES, 0,
         (cudaStream_t)stream>>>(a, c);
  return (int)cudaGetLastError();
}

#define TWO_ARGS                                                          \
  int NC, const void *codes, const void *table, const void *kmers,      \
      const void *s_pos, const void *n_sites, const void *rstart,         \
      const void *rlen, int CHUNK, int R, int k, int c, int NS,           \
      void *succ, void *s_cap, void *rec_p, void *rec_c, void *rec_s,     \
      void *rec_e
#define TWO_LAUNCH(T, probe)                                              \
  two_sites_launch<T>(NC, codes, probe, kmers, s_pos, n_sites, rstart,    \
                      rlen, CHUNK, R, k, c, NS, succ, s_cap, rec_p,       \
                      rec_c, rec_s, rec_e, stream)

BR_SITE_ENTRIES(br_two_sites, TWO_ARGS, TWO_LAUNCH)
