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
// One thread per site runs the site chain of sites_common.cuh with this
// attempt.  The code window reaches i + 4 + c + 1, past the read's end
// into the next slot or stale slack; only the rem gating (:389-411,
// :444, :468) keeps those bases out, exactly as in JAX.  The JAX queue's
// generation capacities have no counterpart (each thread finishes its own
// chain).
//
// Bound on the H100: the probes, ~13*(c+2) + 20 dependent bitfield reads
// per attempt from L2, latency-bound per thread.  The design evaluates a
// scenario's score only while it stays perfect and its one_more only for
// the scenarios kept, holds the 13 candidates in registers (the scenario
// loop is unrolled, so its tables are constants), and writes each output
// once.
#include "sites_common.cuh"

#define N_SCEN 13
enum { II, IS, SS, SD, DD, ICI, ICS, ICD, SCI, SCS, SCD, DCI, DCD };
__constant__ int APPLY_OFF[N_SCEN] = {3, 2, 2, 1, 0, 4, 3, 3, 4, 3, 2, 4, 1};
__constant__ int CORRECT_OFF[N_SCEN] = {2, 2, 2, 1, 0, 3, 4, 2, 4, 3, 2,
                                        1, 1};
// emitted bases: how many, and whether they are the last bases of corr
// (else of the scenario's km2)
__constant__ int EMIT_N[N_SCEN] = {1, 1, 2, 2, 2, 1, 2, 2, 3, 3, 3, 0, 3};
__constant__ bool EMIT_CORR[N_SCEN] = {true, true, false, false, false,
                                       true, false, false, false, false,
                                       false, false, false};

__device__ __forceinline__ BrAttempt two_attempt(const BrSites& a, int c,
                                                 int i, uint32_t reg,
                                                 uint32_t corr, int lenf,
                                                 int32_t* erow) {
  const int k = a.k;
  const uint32_t kmask = br_kmask(k);
  const int rem = lenf - i;
  auto absorb = [&](uint32_t km, int idx) {
    return br_add(km, code_at(a.codes, idx, a.CHUNK), kmask);
  };
  auto probe = [&](uint32_t km) { return br_probe(a.table, km, k); };

  uint32_t km2[N_SCEN];
  bool aok[N_SCEN];
  uint32_t r, code;
  int n;
  const uint32_t t1 = absorb(corr, i + 1);
  const bool t1v = probe(t1);
  aok[II] = true;
  km2[II] = corr;
  aok[IS] = true;
  km2[IS] = corr;
  n = br_alt_last(a.table, t1, k, &r);
  aok[SS] = rem >= 2 && !t1v && n == 1;
  km2[SS] = r;
  aok[ICS] = rem >= 4 && !t1v && n == 1;
  km2[ICS] = r;
  n = br_alt_next(a.table, corr, k, kmask, &code);
  aok[SD] = rem >= 1 && n == 1;
  aok[DD] = n == 1;
  km2[SD] = km2[DD] = br_add(corr, code, kmask);
  const uint32_t t3 = absorb(corr, i + 3);
  aok[ICI] = rem >= 4 && probe(t3);
  km2[ICI] = t3;
  const uint32_t second = absorb(corr, i + 2);
  n = br_alt_next(a.table, second, k, kmask, &code);
  aok[ICD] = rem >= 4 && n == 1;
  km2[ICD] = br_add(second, code, kmask);
  const uint32_t sci = absorb(t1, i + 3);
  aok[SCI] = rem >= 4;
  km2[SCI] = sci;
  const uint32_t t2 = absorb(t1, i + 2);
  n = br_alt_last(a.table, t2, k, &r);
  aok[SCS] = rem >= 3 && t1v && n == 1 && !probe(t2);
  km2[SCS] = r;
  n = br_alt_next(a.table, t1, k, kmask, &code);
  aok[SCD] = rem >= 2 && n == 1;
  km2[SCD] = br_add(t1, code, kmask);
  aok[DCI] = rem >= 4;
  km2[DCI] = sci;
  const uint32_t t0 = absorb(corr, i);
  n = br_alt_next(a.table, t0, k, kmask, &code);
  aok[DCD] = rem >= 2 && n == 1;
  km2[DCD] = br_add(t0, code, kmask);

  bool keep[N_SCEN], more[N_SCEN];
  int nk1 = 0, nk2 = 0;
#pragma unroll
  for (int s = 0; s < N_SCEN; ++s) {
    const int off_a = APPLY_OFF[s];
    bool ok = aok[s] && off_a + c <= rem && probe(km2[s]);
    uint32_t km = km2[s];
    for (int t = 0; t < c && ok; ++t) {
      km = absorb(km, i + off_a + t);
      ok = probe(km);
    }
    keep[s] = ok;
    more[s] = false;
    if (ok) {
      ++nk1;
      const int off_c = CORRECT_OFF[s];
      const uint32_t src = EMIT_CORR[s] ? corr : km2[s];
      uint32_t om = corr >> 2;
      for (int t = 0; t < EMIT_N[s]; ++t)
        om = br_add(om, (src >> (2 * (EMIT_N[s] - 1 - t))) & 3u, kmask);
      for (int t = 0; t <= c; ++t) om = absorb(om, i + off_c + t);
      more[s] = rem > c + off_c + 1 && probe(om);
      nk2 += more[s];
    }
  }
  BrAttempt res = {false, false, 0u, 0, 0};
  res.ok = nk1 == 1 || (nk1 > 1 && nk2 == 1);
  if (!res.ok) return res;
  int s = 0;
  while (!(nk1 == 1 ? keep[s] : (keep[s] && more[s]))) ++s;
  const uint32_t src = EMIT_CORR[s] ? corr : km2[s];
  uint32_t emit = 0, nkm = reg >> 2;
  for (int t = 0; t < EMIT_N[s]; ++t) {
    const uint32_t b = (src >> (2 * (EMIT_N[s] - 1 - t))) & 3u;
    emit |= b << (2 * t);
    nkm = br_add(nkm, b, kmask);
  }
  res.new_kmer = nkm;
  res.consumed = CORRECT_OFF[s];
  res.cnt = EMIT_N[s];
  if (erow) erow[0] = (int32_t)emit;
  return res;
}

__global__ void __launch_bounds__(BR_SITE_THREADS)
    two_sites_kernel(BrSites a, int c) {
  __shared__ int32_t sh_start[BR_MAX_R];
  __shared__ int32_t sh_len[BR_MAX_R];
  br_stage_slots(a, sh_start, sh_len);
  const int sid = blockIdx.x * BR_SITE_THREADS + threadIdx.x;
  if (sid >= a.NS) return;
  auto attempt = [&](int i, uint32_t reg, uint32_t corr, int lenf,
                     int32_t* erow) {
    return two_attempt(a, c, i, reg, corr, lenf, erow);
  };
  br_site_chain(a, sid, sh_start, sh_len, attempt);
}

extern "C" int br_two_sites(
    const void* codes, const void* table, const void* kmers,
    const void* s_pos, const void* n_sites, const void* rstart,
    const void* rlen, int CHUNK, int R, int k, int c, int NS, void* succ,
    void* s_cap, void* rec_p, void* rec_c, void* rec_s, void* rec_e,
    void* stream) {
  BrSites a = br_sites_args(codes, table, kmers, s_pos, n_sites, rstart,
                            rlen, CHUNK, R, k, NS, 1, succ, s_cap, rec_p,
                            rec_c, rec_s, rec_e);
  two_sites_kernel<<<br_site_blocks(NS), BR_SITE_THREADS, 0,
                     (cudaStream_t)stream>>>(a, c);
  return (int)cudaGetLastError();
}
