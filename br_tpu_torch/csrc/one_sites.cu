// K2 one_sites: every attempt site of a `one` pass, with its whole chain
// of nested repairs.
//
// Replaces: the site-block queue of br_tpu/correct/engine3.py:1592-1708
// (queue_body/queue_cond) for strategy "one", with its device functions
// _alt_info32_arr (:966, the exactly-one-alternative gate),
// make_one_attempt32_arr (:300, the I/S/D scenarios with the score and
// one_more rules of exist/mod.rs) and dirty_sim (:1526, the scan machine
// for k steps after a repair, which finds nested sites).
//
// One warp per site id sid < NS (BR_PAIR_SITES a block) runs the warp
// chain of sites_common.cuh: gate (4 probes on lanes 0-3), One attempt
// (br_one_attempt_warp: 1 + 3*(c+1) independent probes spread over the
// lanes, their k-mers rolled from the code window i .. i+c+2 held in
// every lane, clipped to the chunk like the JAX window; the rem gating of
// engine3.py:333-337 is what keeps bases past the read end out of the
// result), record write into the site's slot (past SLOTS records the
// site caps with CAP_OVERFLOW), dirty simulation of at most k steps at
// once, then a nested attempt, the successor or the read end.  The JAX
// queue's generation capacities (NQA pending slots, MAXB rounds ->
// CAP_ROUNDS, :1362-1372) have no counterpart: each warp finishes its
// own chain.
//
// Bound on the H100: the probes, dependent loads from L2 (4 MiB table at
// k=13).  A chain step is three L2 round trips (gate, attempt, dirty
// window) whatever c is, in place of one a probe in a thread; NS warps
// (16,384 blocks of 2 on a 2^20 chunk, 4,096 on a 2^18 one) fill every
// SM, and a block frees its slot when the slower of its two chains ends.
//
// Three instantiations from one source: br_one_sites (uint32_t, a
// bitfield at k <= 15), br_one_sites64 (uint64_t, a bitfield at k = 17)
// and br_one_sites_h (uint64_t, a HashSet's sorted table at any k <= 31,
// its code windows two words wide), the same code.
#include "sites_common.cuh"

template <class T, class P, bool G>
__global__ void __launch_bounds__(32 * BR_PAIR_SITES)
    one_sites_kernel(BrSites<P> a, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sid = blockIdx.x * BR_PAIR_SITES + warp;
  if (sid >= a.NS) return;
  if constexpr (G) a = br_sites_chunk<T>(a);
  auto attempt = [&](int i, T reg, T corr, int lenf, int32_t* erow) {
    return br_one_attempt_warp<T>(a, c, i, corr, lenf, erow, lane);
  };
  br_site_chain_warp<T>(a, sid, lane, attempt);
}

template <class T, class P>
static int one_sites_launch(
    int NC, const void* codes, P probe, const void* kmers,
    const void* s_pos, const void* n_sites, const void* rstart,
    const void* rlen, int CHUNK, int R, int k, int c, int NS, void* succ,
    void* s_cap, void* rec_p, void* rec_c, void* rec_s, void* rec_e,
    void* stream) {
  BrSites<P> a = br_sites_args(codes, probe, kmers, s_pos, n_sites, rstart,
                               rlen, CHUNK, R, k, NS, 1, succ, s_cap, rec_p,
                               rec_c, rec_s, rec_e);
  auto kern = NC > 1 ? &one_sites_kernel<T, P, true>
                     : &one_sites_kernel<T, P, false>;
  kern<<<br_warp_site_grid(NS, BR_PAIR_SITES, NC), 32 * BR_PAIR_SITES, 0,
         (cudaStream_t)stream>>>(a, c);
  return (int)cudaGetLastError();
}

#define ONE_ARGS                                                          \
  int NC, const void *codes, const void *table, const void *kmers,      \
      const void *s_pos, const void *n_sites, const void *rstart,         \
      const void *rlen, int CHUNK, int R, int k, int c, int NS,           \
      void *succ, void *s_cap, void *rec_p, void *rec_c, void *rec_s,     \
      void *rec_e
#define ONE_LAUNCH(T, probe)                                              \
  one_sites_launch<T>(NC, codes, probe, kmers, s_pos, n_sites, rstart,    \
                      rlen, CHUNK, R, k, c, NS, succ, s_cap, rec_p,       \
                      rec_c, rec_s, rec_e, stream)

BR_SITE_ENTRIES(br_one_sites, ONE_ARGS, ONE_LAUNCH)
