// K9 hash_probe: membership of k-mers in the sorted table of a HashSet.
//
// Replaces: br_tpu/correct/device_codec.py::make_hash_probe (:160-175)
// and make_hash_probe_any (:135-142), the XLA program of ~log2(n)
// gathers that probes br_tpu's large-k set (ROADMAP B9).
//
// N int64 forward k-mers in, N uint8 memberships out.  One thread a
// k-mer: canonicalise (popcount parity, 2-bit-group reversal in 64 bits),
// then br_probe_sorted (common.cuh): the k-mer's bucket offsets from the
// table's index (one 8-byte load where aligned), then a branchless search
// of bucket_levels steps inside the bucket, loads through __ldg, unsigned
// compares; a k-mer whose canonical form has bits past 2k (bit 63, the
// k = 31 sentinel's, among them) reads false without touching the index.
// The pass kernels probe the same way inside their chains
// (BrSortedProbe); this launch is the probe alone, held against its plain
// version and torch.searchsorted.
//
// Bound on the H100: the probe's dependent loads, not its 9 bytes a
// k-mer.  A binary search of the whole table (the first design, as
// br_tpu searches) took levels + 1 loads one after another, 22 at 2^21
// entries, each a 32-byte sector for 8 bytes of it; past the 50 MB L2 (a
// 2^27-entry, 1 GiB table) the last ~12 of them each cost a device-memory
// round trip.  The bucket index (b = levels - 1 bits by default, two
// entries a bucket on average, a quarter of the table's bytes) makes a
// probe one index load and at most bucket_levels loads inside one or two
// sectors of its bucket, mostly L1 hits after the first: about two
// device-memory round trips past the L2, not twelve.
#include "common.cuh"

#define K9_THREADS 256

__global__ void __launch_bounds__(K9_THREADS) hash_probe_kernel(
    BrSortedProbe probe, const int64_t* __restrict__ kmers, long long n,
    int k, uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * K9_THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = probe((uint64_t)__ldg(kmers + i), k);
}

extern "C" int br_hash_probe(const void* table, BR_SORTED_PARAMS,
                             const void* kmers, long long nk, int k,
                             void* out, void* stream) {
  const long long blocks = (nk + K9_THREADS - 1) / K9_THREADS;
  hash_probe_kernel<<<(unsigned)blocks, K9_THREADS, 0,
                      (cudaStream_t)stream>>>(
      BR_SORTED_PROBE(table), (const int64_t*)kmers, nk, k, (uint8_t*)out);
  return (int)cudaGetLastError();
}
