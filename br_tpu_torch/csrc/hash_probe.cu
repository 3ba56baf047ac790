// K9 hash_probe: membership of k-mers in the sorted table of a HashSet.
//
// Replaces: br_tpu/correct/device_codec.py::make_hash_probe (:160-175)
// and make_hash_probe_any (:135-142), the XLA program of ~log2(n)
// gathers that probes br_tpu's large-k set (ROADMAP B9).
//
// N int64 forward k-mers in, N uint8 memberships out.  One thread a
// k-mer: canonicalise (popcount parity, 2-bit-group reversal in 64 bits),
// then br_probe_sorted (common.cuh): a branchless binary search over the
// 2^levels uint64 entries, loads through __ldg, unsigned compares, so the
// k = 31 sentinel 1 << 63 sorts last as it does on the host.  The pass
// kernels probe the same way inside their chains (BrSortedProbe); this
// launch is the probe alone, held against its plain version and
// torch.searchsorted.
//
// Bound on the H100: the search's dependent loads.  A probe is levels + 1
// loads one after another (22 for a 2^21-entry table); the first levels
// touch a few entries that every thread shares and stay in L1/L2, the
// last ones are scattered: past the 50 MB L2 (a 2^27-entry, 1 GiB table)
// each costs a device-memory round trip.  The bytes are 9 a k-mer.
#include "common.cuh"

#define K9_THREADS 256

__global__ void __launch_bounds__(K9_THREADS) hash_probe_kernel(
    BrSortedProbe probe, const int64_t* __restrict__ kmers, long long n,
    int k, uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * K9_THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = probe((uint64_t)__ldg(kmers + i), k);
}

extern "C" int br_hash_probe(const void* table, int levels,
                             const void* kmers, long long n, int k,
                             void* out, void* stream) {
  BrSortedProbe probe{(const uint64_t*)table, levels};
  const long long blocks = (n + K9_THREADS - 1) / K9_THREADS;
  hash_probe_kernel<<<(unsigned)blocks, K9_THREADS, 0,
                      (cudaStream_t)stream>>>(
      probe, (const int64_t*)kmers, n, k, (uint8_t*)out);
  return (int)cudaGetLastError();
}
