// K3 chain_splice: which sites the scan machine visits, and the spliced
// output of every read.
//
// Replaces: the whole-read chain walk of br_tpu/correct/engine3.py:
// 1723-1749 (pointer doubling over the site successors) and the splice
// of :1751-1839 with _compact (:195) and _lower_bound (:183): record
// compaction, per-read output offsets, out_len and cap, the shift fill
// and the combined gather.
//
// One block per read slot r.  Thread 0 walks the successor chain from the
// read's head site (the first listed site at or after rstart[r], as
// nt[rstart] at :1734) and lays the visited records out in order: for
// record j the verbatim segment codes[pe_j, p_j) and then its emitted
// bases, with pe_0 = rstart and pe_j = p_{j-1} + consumed_{j-1}; the
// segment table (output offset, verbatim start and length, and the
// record's index) goes to scratch at the read's own site range, so reads
// never share scratch.  Then every thread of the block writes its share
// of the slot: verbatim bases, emitted bases (binary search of the
// segment table; emitted base e of a record is bits 2*(e%16) of its word
// e/16, so a walk record's up to walk_max+1 bases in EW words splice like
// a scenario's one word), the tail codes[last_end, rend), and zeros past
// out_len.
// Cap rules as in the JAX pass: any capped site of the read, visited or
// not (:1748-1749); a negative verbatim length (:1770); out_len > rcap or
// a negative tail (:1784-1785); and K1's NS overflow.  Unlike :1822-1827
// nothing is clipped to rstart+rcap-1: a read that fills its slot exactly
// keeps its last emitted base (the fault recorded in ROADMAP C).
// aux gets entries 0 (sites), 1-3 (capped sites by reason), 4 (visited
// sites) and 7 (raw site count); entries 5 and 6 need every read's record
// count (the NR record capacity) and are finished by the pass.
//
// Bound on the H100: bytes, one read and one write of the chunk's codes
// plus the site tables.  The chain walk is a serial chain of dependent
// loads per read; the design walks all R reads at once (one block each)
// and copies with the whole block.
#include "common.cuh"

#define K3_THREADS 256

__global__ void __launch_bounds__(K3_THREADS) chain_splice_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ rstart,
    const int32_t* __restrict__ rlen, const int32_t* __restrict__ s_pos,
    const int32_t* __restrict__ n_sites, const int32_t* __restrict__ succ,
    const int32_t* __restrict__ s_cap, const int32_t* __restrict__ rec_p,
    const int32_t* __restrict__ rec_c, const int32_t* __restrict__ rec_s,
    const int32_t* __restrict__ rec_e,
    const uint8_t* __restrict__ cap_dense, int CHUNK, int R, int NS, int EW,
    int32_t* __restrict__ seg_o, int32_t* __restrict__ seg_pe,
    int32_t* __restrict__ seg_v, int32_t* __restrict__ seg_r,
    uint8_t* __restrict__ out,
    int32_t* __restrict__ out_len, uint8_t* __restrict__ cap,
    int32_t* __restrict__ rec_cnt, int32_t* __restrict__ aux) {
  __shared__ int sh_lo, sh_hi, sh_m, sh_body, sh_last, sh_outl, sh_span;
  __shared__ int sh_ncap[3];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int rs = rstart[r];
  const int n = rlen[r];
  const int n_eff = min(n_sites[0], NS);
  if (r == 0 && tid == 0) {
    aux[0] = n_eff;
    aux[7] = n_sites[0];
  }
  if (rs >= CHUNK) {  // unused slot
    if (tid == 0) {
      out_len[r] = 0;
      cap[r] = 0;
      rec_cnt[r] = 0;
    }
    return;
  }
  const int rnext = r + 1 < R ? rstart[r + 1] : CHUNK;
  const int rcap = rnext - rs;
  const int rend = rs + n;
  if (tid == 0) {
    sh_lo = br_lower_bound(s_pos, n_eff, rs);
    sh_hi = n > 0 ? br_lower_bound(s_pos, n_eff, rend) : sh_lo;
    sh_ncap[0] = sh_ncap[1] = sh_ncap[2] = 0;
  }
  __syncthreads();
  const int lo = sh_lo, hi = sh_hi;

  // capped sites of this read, visited or not
  int c1 = 0, c2 = 0, c4 = 0;
  for (int x = lo + tid; x < hi; x += K3_THREADS) {
    int sc = s_cap[x];
    c1 += sc == BR_CAP_OVERFLOW;
    c2 += sc == BR_CAP_ATTEMPT;
    c4 += sc == BR_CAP_ROUNDS;
  }
  if (c1) atomicAdd(&sh_ncap[0], c1);
  if (c2) atomicAdd(&sh_ncap[1], c2);
  if (c4) atomicAdd(&sh_ncap[2], c4);

  if (tid == 0) {
    // the chain walk and the segment table
    const int ob = lo * BR_SLOTS;
    int m = 0, visited = 0, body = 0, pe = rs;
    bool vneg = false;
    int x = lo;
    while (x < hi) {
      ++visited;
      for (int s = 0; s < BR_SLOTS; ++s) {
        int p = rec_p[x * BR_SLOTS + s];
        if (p >= BR_BIG) continue;
        int cnt = rec_c[x * BR_SLOTS + s];
        int vlen = p - pe;
        if (vlen < 0) vneg = true;
        vlen = max(0, min(vlen, CHUNK));
        seg_o[ob + m] = body;
        seg_pe[ob + m] = pe;
        seg_v[ob + m] = vlen;
        seg_r[ob + m] = x * BR_SLOTS + s;
        body += vlen + cnt;
        pe = p + rec_s[x * BR_SLOTS + s];
        ++m;
      }
      int nx = succ[x];
      if (nx <= x) break;
      x = nx;
    }
    const int tail = rend - pe;
    int outl = body + tail;
    bool capped = cap_dense[r] || vneg ||
                  (n > 0 && (outl > rcap || tail < 0));
    outl = n > 0 ? max(0, min(outl, rcap)) : 0;
    sh_m = m;
    sh_body = body;
    sh_last = pe;
    sh_outl = outl;
    sh_span = max(0, min(rcap, CHUNK - rs));
    out_len[r] = outl;
    cap[r] = capped;  // site caps are or-ed in below
    rec_cnt[r] = m;
    atomicAdd(&aux[4], visited);
  }
  __syncthreads();
  if (tid == 0) {
    int nc = sh_ncap[0] + sh_ncap[1] + sh_ncap[2];
    if (nc) {
      cap[r] = 1;
      atomicAdd(&aux[1], sh_ncap[0]);
      atomicAdd(&aux[2], sh_ncap[1]);
      atomicAdd(&aux[3], sh_ncap[2]);
    }
  }

  // write the slot
  const int m = sh_m, body = sh_body, last = sh_last, outl = sh_outl;
  const int ob = lo * BR_SLOTS;
  for (int o = tid; o < sh_span; o += K3_THREADS) {
    uint32_t v = 0;
    if (o < outl) {
      int src;
      if (o >= body) {
        src = last + (o - body);
        v = codes[max(0, min(src, CHUNK - 1))] & 3u;
      } else {
        // last segment j with seg_o[j] <= o
        int a = 0, b = m;
        while (a < b) {
          int mid = (a + b) >> 1;
          if (seg_o[ob + mid] <= o) a = mid + 1; else b = mid;
        }
        const int j = a - 1;
        const int d = o - seg_o[ob + j];
        const int vl = seg_v[ob + j];
        if (d < vl) {
          src = seg_pe[ob + j] + d;
          v = codes[max(0, min(src, CHUNK - 1))] & 3u;
        } else {
          const int e = d - vl;
          const uint32_t w =
              (uint32_t)rec_e[(size_t)seg_r[ob + j] * EW + e / 16];
          v = (w >> (2 * (e % 16))) & 3u;
        }
      }
    }
    out[rs + o] = (uint8_t)v;
  }
}

extern "C" int br_chain_splice(
    const void* codes, const void* rstart, const void* rlen,
    const void* s_pos, const void* n_sites, const void* succ,
    const void* s_cap, const void* rec_p, const void* rec_c,
    const void* rec_s, const void* rec_e, const void* cap_dense, int CHUNK,
    int R, int NS, int EW, void* seg_o, void* seg_pe, void* seg_v,
    void* seg_r,
    void* out, void* out_len, void* cap, void* rec_cnt,
    void* aux, void* stream) {
  chain_splice_kernel<<<R, K3_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)rstart, (const int32_t*)rlen,
      (const int32_t*)s_pos, (const int32_t*)n_sites, (const int32_t*)succ,
      (const int32_t*)s_cap, (const int32_t*)rec_p, (const int32_t*)rec_c,
      (const int32_t*)rec_s, (const int32_t*)rec_e,
      (const uint8_t*)cap_dense, CHUNK, R, NS, EW, (int32_t*)seg_o,
      (int32_t*)seg_pe, (int32_t*)seg_v, (int32_t*)seg_r, (uint8_t*)out,
      (int32_t*)out_len, (uint8_t*)cap, (int32_t*)rec_cnt, (int32_t*)aux);
  return (int)cudaGetLastError();
}
