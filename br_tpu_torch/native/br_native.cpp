// Native CPU correction engine of br_tpu_torch.
//
// A C++ implementation of the same correction semantics as
// br_tpu_torch.correct.reference (which in turn mirrors the reference Rust
// at src/correct/ of natir/br; cited per function below).  Role:
//
//  * the host engine for the reads the device does not finish (impure
//    bytes, too long for a chunk, capped after the wide retry): the port's
//    Torch3Corrector hands them to it through br_tpu_torch.native;
//  * the CPU baseline for the port's benchmark (ROADMAP A2), on the card's
//    own host, at the same optimization class (-O3, 2-bit rolling k-mers,
//    bitfield probes).
//
// The port keeps its own copy of the JAX package's engine
// (br_tpu/native/br_native.cpp); the code below the header is the same.
// Exposed as a C ABI consumed via ctypes (no pybind11 needed).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

using u64 = uint64_t;
using u8 = uint8_t;

inline u64 maskk(int k) { return (~0ull) >> (64 - 2 * k); }

inline u64 comp_mask(int k) {
  u64 m = 0;
  for (int i = 0; i < k; i++) m = (m << 2) | 0b10ull;
  return m;
}

inline int nuc2bit(u8 n) { return (n >> 1) & 0b11; }
inline u8 bit2nuc(u64 b) { return "ACTG"[b & 3]; }

inline u64 add_nuc(u64 kmer, u64 nuc, int k) {
  // reference src/correct/mod.rs:110-112
  return ((kmer << 2) & maskk(k)) ^ nuc;
}

inline u64 revcomp(u64 kmer, int k) {
  u64 x = kmer ^ comp_mask(k);
  x = ((x & 0x3333333333333333ull) << 2) | ((x & 0xccccccccccccccccull) >> 2);
  x = ((x & 0x0f0f0f0f0f0f0f0full) << 4) | ((x & 0xf0f0f0f0f0f0f0f0ull) >> 4);
  x = ((x & 0x00ff00ff00ff00ffull) << 8) | ((x & 0xff00ff00ff00ff00ull) >> 8);
  x = ((x & 0x0000ffff0000ffffull) << 16) | ((x & 0xffff0000ffff0000ull) >> 16);
  x = (x << 32) | (x >> 32);
  return x >> (64 - 2 * k);
}

inline u64 canonical(u64 kmer, int k) {
  return (__builtin_popcountll(kmer) & 1) ? revcomp(kmer, k) : kmer;
}

// ----------------------------------------------------------------------
// Membership sets
// ----------------------------------------------------------------------

struct KmerSet {
  int k = 0;
  // dense bitfield over canonical>>1 (2^(2k-1) bits), or sparse hash
  std::vector<u8> bits;
  std::unordered_set<u64> hash;
  bool dense = true;

  bool get(u64 kmer) const {
    u64 cano = canonical(kmer, k);
    if (dense) {
      u64 idx = cano >> 1;
      return (bits[idx >> 3] >> (idx & 7)) & 1;
    }
    return hash.count(cano) != 0;
  }
};

// ----------------------------------------------------------------------
// Shared correction helpers (src/correct/mod.rs:114-152)
// ----------------------------------------------------------------------

struct Correction {
  bool ok = false;
  std::vector<u8> bases;  // ASCII
  long consumed = 0;
};

inline int next_nucs(const KmerSet& s, u64 kmer, u64* alts) {
  int n = 0;
  for (u64 a = 0; a < 4; a++)
    if (s.get(add_nuc(kmer, a, s.k))) alts[n++] = a;
  return n;
}

inline int alt_nucs(const KmerSet& s, u64 ori, u64* alts) {
  return next_nucs(s, ori >> 2, alts);
}

inline void error_len(const u8* sub, long sublen, u64 kmer, const KmerSet& s,
                      long* out_j, u64* out_kmer) {
  long j = 0;
  for (;;) {
    j += 1;
    if (j >= sublen) break;
    kmer = add_nuc(kmer, nuc2bit(sub[j]), s.k);
    if (s.get(kmer)) break;
  }
  *out_j = j;
  *out_kmer = kmer;
}

// ----------------------------------------------------------------------
// Exist framework (exist/mod.rs) + One (one.rs) + Two (two.rs)
// ----------------------------------------------------------------------

struct Scenario {
  // apply: returns (ok, kmer2); apply_off / correct_off are fixed
  int apply_off, correct_off, emit_n;  // emit_n: 0..3 bases from kmer2/corr
  bool from_corr;                      // emit = last base of `corr`
};

struct ExistEngine {
  const KmerSet& s;
  int c;

  // generic score (exist/mod.rs:21-47)
  bool score_ok(u64 kmer2, int off, const u8* seq, long len) const {
    if (!s.get(kmer2)) return false;
    if (off + c > (long)len) return false;
    u64 km = kmer2;
    for (int t = 0; t < c; t++) {
      km = add_nuc(km, nuc2bit(seq[off + t]), s.k);
      if (!s.get(km)) return false;
    }
    return true;
  }

  // one_more (exist/mod.rs:49-70)
  bool one_more(u64 corr, const std::vector<u8>& emits, int off_c,
                const u8* seq, long len) const {
    if (!((long)len > (long)c + off_c + 1)) return false;
    u64 km = corr >> 2;
    for (u8 b : emits) km = add_nuc(km, nuc2bit(b), s.k);
    for (int t = 0; t < c + 1; t++)
      km = add_nuc(km, nuc2bit(seq[off_c + t]), s.k);
    return s.get(km);
  }
};

Correction correct_one(const KmerSet& s, int c, u64 kmer, const u8* seq,
                       long len) {
  Correction r;
  u64 alts[4];
  if (alt_nucs(s, kmer, alts) != 1) return r;
  u64 corr = add_nuc(kmer >> 2, alts[0], s.k);
  ExistEngine e{s, c};

  bool keep[3], om[3];
  const int offs[3] = {2, 1, 0};  // I, S, D
  for (int i = 0; i < 3; i++) {
    keep[i] = e.score_ok(corr, offs[i], seq, len);
    std::vector<u8> em{bit2nuc(corr & 3)};
    om[i] = e.one_more(corr, em, offs[i], seq, len);
  }
  int nk = keep[0] + keep[1] + keep[2];
  int sel = -1;
  if (nk == 1) {
    for (int i = 0; i < 3; i++)
      if (keep[i]) sel = i;
  } else if (nk > 1) {
    int nk2 = 0;
    for (int i = 0; i < 3; i++)
      if (keep[i] && om[i]) { nk2++; sel = i; }
    if (nk2 != 1) sel = -1;
  }
  if (sel < 0) return r;
  r.ok = true;
  r.bases = {bit2nuc(corr & 3)};
  r.consumed = offs[sel];
  return r;
}

Correction correct_two(const KmerSet& s, int c, u64 kmer, const u8* seq,
                       long len) {
  Correction r;
  u64 alts[4];
  if (alt_nucs(s, kmer, alts) != 1) return r;
  const int k = s.k;
  u64 corr = add_nuc(kmer >> 2, alts[0], k);
  ExistEngine e{s, c};

  auto absorb = [&](u64 km, long idx) {
    return add_nuc(km, nuc2bit(seq[idx]), k);
  };
  auto alt_next = [&](u64 km, bool* ok) -> u64 {
    u64 a[4];
    int n = next_nucs(s, km, a);
    *ok = (n == 1);
    return n == 1 ? add_nuc(km, a[0], k) : km;
  };
  auto alt_last = [&](u64 km, bool* ok) -> u64 {
    u64 a[4];
    int n = alt_nucs(s, km, a);
    *ok = (n == 1);
    return n == 1 ? add_nuc(km >> 2, a[0], k) : km;
  };

  // scenario evaluation table (two.rs:89-256); indices:
  // 0 II,1 IS,2 SS,3 SD,4 DD,5 ICI,6 ICS,7 ICD,8 SCI,9 SCS,10 SCD,11 DCI,12 DCD
  const int APPLY_OFF[13] = {3, 2, 2, 1, 0, 4, 3, 3, 4, 3, 2, 4, 1};
  const int CORR_OFF[13] = {2, 2, 2, 1, 0, 3, 4, 2, 4, 3, 2, 1, 1};
  const int EMIT_N[13] = {1, 1, 2, 2, 2, 1, 2, 2, 3, 3, 3, 0, 3};
  const bool FROM_CORR[13] = {true, true, false, false, false, true, false,
                              false, false, false, false, false, false};
  bool a_ok[13];
  u64 km2[13];
  bool u;
  for (int i = 0; i < 13; i++) { a_ok[i] = false; km2[i] = corr; }
  a_ok[0] = true;                                       // II
  a_ok[1] = true;                                       // IS
  if (len >= 2) {                                       // SS
    u64 t1 = absorb(corr, 1);
    if (!s.get(t1)) { km2[2] = alt_last(t1, &u); a_ok[2] = u; }
  }
  if (len >= 1) { km2[3] = alt_next(corr, &u); a_ok[3] = u; }  // SD
  { km2[4] = alt_next(corr, &u); a_ok[4] = u; }                // DD
  if (len >= 4) {                                       // ICI
    u64 t = absorb(corr, 3);
    if (s.get(t)) { km2[5] = t; a_ok[5] = true; }
  }
  if (len >= 4) {                                       // ICS
    u64 t1 = absorb(corr, 1);
    if (!s.get(t1)) { km2[6] = alt_last(t1, &u); a_ok[6] = u; }
  }
  if (len >= 4) {                                       // ICD
    u64 second = absorb(corr, 2);
    km2[7] = alt_next(second, &u);
    a_ok[7] = u;
  }
  if (len >= 4) { km2[8] = absorb(absorb(corr, 1), 3); a_ok[8] = true; }  // SCI
  if (len >= 3) {                                       // SCS
    u64 t1 = absorb(corr, 1);
    if (s.get(t1)) {
      u64 t2 = absorb(t1, 2);
      if (!s.get(t2)) { km2[9] = alt_last(t2, &u); a_ok[9] = u; }
    }
  }
  if (len >= 2) { km2[10] = alt_next(absorb(corr, 1), &u); a_ok[10] = u; }  // SCD
  if (len >= 4) { km2[11] = absorb(absorb(corr, 1), 3); a_ok[11] = true; }  // DCI
  if (len >= 2) { km2[12] = alt_next(absorb(corr, 0), &u); a_ok[12] = u; }  // DCD

  bool keep[13], om[13];
  std::vector<u8> emits[13];
  for (int i = 0; i < 13; i++) {
    keep[i] = a_ok[i] && e.score_ok(km2[i], APPLY_OFF[i], seq, len);
    u64 src = FROM_CORR[i] ? corr : km2[i];
    for (int t = 0; t < EMIT_N[i]; t++)
      emits[i].push_back(bit2nuc((src >> (2 * (EMIT_N[i] - 1 - t))) & 3));
    om[i] = a_ok[i] && e.one_more(corr, emits[i], CORR_OFF[i], seq, len);
  }
  int nk = 0, sel = -1;
  for (int i = 0; i < 13; i++)
    if (keep[i]) { nk++; sel = i; }
  if (nk == 0) return r;
  if (nk > 1) {
    int nk2 = 0;
    for (int i = 0; i < 13; i++)
      if (keep[i] && om[i]) { nk2++; sel = i; }
    if (nk2 != 1) return r;
  }
  r.ok = true;
  r.bases = emits[sel];
  r.consumed = CORR_OFF[sel];
  return r;
}

// ----------------------------------------------------------------------
// Graph (graph.rs:44-85), GapSize (gap_size.rs:44-108)
// ----------------------------------------------------------------------

Correction correct_graph(const KmerSet& s, u64 kmer, const u8* seq, long len) {
  Correction r;
  long el;
  u64 first_correct;
  error_len(seq, len, kmer, s, &el, &first_correct);

  u64 alts[4];
  if (alt_nucs(s, kmer, alts) != 1) return r;
  std::unordered_set<u64> viewed;
  u64 km = add_nuc(kmer >> 2, alts[0], s.k);
  r.bases.push_back(bit2nuc(alts[0]));
  viewed.insert(km);

  while (s.get(km)) {
    if (next_nucs(s, km, alts) != 1) return Correction{};
    km = add_nuc(km, alts[0], s.k);
    if (viewed.count(km)) return Correction{};
    viewed.insert(km);
    r.bases.push_back(bit2nuc(alts[0]));
    if (km == first_correct) break;
  }
  r.ok = true;
  r.consumed = el + 1;
  return r;
}

Correction ins_sub_correction(const KmerSet& s, u64 kmer, long gap) {
  Correction r;
  u64 alts[4];
  if (alt_nucs(s, kmer, alts) != 1) return r;
  u64 corr = add_nuc(kmer >> 2, alts[0], s.k);
  r.bases.push_back(bit2nuc(alts[0]));
  std::unordered_set<u64> viewed{corr};
  for (long i = 0; i < gap; i++) {
    if (next_nucs(s, corr, alts) != 1) return Correction{};
    corr = add_nuc(corr, alts[0], s.k);
    if (viewed.count(corr)) return Correction{};
    viewed.insert(corr);
    r.bases.push_back(bit2nuc(alts[0]));
  }
  r.ok = true;
  r.consumed = (long)r.bases.size();
  return r;
}

Correction correct_gap(const KmerSet& s, int c, u64 kmer, const u8* seq,
                       long len) {
  long el;
  u64 fc;
  error_len(seq, len, kmer, s, &el, &fc);
  if (el < s.k) return correct_graph(s, kmer, seq, len);
  if (el == s.k) return correct_one(s, c, kmer, seq, len);
  return ins_sub_correction(s, kmer, el - s.k);
}

// ----------------------------------------------------------------------
// Greedy (greedy.rs:41-173) + rust-bio-compatible Gotoh aligner
// (same tie-break contract as br_tpu/correct/alignment.py)
// ----------------------------------------------------------------------

enum Op : int8_t { MATCH = 0, SUBST = 1, DEL = 2, INS = 3, START = 4 };

void global_align_ops(const std::vector<u8>& x, const std::vector<u8>& y,
                      std::vector<int8_t>* ops_out) {
  const int m = (int)x.size(), n = (int)y.size();
  const int GO = -1, GE = -1, MT = 1, MM = -1;
  const int NEG = -(1 << 28);
  auto idx = [n](int i, int j) { return i * (n + 1) + j; };
  std::vector<int> S((m + 1) * (n + 1), NEG), I(S), D(S);
  std::vector<int8_t> sb((m + 1) * (n + 1), START), ib(sb), db(sb);

  S[idx(0, 0)] = 0;
  for (int i = 1; i <= m; i++) {
    I[idx(i, 0)] = GO + i * GE;
    S[idx(i, 0)] = I[idx(i, 0)];
    sb[idx(i, 0)] = INS;
    ib[idx(i, 0)] = i > 1 ? INS : START;
  }
  for (int j = 1; j <= n; j++) {
    D[idx(0, j)] = GO + j * GE;
    S[idx(0, j)] = D[idx(0, j)];
    sb[idx(0, j)] = DEL;
    db[idx(0, j)] = j > 1 ? DEL : START;
  }
  for (int i = 1; i <= m; i++) {
    for (int j = 1; j <= n; j++) {
      int ext = I[idx(i - 1, j)] + GE, opn = S[idx(i - 1, j)] + GO + GE;
      if (ext > opn) { I[idx(i, j)] = ext; ib[idx(i, j)] = INS; }
      else { I[idx(i, j)] = opn; ib[idx(i, j)] = sb[idx(i - 1, j)]; }
      ext = D[idx(i, j - 1)] + GE; opn = S[idx(i, j - 1)] + GO + GE;
      if (ext > opn) { D[idx(i, j)] = ext; db[idx(i, j)] = DEL; }
      else { D[idx(i, j)] = opn; db[idx(i, j)] = sb[idx(i, j - 1)]; }
      int sub = x[i - 1] == y[j - 1] ? MT : MM;
      int best = S[idx(i - 1, j - 1)] + sub;
      int8_t bits = x[i - 1] == y[j - 1] ? MATCH : SUBST;
      if (I[idx(i, j)] > best) { best = I[idx(i, j)]; bits = INS; }
      if (D[idx(i, j)] > best) { best = D[idx(i, j)]; bits = DEL; }
      S[idx(i, j)] = best;
      sb[idx(i, j)] = bits;
    }
  }
  ops_out->clear();
  int i = m, j = n;
  int8_t layer = sb[idx(i, j)];
  while (layer != START) {
    if (layer == INS) { ops_out->push_back(INS); layer = ib[idx(i, j)]; i--; }
    else if (layer == DEL) { ops_out->push_back(DEL); layer = db[idx(i, j)]; j--; }
    else { ops_out->push_back(layer); i--; j--; layer = sb[idx(i, j)]; }
  }
  std::reverse(ops_out->begin(), ops_out->end());
}

bool match_alignement(const std::vector<u8>& before, const u8* read,
                      long read_n, const std::vector<u8>& corr, long* off_out) {
  std::vector<u8> r(before), c(before);
  r.insert(r.end(), read, read + read_n);
  c.insert(c.end(), corr.begin(), corr.end());
  std::vector<int8_t> ops;
  global_align_ops(r, c, &ops);

  long offset = 0;
  for (size_t w = before.size(); w + 1 < ops.size(); w++) {
    int8_t op0 = ops[w], op1 = ops[w + 1];
    if (op0 == DEL) offset -= 1;
    else if (op0 == INS) offset += 1;
    if (op0 == MATCH && op1 == MATCH) {
      long oc = 0;
      for (auto it = ops.rbegin(); it != ops.rend(); ++it) {
        if (*it == DEL) oc -= 1;
        else if (*it == INS) oc += 1;
        else break;
      }
      *off_out = offset - oc;
      return true;
    }
  }
  return false;
}

Correction correct_greedy(const KmerSet& s, int max_search, int nb_validate,
                          u64 kmer, const u8* seq, long len) {
  Correction r;
  const int k = s.k;
  u64 alts[4];
  if (alt_nucs(s, kmer, alts) != 1) return r;

  std::vector<u8> before(k - 1);
  u64 pre = kmer >> 2;
  for (int t = k - 2; t >= 0; t--) { before[t] = bit2nuc(pre & 3); pre >>= 2; }

  std::unordered_set<u64> viewed;
  std::vector<u8> local;
  u64 km = add_nuc(kmer >> 2, alts[0], k);
  local.push_back(bit2nuc(alts[0]));
  viewed.insert(km);

  for (int i = 0; i < max_search; i++) {
    u64 a[4];
    if (next_nucs(s, km, a) == 1) {
      km = add_nuc(km, a[0], k);
      local.push_back(bit2nuc(a[0]));
    }
    if (viewed.count(km)) return Correction{};
    viewed.insert(km);
    if (len < i) return Correction{};
    long off;
    if (match_alignement(before, seq, i, local, &off)) {
      // check_next_kmers over seq[i..]
      if (len - i >= nb_validate) {
        u64 ck = km;
        bool okc = true;
        for (int t = 0; t < nb_validate; t++) {
          ck = add_nuc(ck, nuc2bit(seq[i + t]), k);
          if (!s.get(ck)) { okc = false; break; }
        }
        if (okc) {
          r.ok = true;
          r.bases = local;
          r.consumed = (long)local.size() + off;  // may rewind, like release rust
          return r;
        }
      }
    }
  }
  return Correction{};
}

// ----------------------------------------------------------------------
// The per-read scan state machine (mod.rs:53-107) + the method chain
// ----------------------------------------------------------------------

struct Method {
  int kind;  // 0 one, 1 two, 2 graph, 3 greedy, 4 gap-size
  int confirm, max_search;
};

void correct_scan(const KmerSet& s, const Method& m, const std::vector<u8>& seq,
                  std::vector<u8>* out) {
  const int k = s.k;
  out->clear();
  if ((long)seq.size() < k) { *out = seq; return; }
  out->reserve(seq.size() + 16);

  long i = k;
  u64 kmer = 0;
  for (long t = 0; t < k; t++) {
    kmer = (kmer << 2) | nuc2bit(seq[t]);
    out->push_back(seq[t]);
  }
  bool previous = s.get(kmer);

  while (i < (long)seq.size()) {
    u8 nuc = seq[i];
    kmer = add_nuc(kmer, nuc2bit(nuc), k);
    if (!s.get(kmer) && previous) {
      const u8* sub = seq.data() + i;
      long sublen = (long)seq.size() - i;
      Correction c;
      switch (m.kind) {
        case 0: c = correct_one(s, m.confirm, kmer, sub, sublen); break;
        case 1: c = correct_two(s, m.confirm, kmer, sub, sublen); break;
        case 2: c = correct_graph(s, kmer, sub, sublen); break;
        case 3: c = correct_greedy(s, m.max_search, m.confirm, kmer, sub,
                                   sublen); break;
        default: c = correct_gap(s, m.confirm, kmer, sub, sublen); break;
      }
      if (c.ok) {
        kmer >>= 2;
        for (u8 b : c.bases) {
          kmer = add_nuc(kmer, nuc2bit(b), k);
          out->push_back(b);
        }
        previous = true;
        i += c.consumed;
        if (i < 0) break;  // pathological rewind guard
      } else {
        out->push_back(nuc);
        i += 1;
        previous = false;
      }
    } else {
      previous = s.get(kmer);
      out->push_back(nuc);
      i += 1;
    }
  }
}

}  // namespace

// ----------------------------------------------------------------------
// C ABI
// ----------------------------------------------------------------------

extern "C" {

void* br_create_solid(const u8* bits, u64 nbytes, int k) {
  auto* s = new KmerSet();
  s->k = k;
  s->dense = true;
  s->bits.assign(bits, bits + nbytes);
  return s;
}

void* br_create_hash(const u64* kmers, u64 n, int k) {
  auto* s = new KmerSet();
  s->k = k;
  s->dense = false;
  s->hash.reserve((size_t)(n * 1.5));
  for (u64 i = 0; i < n; i++) s->hash.insert(kmers[i]);
  return s;
}

void br_destroy(void* ctx) { delete static_cast<KmerSet*>(ctx); }

// methods: array of kind codes; chain applied in order; when two_side == 0
// the chain reruns on plain-reversed bytes (src/lib.rs:110-117).
// Returns output length, or -(needed) if out_cap is too small.
long br_correct(void* ctx, const u8* seq, long len, const int* kinds,
                int n_methods, int confirm, int max_search, int two_side,
                u8* out, long out_cap) {
  const KmerSet& s = *static_cast<KmerSet*>(ctx);
  std::vector<u8> cur(seq, seq + len), nxt;
  std::vector<Method> methods;
  for (int i = 0; i < n_methods; i++)
    methods.push_back({kinds[i], confirm, max_search});

  for (auto& m : methods) {
    correct_scan(s, m, cur, &nxt);
    cur.swap(nxt);
  }
  if (!two_side) {
    std::reverse(cur.begin(), cur.end());
    for (auto& m : methods) {
      correct_scan(s, m, cur, &nxt);
      cur.swap(nxt);
    }
    std::reverse(cur.begin(), cur.end());
  }
  if ((long)cur.size() > out_cap) return -(long)cur.size();
  std::memcpy(out, cur.data(), cur.size());
  return (long)cur.size();
}

}  // extern "C"
