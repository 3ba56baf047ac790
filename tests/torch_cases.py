"""Chunks for the differential tests of the port's passes, and the
recorded outputs of the JAX package's passes on them.

Each case is one chunk at the small test geometry (k=13, CHUNK=2^14,
R=32, c=5, ms=7): a genome (its k-mers are the solid set), the chunk's
2-bit codes, and the slot table.  The families are those of
tests/test_engine3.py: uniform errors, a repeat-rich genome, error pairs
planted k+1 apart, dense errors, plus two built for the splice: slots
that the corrected read fills exactly, and a chain of nested repairs
long enough to overflow a site's SLOTS records.  A seventh family,
``long_walk`` (tests/test_engine3.py:142, :267, :289), holds the walks
past the default walk_max: chimeric reads whose graph walk runs ~1500
steps before it declines, a 400-base deletion whose walk accepts after
~400 steps, and a 400-base invalid stretch that gap-size fills; its
slots have the wide profile's headroom.

Compiling ``br_tpu.correct.engine3.make_pass3_fn(13, strategy, ...)`` for
the CPU takes from 12 minutes (``one``) to well over 45 minutes and about
18 GB of host memory (the walk and greedy strategies).  The recordings
therefore run the JAX pass eagerly, op by op under ``jax.disable_jit()``:
every value is an integer, so the eager run gives the compiled program's
outputs (checked against the compiled ``one`` recording), in seconds to
minutes per strategy.  Still far beyond the default tier's budget, so
the JAX outputs are recorded once per strategy in
``golden/torch_<strategy>_pass_k13.npz`` (run this file to write them
again; name strategies to record only those) and the default tier
compares the port against the recordings; the slow tier recomputes them
with JAX and checks the recordings.  The ``graph`` and ``gap-size``
recordings also hold the long-walk family at the wide profile
(walk_max = 2040) under the name ``long_walk_wide``.
``golden/torch_two_stress_k13.npz`` holds br_tpu's ``one`` and ``two``
passes on the two-error stress family (``two_stress_case``; name
``two_stress`` to record it).  ``golden/torch_greedy_rewind_k13.npz``
holds br_tpu's ``greedy`` pass at ms = 8 on ``greedy_rewind_case``, whose
attempts consume a negative count (name ``greedy_rewind``).
``golden/torch_<strategy>_pass_k17.npz`` holds br_tpu's passes at k = 17
(u64 registers) on ``k17_cases``, the walkers' long-walk family also at
walk_max 2040 and greedy also at ms = 15 (name ``<strategy>_k17``).
``golden/torch_hash_k<k>.npz`` (k = 19, 20, 21, 25, 31) holds, for the
reads of ``hash_cases(k)`` and their genome's ``HashSet``, br_tpu's
oracle output with the default chain, both two_side values, and at
k = 21 br_tpu's ``Tpu2Corrector`` output too (name ``hash_k<k>``; the
oracle takes seconds, the large-k engine tens of minutes and tens of GB
of host memory).  br_tpu's batched pass (``make_pass3_fn(batch=True)``,
vmapped over chunks) on ``batch_stack``, three chunks of one genome
against its one bitfield, is ``record_batch``; it is not recorded: run
eagerly, JAX compiles every vmapped while loop as a program of its own,
past 14 GB of host memory for ``one`` (and hung after 37 minutes at
XLA's optimisation level 0), so the slow tier runs it live.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_cases.py \
        [strategy ... two_stress greedy_rewind one_k17 ... hash_k21 ...]
"""

from __future__ import annotations

import os

import numpy as np

from br_tpu_torch.correct.layout import BIG, SLOTS

K, C, MS = 13, 5, 7
CHUNK, R = 1 << 14, 32
STRATEGIES = ("one", "two", "graph", "gap-size", "greedy")
#: strategies whose recording holds the wide-profile long-walk case.
WALKERS = ("graph", "gap-size")
WIDE_WALK_MAX = 2040


def golden_path(strategy: str) -> str:
    return os.path.join(os.path.dirname(__file__), "golden",
                        f"torch_{strategy}_pass_k13.npz")


GOLDEN = golden_path("one")
#: br_tpu's one and two passes on two_stress_case(TWO_STRESS_SEED) at the
#: test geometry, under the names "one" and "two".
TWO_STRESS_GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                                 "torch_two_stress_k13.npz")
TWO_STRESS_SEED = 1
#: br_tpu's greedy pass at ms = MS_REWIND on greedy_rewind_case(), under
#: the name "greedy_rewind".
REWIND_GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                             "torch_greedy_rewind_k13.npz")
MS_REWIND = 8
BASES = np.frombuffer(b"ACTG", np.uint8)
_RC = bytes.maketrans(b"ACGT", b"TGCA")


def repeat_rich_genome(rng, size=4000, k=K):
    """Tandem and inverted repeats (tests/test_engine3.py:27)."""
    core = rng.choice(BASES, size=size).tobytes()
    unit = rng.choice(BASES, size=k + 8).tobytes()
    rc_block = core[500:1200][::-1].translate(_RC)
    return (core[:800] + unit * 6 + core[800:2000] + rc_block
            + core[2000:2600] + unit * 4 + core[2600:])


def fuzz_reads(rng, genome, n_reads, err, k=K, cluster_gap=None,
               max_len=400):
    """Reads of the genome with planted errors (tests/test_engine3.py:45)."""
    reads = []
    for _ in range(n_reads):
        lo = rng.integers(0, len(genome) - max_len - 20)
        ln = int(rng.integers(2 * k + 10, max_len))
        r = bytearray(genome[lo : lo + ln])

        def plant(p):
            op = rng.integers(3)
            if op == 0:
                r[p] = ord("ACTG"[rng.integers(4)])
            elif op == 1 and len(r) > 2 * k + 8:
                del r[p]
            else:
                r.insert(p, ord("ACTG"[rng.integers(4)]))

        for _ in range(err):
            if cluster_gap is not None:
                if len(r) - k - 2 - cluster_gap <= k + 2:
                    break     # too short for a pair
                p = int(rng.integers(k + 2, len(r) - k - 2 - cluster_gap))
                plant(p + cluster_gap)
                plant(p)
            else:
                plant(int(rng.integers(k + 2, len(r) - k - 2)))
        reads.append(bytes(r))
    return reads


def slot_len(n: int, wide: bool = False) -> int:
    """Slot size of the batch corrector (engine3.py:2064); ``wide`` adds the
    wide profile's headroom of a full walk emit."""
    slack = max(64, n // 8)
    if wide:
        slack = max(slack, WIDE_WALK_MAX + 64)
    s = n + slack
    return s + (-s) % 32


def pack(reads, caps=None, rng=None, chunk=CHUNK, nreads=R):
    """(codes, rstart, rlen) of one chunk; ``caps`` overrides slot sizes.
    Slack after each read holds stale random codes (never zeros)."""
    codes = np.zeros(chunk, np.uint8)
    rstart = np.full(nreads, chunk, np.int32)
    rlen = np.zeros(nreads, np.int32)
    rng = rng or np.random.default_rng(0)
    off = 0
    for b, read in enumerate(reads):
        cap = slot_len(len(read)) if caps is None else caps[b]
        assert off + cap <= chunk and b < nreads
        arr = np.frombuffer(read, np.uint8)
        codes[off : off + cap] = rng.integers(0, 4, cap)
        codes[off : off + len(arr)] = (arr >> 1) & 3
        rstart[b] = off
        rlen[b] = len(arr)
        off += cap
    return codes, rstart, rlen


#: the chunk families every strategy's recording holds.
FAMILIES = ("uniform", "repeat_rich", "clustered", "dense", "exact_fill",
            "slot_overflow", "long_walk")


def build_cases():
    """name -> (genome bytes, codes, rstart, rlen); numpy only."""
    cases = {}
    rng = np.random.default_rng(42)
    g = rng.choice(BASES, size=4000).tobytes()
    cases["uniform"] = (g, *pack(fuzz_reads(rng, g, 28, 4), rng=rng))

    rng = np.random.default_rng(123)
    g = repeat_rich_genome(rng)
    cases["repeat_rich"] = (g, *pack(fuzz_reads(rng, g, 28, 5), rng=rng))

    rng = np.random.default_rng(321)
    g = repeat_rich_genome(rng)
    cases["clustered"] = (g, *pack(fuzz_reads(rng, g, 28, 2,
                                              cluster_gap=K + 1), rng=rng))

    rng = np.random.default_rng(77)
    g = rng.choice(BASES, size=4000).tobytes()
    cases["dense"] = (g, *pack(fuzz_reads(rng, g, 28, 10), rng=rng))

    # exact fill: deletions the pass repairs grow each read by its number
    # of repaired deletions; every slot is sized to the corrected length
    rng = np.random.default_rng(5)
    g = rng.choice(BASES, size=4000).tobytes()
    reads = []
    for _ in range(20):
        lo = int(rng.integers(0, 3400))
        r = bytearray(g[lo : lo + int(rng.integers(200, 500))])
        for p in sorted(rng.choice(np.arange(40, len(r) - 40, 60),
                                   size=2, replace=False), reverse=True):
            del r[int(p)]
        reads.append(bytes(r))
    caps = [exact_fill_len(g, r) for r in reads]
    cases["exact_fill"] = (g, *pack(reads, caps=caps, rng=rng))

    # nested repairs 8 bases apart: one chain applies more than SLOTS
    # records and caps its site (CAP_OVERFLOW)
    rng = np.random.default_rng(9)
    g = rng.choice(BASES, size=4000).tobytes()
    reads = []
    for j in range(12):
        lo = int(rng.integers(0, 3400))
        r = bytearray(g[lo : lo + 400])
        for t in range(4 + j):
            p = 60 + 8 * t
            r[p] = ord("ACTG"[("ACTG".index(chr(r[p])) + 1) % 4])
        reads.append(bytes(r))
    cases["slot_overflow"] = (g, *pack(reads, rng=rng))
    return cases


def long_walk_case():
    """The long-walk family: (genome bytes, codes, rstart, rlen)."""
    rng = np.random.default_rng(99)
    gA = rng.choice(BASES, size=2400).tobytes()
    gB = rng.choice(BASES, size=2400).tobytes()
    gap = rng.choice(BASES, size=400).tobytes()
    reads = [gA[100:600] + gB[700:1200],      # chimeras: long declines
             gA[50:1800] + gB[200:900],
             gA[:500] + gA[900:1500],         # 400-base deletion: accept
             gB[:600] + gap + gB[1000:1500]]  # 400 invalid bases: fill
    caps = [slot_len(len(r), wide=True) for r in reads]
    return (gA + gB, *pack(reads, caps=caps, rng=rng))


def all_cases():
    """The six families of ``build_cases`` and the long-walk family."""
    return {**build_cases(), "long_walk": long_walk_case()}


def exact_fill_len(genome: bytes, read: bytes) -> int:
    """Length of ``read`` after one forward ``one`` pass (the port's own
    oracle; the slot of the exact-fill case is exactly this long)."""
    from br_tpu_torch.correct.reference import One
    from br_tpu_torch.set.solid import SolidSet

    solid = SolidSet.from_sequences([genome], K)
    return len(One(solid, C).correct(read))


def pieces_of(g):
    """A case's genome: one sequence, or a list of pieces."""
    return g if isinstance(g, list) else [g]


def jax_pass_outputs(cases, strategy="one", walk_max=None, eager=True,
                     ms=MS, k=K, batch=False):
    """Run br_tpu's pass of ``strategy`` on every case, eagerly unless
    ``eager`` is False (then it compiles for many minutes).  Cases with
    the same genome share one bitfield (1 GiB at k = 17).  With
    ``batch``, br_tpu's batched pass on cases whose arrays are stacks of
    chunks ((NC, CHUNK) codes, (NC, R) slot tables)."""
    import contextlib

    import jax

    from br_tpu.correct.engine3 import make_pass3_fn
    from br_tpu.set.solid import SolidSet

    kw = {} if walk_max is None else {"walk_max": walk_max}
    fn = make_pass3_fn(k, strategy, C, ms, C, CHUNK, R, batch=batch, **kw)
    outs, tables = {}, {}
    for name, (g, codes, rstart, rlen) in cases.items():
        key = tuple(pieces_of(g))
        if key not in tables:
            tables.clear()
            tables[key] = jax.numpy.asarray(
                SolidSet.from_sequences(key, k).device_words())
        # device arrays: eager vmapped code cannot index numpy arrays
        args = [tables[key]] + [jax.numpy.asarray(x) for x in (
            codes, rstart, rlen)]
        with jax.disable_jit() if eager else contextlib.nullcontext():
            o, n, cap, aux, _dl, _dc = fn(*args)
            jax.block_until_ready(o)
        outs[name] = (np.asarray(o) & 3, np.asarray(n), np.asarray(cap),
                      np.asarray(aux))
    return outs


def save_golden(outs, path=GOLDEN):
    arrs = {}
    for name, (o, n, cap, aux) in outs.items():
        arrs[f"{name}/out"] = o.astype(np.uint8)
        arrs[f"{name}/out_len"] = n.astype(np.int32)
        arrs[f"{name}/cap"] = cap.astype(bool)
        arrs[f"{name}/aux"] = aux.astype(np.int32)
    np.savez_compressed(path, **arrs)


def run_port_pass(strategy, case, walk_max=None, device="cpu", ms=MS, k=K,
                  table=None):
    """The port's pass of ``strategy`` on one case: numpy (out, out_len,
    cap, aux); ``table``, when given, is the case genome's bitfield or
    sorted HashSet table."""
    import torch

    from br_tpu_torch.correct.engine3 import make_pass3_fn
    from br_tpu_torch.set.solid import SolidSet

    g, codes, rstart, rlen = case
    if table is None:
        table = SolidSet.from_sequences(pieces_of(g), k).device_words(device)
    kw = {} if walk_max is None else {"walk_max": walk_max}
    fn = make_pass3_fn(k, strategy, C, ms, C, CHUNK, R, **kw)
    out = fn(table, *(torch.from_numpy(x).to(device) for x in (codes, rstart,
                                                               rlen)))
    return tuple(t.cpu().numpy() for t in out)


def assert_matches_recording(got, want, rstart, rlen):
    """Per read: the codes within out_len, out_len and cap; aux entries
    0, 4, 5 and 6 (where JAX's aux[3], CAP_ROUNDS, is 0)."""
    out, n, cap, aux = got
    j_out, j_n, j_cap, j_aux = want
    assert j_aux[3] == 0, "JAX ran out of queue rounds; not comparable"
    assert np.array_equal(n, j_n)
    assert np.array_equal(cap, j_cap)
    for b in np.flatnonzero(rlen > 0):
        lo = rstart[b]
        assert np.array_equal(out[lo : lo + n[b]], j_out[lo : lo + n[b]]), b
    assert np.array_equal(aux[[0, 4, 5, 6]], j_aux[[0, 4, 5, 6]])


def oracle_pair(strategy, genome, k=K, c=C, ms=MS):
    """(port's, br_tpu's) method chain of one strategy on one genome."""
    from br_tpu.correct import reference as J
    from br_tpu.set.solid import SolidSet as JSolidSet
    from br_tpu_torch.correct import reference as P
    from br_tpu_torch.set.solid import SolidSet

    return (P.build_methods([strategy], SolidSet.from_sequences([genome], k),
                            c, ms),
            J.build_methods([strategy], JSolidSet.from_sequences([genome], k),
                            c, ms))


def assert_oracles_agree(strategy, seed, n=50):
    """About 50 seeded fuzz reads, both two_side values: the port's oracle
    gives br_tpu's bytes, and corrects at least one read."""
    from br_tpu.correct import reference as J
    from br_tpu_torch.correct import reference as P

    rng = np.random.default_rng(seed)
    genome = repeat_rich_genome(rng)
    reads = fuzz_reads(rng, genome, n, 4)
    mine, theirs = oracle_pair(strategy, genome)
    changed = 0
    for two_side in (False, True):
        for r in reads:
            want = J.correct_read(r, theirs, two_side)
            assert P.correct_read(r, mine, two_side) == want
            changed += want != r
    assert changed > 0


def assert_catalog_agrees(method):
    """The reference's planted-error catalog (tests/catalog.py) for one
    method: the port's oracle corrects as br_tpu's."""
    from catalog import CASES, build_case_set, build_oracle_corrector, filt

    from br_tpu_torch import codec
    from br_tpu_torch.correct import reference as P
    from br_tpu_torch.set.solid import SolidSet

    seen = 0
    for (name, m, kwargs, k, refe, read, extra, expect) in CASES:
        if m != method:
            continue
        refe, read = filt(refe), filt(read)
        s = SolidSet(k)
        for seq in [refe, *extra]:
            for kmer in codec.tokenize(seq, k):
                s.set(kmer, True)
        c = kwargs.get("c", kwargs.get("nb_validate", 2))
        ms = kwargs.get("max_search", 7)
        mine = P.build_methods([method], s, c, ms)[0]
        theirs = build_oracle_corrector(method, kwargs,
                                        build_case_set(k, refe, extra))
        for x in (read, refe):
            assert mine.correct(x) == theirs.correct(x), name
        assert mine.correct(read) == (refe if expect == "refe" else read), \
            name
        seen += 1
    assert seen >= 3


def record(strategy):
    """The JAX outputs a strategy's recording holds."""
    cases = build_cases() if strategy == "one" else all_cases()
    outs = jax_pass_outputs(cases, strategy)
    if strategy in WALKERS:
        wide = jax_pass_outputs({"long_walk": cases["long_walk"]}, strategy,
                                walk_max=WIDE_WALK_MAX)
        outs["long_walk_wide"] = wide["long_walk"]
    return outs


# ---------------------------------------------------------------------------
# Adversarial inputs of K1 and K3 (numpy, from a seed): the CUDA tests hold
# the kernels against their plain versions on them.
# ---------------------------------------------------------------------------

def stress_slots(rng, chunk, R, first=37, size=(50, 4000)):
    """A slot table of random sizes from the unaligned start ``first``:
    every 7th read is empty, every 5th fills its slot, the others leave
    up to 64 positions of slack; slots past the chunk are unused."""
    rstart = np.full(R, chunk, np.int32)
    rlen = np.zeros(R, np.int32)
    off = first
    for b in range(R):
        cap = int(rng.integers(*size))
        if off + cap > chunk:
            break
        rstart[b] = off
        rlen[b] = (0 if b % 7 == 3 else cap if b % 5 == 1
                   else max(0, cap - int(rng.integers(0, 65))))
        off += cap
    return rstart, rlen


def dense_stress_case(k, seed, chunk=1 << 20, R=512, solid=True):
    """K1's inputs: seeded random codes (bit 2 set at random, as a carried
    V), a seeded random bitfield with about 30 % of its bits set (none if
    not ``solid``: no site in the chunk), and a slot table of random sizes
    from an unaligned start, so that reads straddle K1's tiles.
    Returns (codes, table words int32, rstart, rlen)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 8, chunk, dtype=np.uint8)
    nwords = max(1, (1 << (2 * k - 1)) // 32)

    def word():
        return rng.integers(0, 1 << 32, nwords, dtype=np.uint32)

    if solid:   # (a & b) | (c & d & e & f): 1/4 + 3/4 * 1/16 of the bits
        words = (word() & word()) | (word() & word() & word() & word())
    else:
        words = np.zeros(nwords, np.uint32)
    rstart, rlen = stress_slots(rng, chunk, R)
    return codes, words.view(np.int32), rstart, rlen


def reverse_layouts(seed, chunk=CHUNK):
    """K4's slot tables beyond the planner's (slots at multiples of 32):
    name -> (codes, rstart, rlen), the codes seeded with bit 2 set at
    random.  ``unaligned``: random slots from start 37, empty reads, reads
    that fill their slot, unused slots (rstart = chunk, rlen = 0) after;
    ``short_slots``: 1,024 slots of 1-23 positions, so one warp's 512
    positions hold more than 32 slot starts; ``exact_fill``: every read
    fills its slot, the last runs to the chunk's end; ``past_slot``: reads
    longer than their slot (sources past it, and past the chunk, clamped);
    ``before_first``: the first slot starts at 1,000, after the codes
    before it."""
    rng = np.random.default_rng(seed)

    def codes():
        return rng.integers(0, 8, chunk, dtype=np.uint8)

    def padded(rs, rl, R):
        rstart = np.full(R, chunk, np.int32)
        rlen = np.zeros(R, np.int32)
        rstart[:len(rs)], rlen[:len(rl)] = rs, rl
        return rstart, rlen

    out = {"unaligned": (codes(), *stress_slots(rng, chunk, 64, first=37,
                                                size=(50, 700))),
           "short_slots": (codes(), *stress_slots(rng, chunk, 1024, first=5,
                                                  size=(1, 24)))}
    cuts = np.sort(rng.choice(np.arange(1, chunk), 30, replace=False))
    rs = np.concatenate([[0], cuts])
    out["exact_fill"] = (codes(), *padded(rs, np.diff(rs, append=chunk), 40))
    rs = np.array([0, 1000, 1040, chunk - 300])
    out["past_slot"] = (codes(), *padded(rs, [800, 900, 41, 700], 8))
    rs = np.arange(1000, chunk - 600, 600)
    out["before_first"] = (codes(), *padded(rs, [int(x) for x in
                                                 rng.integers(0, 600,
                                                              len(rs))], 32))
    return out


def splice_len(rs, rend, lo, hi, succ, rec_p, rec_c, rec_s, chunk):
    """A read's spliced length (body + tail) by the chain rule of K3."""
    x, pe, body = lo, rs, 0
    while x < hi:
        for s in range(SLOTS):
            p = int(rec_p[x * SLOTS + s])
            if p < BIG:
                body += min(max(p - pe, 0), chunk) + int(rec_c[x * SLOTS + s])
                pe = p + int(rec_s[x * SLOTS + s])
        nx = int(succ[x])
        if nx <= x:
            break
        x = nx
    return body + rend - pe


def splice_stress_case(seed, ew, chunk=1 << 20, R=64, full=False):
    """K3's inputs on a synthetic site table: ``full`` gives one read all
    NS listed sites (and n_sites past NS), else reads of 0 to 3000 sites
    (many K3 windows), reads without sites and empty reads.  Successors go
    to the next site, skip a few (sites off the chain) or jump 600-1600
    sites (over whole windows); in even reads the chain may also end
    mid-window (a successor at or below the site, NS, or past the read's
    last site).  Some reads have capped sites, on the chain or off it.  A
    site uses a random subset of its 8 record slots (unused entries hold
    garbage); a record's emit is ``ew`` words, up to 16*ew - 7 bases (2041
    at ew=128); every 4th read's records may overlap (negative verbatim
    lengths).  Read 3 fills its slot exactly, read 5 overflows it, the
    last two slots are unused; ``cap_dense`` is random but for read 3,
    and in ``full`` read 1 is capped as K1 caps a read with sites past
    NS.  Returns (codes, rstart, rlen, s_pos,
    n_sites, (succ, s_cap, rec_p, rec_c, rec_s, rec_e), cap_dense)."""
    rng = np.random.default_rng(seed)
    NS = max(2048, chunk // 32)
    codes = rng.integers(0, 8, chunk, dtype=np.uint8)
    succ = np.full(NS, NS, np.int32)
    s_cap = np.zeros(NS, np.int32)
    rec_p = np.full(NS * SLOTS, BIG, np.int32)
    rec_c = rng.integers(-3, 3000, NS * SLOTS).astype(np.int32)
    rec_s = rng.integers(-3, 3000, NS * SLOTS).astype(np.int32)
    rec_e = rng.integers(-(1 << 31), 1 << 31, (NS * SLOTS, ew),
                         dtype=np.int64).astype(np.int32)
    rstart = np.full(R, chunk, np.int32)
    rlen = np.zeros(R, np.int32)
    s_pos = np.full(NS, BIG, np.int32)
    cmax = 16 * ew - 7 if ew > 1 else 16
    if full:
        plan = [0, NS, 5, 0]
    else:
        plan = [0, 1, 7, 3000, 512, 513, 511, 1500, 0, 2, 1200]
        plan += [int(x) for x in rng.integers(0, 700, R)]
    off, base = 11, 0
    for b, ns in enumerate(plan[:R - 2]):   # the last two slots unused
        ns = min(ns, NS - base)
        n = 0 if b == 0 else ns * 20 + int(rng.integers(1, 200))
        if off + n + 64 > chunk:
            break
        rs = off
        # sites at least 8 apart, so that most verbatim lengths are >= 0
        pos = rs + 8 * np.sort(rng.choice(n // 8, ns, replace=False))
        hi = base + ns
        ends = 0.006 if b % 2 == 0 else 0.0   # odd reads: no early end
        # records of one site stay within the 8 positions before the
        # next site, but for every 4th read (negative verbatim lengths)
        tight = b % 4 != 0
        for i, p in enumerate(pos):
            x = base + i
            s_pos[x] = p
            u = rng.random()
            nx = (x - int(rng.integers(0, 3)) if u < ends / 3 else
                  NS if u < 2 * ends / 3 else
                  hi + int(rng.integers(0, 3)) if u < ends else
                  x + int(rng.integers(600, 1600)) if u < ends + 0.001 else
                  x + int(rng.integers(2, 6)) if u < 0.12 else x + 1)
            succ[x] = min(max(nx, 0), NS)
            if b % 4 == 2 and rng.random() < 0.01:
                s_cap[x] = rng.choice([1, 2, 4])
            nrec = rng.choice(9, p=[.35, .45] + [.2 / 7] * 7)
            q = p
            for s in np.sort(rng.choice(SLOTS, nrec, replace=False)):
                q += int(rng.integers(0, 2))
                c = int(rng.integers(0, 3))
                if q + c > min(p + 7, rs + n) and tight:
                    break
                e = x * SLOTS + s
                rec_p[e] = min(q, rs + n - 1)
                rec_s[e] = c
                q += c
                big_emit = ew > 1 and rng.random() < 0.01
                rec_c[e] = (cmax - int(rng.integers(0, 3)) if big_emit
                            else rng.integers(0, min(cmax, 30) + 1))
        if b == 2 and ns >= 4:   # a capped site off the chain
            succ[base : base + 2] = base + 1, base + 3
            s_cap[base + 2] = 2
        L = splice_len(rs, rs + n, base, hi, succ, rec_p, rec_c, rec_s,
                       chunk) if n else 0
        cap = max(n, L)
        if b == 5 and n:
            cap = max(n, L - 5)          # overflows its slot
        elif b != 3:                     # read 3 fills its slot exactly
            cap += int(rng.integers(0, 40))
        if off + cap > chunk:
            s_pos[base:hi] = BIG
            break
        rstart[b], rlen[b] = rs, n
        off += cap
        base = hi
    n_sites = np.array([base + (17 if full else 0)], np.int32)
    cap_dense = rng.random(R) < 0.05
    cap_dense[3] = False
    if full:   # read 1 has sites of rank >= NS: K1's cap_read caps it
        cap_dense[1] = True
    return (codes, rstart, rlen, s_pos, n_sites,
            (succ, s_cap, rec_p, rec_c, rec_s, rec_e), cap_dense)


# ---------------------------------------------------------------------------
# Adversarial inputs of K6 and K7 (numpy, from a seed): the CUDA tests hold
# the kernels against their plain versions on them, and chip_smoke.py times
# K6 on a long-walk chunk built the same way.
# ---------------------------------------------------------------------------

class BranchFree:
    """Genome pieces on which every de Bruijn walk is unique: each base is
    drawn so that the new k-mer (and its reverse complement) is new, gives
    no solid k-mer a second successor, and has no solid successor yet.
    ``solid`` holds both orientations of every k-mer drawn, and of pieces
    given up, so it only ever over-approximates the solid set."""

    def __init__(self, rng, k=K):
        self.rng, self.k = rng, k
        self.mask, self.top = (1 << 2 * k) - 1, 2 * (k - 1)
        self.solid = set()
        self.pieces = []

    def _fwd(self, x, b):
        return ((x << 2) & self.mask) | b

    def _rc_fwd(self, rx, b):
        return (rx >> 2) | ((b ^ 2) << self.top)

    def _fits(self, x, rx, prev, rprev, succ_ok=(), rpred_ok=()):
        s = self.solid
        if x in s:
            return False
        for a in range(4):
            hi = a << self.top
            if (hi | (x >> 2)) in s and (hi | (x >> 2)) != prev:
                return False          # a solid k-mer would branch to x
            if self._fwd(x, a) in s and self._fwd(x, a) not in succ_ok:
                return False          # x would start with a successor
            if (hi | (rx >> 2)) in s and (hi | (rx >> 2)) not in rpred_ok:
                return False
            if self._fwd(rx, a) in s and self._fwd(rx, a) != rprev:
                return False
        return True

    def _add(self, x, rx):
        self.solid.add(x)
        self.solid.add(rx)

    def line(self, n):
        """n codes drawn base by base; None if a base had no choice."""
        k, rng = self.k, self.rng
        codes = [int(c) for c in rng.integers(0, 4, k - 1)]
        x = rx = 0
        for c in codes:
            x, rx = self._fwd(x, c), self._rc_fwd(rx, c)
        prev = rprev = None
        while len(codes) < n:
            for b in rng.permutation(4):
                b = int(b)
                nx, nrx = self._fwd(x, b), self._rc_fwd(rx, b)
                if self._fits(nx, nrx, prev, rprev):
                    break
            else:
                return None
            self._add(nx, nrx)
            codes.append(b)
            x, rx, prev, rprev = nx, nrx, nx, nrx
        return np.array(codes, np.uint8)

    def piece(self, n):
        """A linear piece of n codes."""
        while True:
            c = self.line(n)
            if c is not None:
                self.pieces.append(c)
                return c

    def cycle(self, period):
        """A tandem repeat unit U of ``period`` codes whose cyclic k-mers
        are all solid: the piece is U + U[:k-1], and a walk that enters it
        revisits its first k-mer ``period`` steps later."""
        k = self.k
        while True:
            u = self.line(period)
            if u is None:
                continue
            x = rx = 0
            for c in u[period - k:]:
                x, rx = self._fwd(x, int(c)), self._rc_fwd(rx, int(c))
            first = rfirst = 0
            for c in u[:k]:
                first = self._fwd(first, int(c))
                rfirst = self._rc_fwd(rfirst, int(c))
            ok, new = True, []
            for t in range(k - 1):   # the k-mers across the seam
                nx, nrx = self._fwd(x, int(u[t])), self._rc_fwd(rx, int(u[t]))
                last = t == k - 2
                if not self._fits(nx, nrx, x, rx,
                                  succ_ok=(first,) if last else (),
                                  rpred_ok=(rfirst,) if last else ()):
                    ok = False
                    break
                self._add(nx, nrx)
                new.append(nx)
                x, rx = nx, nrx
            if ok:
                piece = np.concatenate([u, u[:k - 1]])
                self.pieces.append(piece)
                return u

    def genome(self):
        """The pieces as the byte sequences of the solid set."""
        return [BASES[p].tobytes() for p in self.pieces]


def _stress_chunk(reads, wide_slots, rng, chunk, nreads):
    """Pack reads (code arrays) into a chunk, as many as fit."""
    reads = [BASES[r].tobytes() for r in reads]
    caps, used = [], 0
    for r in reads[:nreads]:
        cap = slot_len(len(r), wide_slots)
        if used + cap > chunk:
            break
        caps.append(cap)
        used += cap
    return pack(reads[:len(caps)], caps, rng, chunk, nreads)


def walk_stress_case(seed, walk_max=248, chunk=CHUNK, nreads=R,
                     wide_slots=False, deletions=(100, 400), long_period=None,
                     flanks=(40, 200)):
    """K6's inputs at one walk profile (or several: ``walk_max`` may be a
    tuple): (genome pieces, codes, rstart, rlen).  A branch-free genome (every walk unique) and reads of these
    kinds, first one of each boundary case, then drawn in turn:
    - a deletion of D bases: the graph walk accepts after D + k - 1 steps;
      D = walk_max - k + {0, 1, 2} reaches walk_max (cap over accept) or
      passes it (Brent, then CAP), the others from ``deletions``;
    - a stretch of L random bases in place of L genome bases: err_len =
      L + k - 1 (the V scan), gap-size fills L - 1 steps (L = walk_max
      + {0, 1, 2} at the cap, others 33-300: error stretches over 32);
    - a read that ends inside such a stretch near the genome's end (the V
      scan reaches the read end), and a substitution (err_len == k:
      gap-size's One attempt);
    - sixteen 3-base deletions 18 bases apart: each graph repair nests in
      the last one's dirty window, and the site passes SLOTS records;
    - a chimera whose left part ends inside a tandem repeat of period P:
      its walk revisits its first k-mer at step P, for P = 31, 32, 33,
      walk_max - 1, walk_max, walk_max + 1 (Brent past walk_max) and
      ``long_period``.
    The bases around each error, before and after, are ``flanks`` long."""
    rng = np.random.default_rng(seed)
    bf = BranchFree(rng)
    k = K
    wms = (walk_max,) if isinstance(walk_max, int) else tuple(walk_max)
    dmax = max(deletions[1], max(wms) - k + 3)
    g = bf.piece(dmax + 2 * flanks[1] + 800)
    periods = [31, 32, 33] + [w + d for w in wms for d in (-1, 0, 1)]
    periods += [long_period] if long_period else []
    units = {p: bf.cycle(p) for p in periods}
    plan = ([("del", w - k + d) for w in wms for d in (0, 1, 2)]
            + [("fill", w + d) for w in wms for d in (0, 1, 2)]
            + [("cyc", p) for p in periods] + [("end", 40), ("sub", 0),
                                               ("nest", 18)])
    n = 0
    while len(plan) < nreads:
        kind = ("del", "fill", "cyc", "end", "sub", "cyc")[n % 6]
        plan.append((kind, int(rng.integers(*deletions)) if kind == "del"
                     else int(rng.integers(33, 300)) if kind in ("fill",
                                                                 "end")
                     else periods[int(rng.integers(len(periods)))]))
        n += 1
    reads = []
    for kind, x in plan[:nreads]:
        f1, f2 = (int(v) for v in rng.integers(*flanks, 2))
        if kind == "del":
            p = int(rng.integers(f1, len(g) - x - f2))
            r = np.concatenate([g[p - f1:p], g[p + x:p + x + f2]])
        elif kind == "fill":
            p = int(rng.integers(f1, len(g) - x - f2))
            junk = rng.integers(0, 4, x).astype(np.uint8)
            r = np.concatenate([g[p - f1:p], junk, g[p + x:p + x + f2]])
        elif kind == "end":      # the graph walk runs off the genome soon
            p = len(g) - int(rng.integers(60, 200))
            f1 = min(f1, p)
            r = np.concatenate([g[p - f1:p],
                                rng.integers(0, 4, x).astype(np.uint8)])
        elif kind == "nest":     # 3-base deletions x apart, nested
            p = int(rng.integers(f1, len(g) - 16 * (x + 3) - f2))
            r = g[p - f1:p + 16 * (x + 3) + f2].copy()
            for q in range(f1 + 15 * x, f1 - 1, -x):
                r = np.delete(r, [q, q + 1, q + 2])
        elif kind == "sub":
            p = int(rng.integers(f1, len(g) - f2))
            r = g[p - f1:p + f2].copy()
            r[f1] ^= int(rng.integers(1, 4))
        else:                    # chimera into a tandem repeat of period x
            rep = np.tile(units[x], (f1 + x) // x + 2)
            q = int(rng.integers(f1, f1 + x))
            y = int(rng.integers(0, len(g) - f2))
            r = np.concatenate([rep[q - f1 + 1:q + 1], g[y:y + f2]])
        reads.append(r)
    return (bf.genome(),
            *_stress_chunk(reads, wide_slots, rng, chunk, nreads))


def greedy_stress_case(seed, chunk=CHUNK, nreads=R):
    """K7's inputs: (genome pieces, codes, rstart, rlen).  Reads of a
    branch-free genome (walks run ms steps) carrying an error cluster
    every 40-60 bases: up to 11 substitutions, deletions and insertions
    of 1-5 bases within 8 bases, so that every step it = 0..ms-1 decides
    somewhere (and DP cells tie between Match, Ins and Del); one read in
    five runs up to the genome's last base (the walk fails at step 0)
    and ends 1-12 bases after its last cluster (rem < it: the read ends
    inside the walk or its validation); one in five is of a repeat-rich
    genome (walks branch and revisit); one in seven starts with twelve
    2-base deletions 11 bases apart, nested repairs that pass SLOTS
    records."""
    rng = np.random.default_rng(seed)
    bf = BranchFree(rng)
    clean = bf.piece(4000)
    rich = np.frombuffer(repeat_rich_genome(rng), np.uint8)
    rich = ((rich >> 1) & 3).astype(np.uint8)
    pieces = bf.genome() + [BASES[rich].tobytes()]

    def cluster(r, p):
        for _ in range(int(rng.integers(1, 12))):
            q = min(p + int(rng.integers(0, 8)), len(r) - 1)
            n = int(rng.integers(1, 6))
            op = int(rng.integers(3))
            if op == 0:
                r[q:q + n] ^= rng.integers(1, 4, len(r[q:q + n])).astype(
                    np.uint8)
            elif op == 1:
                r = np.delete(r, range(q, min(q + n, len(r) - 1)))
            else:
                r = np.insert(r, q, rng.integers(0, 4, n).astype(np.uint8))
        return r

    reads, b = [], 0
    while len(reads) < nreads:
        g = rich if b % 5 == 4 else clean
        ln = int(rng.integers(300, 600))
        lo = len(g) - ln if b % 5 == 3 else int(rng.integers(0, len(g) - ln))
        r = g[lo:lo + ln].copy()
        p = int(rng.integers(K + 2, 30))
        if b % 7 == 6:          # 2-base deletions 11 apart: nested repairs
            for q in range(p + 11 * 11, p - 1, -11):
                r = np.delete(r, [q, q + 1])
            p += 160
        while p < len(r) - 40:
            r = cluster(r, p)
            p += int(rng.integers(40, 60))
        if b % 5 == 3:           # errors in the genome's last bases
            r = cluster(r, len(r) - int(rng.integers(2, 12)))
            r = r[:len(r) - int(rng.integers(0, 3))]
        elif b % 5 == 2:         # the read ends inside the walk
            r = cluster(r, len(r) - 30)[:len(r) - 30 + int(rng.integers(
                3, 13))]
        reads.append(r)
        b += 1
    return (pieces, *_stress_chunk(reads, False, rng, chunk, nreads))


# ---------------------------------------------------------------------------
# Adversarial inputs of K2 and K5 (numpy, from a seed): the CUDA tests hold
# the kernels against their plain versions on them, and the CPU tests hold
# the port's one and two passes against br_tpu's recorded passes.
# ---------------------------------------------------------------------------

#: two-error patterns of exist/two.rs's scenarios, as edits of the genome
#: at p: (offset, op) with op "S" (substitute), "I" (insert a random base
#: before it) or "D" (delete it); the scenarios' names read X C Y, C a
#: correct base between the two errors.
TWO_PATTERNS = {
    "II": ((0, "I"), (0, "I")), "IS": ((0, "I"), (0, "S")),
    "SS": ((0, "S"), (1, "S")), "SD": ((0, "S"), (1, "D")),
    "DD": ((0, "D"), (1, "D")), "ICI": ((0, "I"), (1, "I")),
    "ICS": ((0, "I"), (1, "S")), "ICD": ((0, "I"), (1, "D")),
    "SCI": ((0, "S"), (2, "I")), "SCS": ((0, "S"), (2, "S")),
    "SCD": ((0, "S"), (2, "D")), "DCI": ((0, "D"), (2, "I")),
    "DCD": ((0, "D"), (2, "D")), "I": ((0, "I"),), "S": ((0, "S"),),
    "D": ((0, "D"),),
}


def plant(rng, r, p, pattern):
    """The read r (codes) with one of TWO_PATTERNS planted at p."""
    r = r.copy()
    for off, op in sorted(TWO_PATTERNS[pattern], reverse=True):
        q = p + off
        if op == "S":
            r[q] ^= np.uint8(rng.integers(1, 4))
        elif op == "D":
            r = np.delete(r, q)
        else:
            r = np.insert(r, q, np.uint8(rng.integers(0, 4)))
    return r


def _crafted_two(rng, kind):
    """(read, genome pieces) where an inserted base E at i, after the
    bases b of piece A, has several perfect scenarios: SCI and DCI score
    alike (the same candidate and APPLY_OFF), A holding b, X', r1, r3,
    ..., r8 and then Q; piece B (Z, b's last 7 bases, r1, r2, ...) makes
    DCI's one_more solid ("DCI": it alone, so it applies; "DCI-two": Q =
    r9 makes SCI's solid too; "DCI-none": no B, neither).  "II": A holds
    b, X', r3, ..., r7, Q, so II alone scores perfect."""
    pre = rng.integers(0, 4, 40).astype(np.uint8)   # ends with b
    r = rng.integers(0, 4, 60).astype(np.uint8)     # r[j] is r_j+1
    x = np.uint8((pre[-1] + rng.integers(1, 4)) % 4)
    e = np.uint8((x + rng.integers(1, 4)) % 4)
    if kind == "II":
        core = np.concatenate([[x], r[2:7]])
        q = (r[7] + 1) % 4
    else:
        core = np.concatenate([[x, r[0]], r[2:8]])
        q = r[8] if kind == "DCI-two" else (r[8] + 1) % 4
    tail = rng.integers(0, 4, 20)
    a = np.concatenate([pre, core, [q], tail]).astype(np.uint8)
    pieces = [a]
    if kind != "DCI-none":
        z = (pre[-12:-7] + 1) % 4
        pieces.append(np.concatenate([z, pre[-7:], r]).astype(np.uint8))
    return np.concatenate([pre, [e], r]).astype(np.uint8), pieces


def two_stress_case(seed, chunk=CHUNK, nreads=R):
    """K2's and K5's inputs: (genome pieces, codes, rstart, rlen).  A
    random genome at k = 13 with short tandem repeats (periods 1-6, 4-12
    units) every 30-70 bases, and reads of it carrying, every 30-50 bases,
    one of TWO_PATTERNS (the 13 two-error scenarios and single I/S/D
    errors), near the repeats or inside them, so that several scenarios
    score perfect at one site.  In turn a read also: ends 0-5 bases after
    its last pattern (every rem gate, and the window past the read end
    into the next slot); carries twelve substitutions or substitution
    pairs 8 bases apart (nested repairs closer than k, more than SLOTS of
    them: CAP_OVERFLOW); or is one of ``_crafted_two``'s (ties broken by
    one one_more, ties with none or two, DCI and II selected).  The last
    read fills the chunk's last slot to position chunk - 1 (code_at's
    clip)."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(120):
        parts.append(rng.integers(0, 4, int(rng.integers(30, 70))))
        unit = rng.integers(0, 4, int(rng.integers(1, 7)))
        parts.append(np.tile(unit, int(rng.integers(4, 13))))
    g = np.concatenate(parts).astype(np.uint8)
    pieces = [g]
    names = list(TWO_PATTERNS)
    crafted = ("DCI", "DCI-none", "DCI-two", "II")
    reads, b = [], 0
    while len(reads) < nreads:
        if b % 8 == 7:
            r, more = _crafted_two(rng, crafted[(b // 8) % len(crafted)])
            pieces += more
            reads.append(r)
            b += 1
            continue
        ln = int(rng.integers(200, 420))
        lo = int(rng.integers(0, len(g) - ln))
        r = g[lo:lo + ln].copy()
        p = int(rng.integers(K + 2, 30))
        if b % 8 in (2, 5):     # substitutions or pairs 8 apart: nested
            for _ in range(12):
                r = plant(rng, r, p, "S" if b % 8 == 2 else "SS")
                p += 8
            p += K + 20
        last = p
        while p < len(r) - 30:
            r = plant(rng, r, p, names[int(rng.integers(len(names)))])
            last = p
            p += int(rng.integers(30, 51))
        if b % 3 == 1:          # the read ends 0-5 bases after its pattern
            r = r[:last + (b // 3) % 6]
        reads.append(r)
        b += 1
    codes = [BASES[x].tobytes() for x in reads]
    caps, used = [], 0
    for x in codes:
        cap = slot_len(len(x))
        if used + cap > chunk or len(caps) == nreads:
            break
        caps.append(cap)
        used += cap
    caps[-1] = len(codes[len(caps) - 1])     # the last read ends the chunk
    caps[-2] += chunk - sum(caps)
    out = pack(codes[:len(caps)], caps, rng, chunk, nreads)
    return ([BASES[x].tobytes() for x in pieces], *out)


def record_attempts(module, names):
    """A context that wraps the plain functions ``names`` of ``module`` so
    that each call's arguments and results are appended to a list: the
    CPU tests read what the plain walk and greedy attempts did."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        calls = {n: [] for n in names}
        saved = {n: getattr(module, n) for n in names}

        def wrap(n, fn):
            def rec(*args):
                out = fn(*args)
                calls[n].append((args, out))
                return out
            return rec
        try:
            for n in names:
                setattr(module, n, wrap(n, saved[n]))
            yield calls
        finally:
            for n, fn in saved.items():
                setattr(module, n, fn)
    return ctx()


def load_golden(path=GOLDEN):
    z = np.load(path)
    names = sorted({key.split("/")[0] for key in z.files})
    return {n: (z[f"{n}/out"], z[f"{n}/out_len"], z[f"{n}/cap"],
                z[f"{n}/aux"]) for n in names}


#: a greedy attempt whose accepted alignment rewinds the read: before B
#: (k - 1 = 12 bases), read bases A and path C at step 7 align as B
#: matched, C's six Gs deleted, AAA matched, TTTT inserted; the first
#: Match pair follows 6 Dels, the trailing run is 4 Ins, so the offset of
#: reference.py:524-552 is -6 - 4 = -10 and consumed = 9 - 10 = -1
#: (ROADMAP C2).  The first such step found is step 7, so it needs
#: ms >= 8.
REWIND_B, REWIND_A, REWIND_C = b"GAAAGTAAGCCT", b"AAATTTT", b"GGGGGGAAA"


def greedy_rewind_case(seed=5, n=3):
    """``n`` reads whose greedy attempt at ms = MS_REWIND consumes -1
    positions (each a random start, B, then A where the genome has C,
    then the genome's random continuation, so that the step-7 k-mers
    validate), and fuzz reads of a random genome beside them.  Returns
    (genome pieces, codes, rstart, rlen) at the test geometry."""
    rng = np.random.default_rng(seed)
    pieces, reads = [], []
    for _ in range(n):
        pre = rng.choice(BASES, 40).tobytes()
        cont = rng.choice(BASES, 80).tobytes()
        pieces.append(pre + REWIND_B + REWIND_C + cont)
        reads.append(pre + REWIND_B + REWIND_A + cont)
    g = rng.choice(BASES, 3000).tobytes()
    reads += fuzz_reads(rng, g, 8, 3)
    return [*pieces, g], *pack(reads, rng=rng)


#: k = 17 (u64 registers): one genome for every case, so that a test
#: file builds its 1 GiB bitfield once.
K17 = 17
#: greedy's search lengths recorded at k = 17: the default, and the
#: largest br_tpu takes (ms + 1 <= 16), whose DP has Lc = ms + 17 columns.
MS17 = (MS, 15)


def golden_path_k17(strategy: str) -> str:
    return os.path.join(os.path.dirname(__file__), "golden",
                        f"torch_{strategy}_pass_k17.npz")


def k17_cases():
    """The k = 17 families on one genome of three pieces: name ->
    (pieces, codes, rstart, rlen) at the test geometry.  ``mixed``: reads
    with uniform errors, of a repeat-rich genome, with error pairs k+1
    apart, with dense errors, and with nested substitutions 8 apart past
    SLOTS; ``long_walk``: chimeras, a 400-base deletion and a 400-base
    random stretch, in slots with the wide profile's headroom."""
    return kmer_cases(K17, 1717)


def kmer_cases(k: int, seed: int):
    """``k17_cases``'s families at k, drawn from ``seed`` (the card tests
    of the sorted-table kernels take them at k = 13, 21 and 31)."""
    rng = np.random.default_rng(seed)
    g1 = rng.choice(BASES, size=4000).tobytes()
    g2 = repeat_rich_genome(rng, k=k)
    gA = rng.choice(BASES, size=2400).tobytes()
    gB = rng.choice(BASES, size=2400).tobytes()
    gap = rng.choice(BASES, size=400).tobytes()
    reads = (fuzz_reads(rng, g1, 8, 4, k=k)
             + fuzz_reads(rng, g2, 8, 5, k=k)
             + fuzz_reads(rng, g2, 5, 2, k=k, cluster_gap=k + 1)
             + fuzz_reads(rng, g1, 4, 10, k=k))
    for j in range(3):
        lo = int(rng.integers(0, 3400))
        r = bytearray(g1[lo : lo + 400])
        for t in range(9 + 2 * j):
            p = 60 + 8 * t
            r[p] = ord("ACTG"[("ACTG".index(chr(r[p])) + 1) % 4])
        reads.append(bytes(r))
    pieces = [g1, g2, gA + gB]
    walks = [gA[100:600] + gB[700:1200], gA[50:1800] + gB[200:900],
             gA[:500] + gA[900:1500], gB[:600] + gap + gB[1000:1500]]
    caps = [slot_len(len(r), wide=True) for r in walks]
    return {"mixed": (pieces, *pack(reads, rng=rng)),
            "long_walk": (pieces, *pack(walks, caps=caps, rng=rng))}


def record_k17(strategy):
    """br_tpu's pass of ``strategy`` at k = 17 on ``k17_cases``: the
    walkers' long-walk family also at walk_max 2040 (``long_walk_wide``),
    greedy also at ms = 15 (``mixed_ms15``).  Eagerly, as at k = 13."""
    cases = k17_cases()
    if strategy not in WALKERS:
        cases.pop("long_walk")
    outs = jax_pass_outputs(cases, strategy, k=K17)
    if strategy in WALKERS:
        outs["long_walk_wide"] = jax_pass_outputs(
            {"long_walk": cases["long_walk"]}, strategy,
            walk_max=WIDE_WALK_MAX, k=K17)["long_walk"]
    if strategy == "greedy":
        outs["mixed_ms15"] = jax_pass_outputs(
            {"mixed": cases["mixed"]}, strategy, ms=MS17[1],
            k=K17)["mixed"]
    return outs


def batch_stack():
    """One stack of three chunks over one genome (the pieces of
    ``kmer_cases(K, 1313)``): its ``mixed`` and ``long_walk`` chunks and a
    chunk of six fuzz reads of the chimeras' piece, most of its slots
    unused.  Returns (pieces, codes (3, CHUNK), rstart (3, R), rlen (3,
    R))."""
    cases = kmer_cases(K, 1313)
    rng = np.random.default_rng(1314)
    pieces = cases["mixed"][0]
    third = pack(fuzz_reads(rng, pieces[2], 6, 4), rng=rng)
    chunks = [cases["mixed"][1:], cases["long_walk"][1:], third]
    return (pieces, *(np.stack([ch[j] for ch in chunks]) for j in range(3)))


def record_batch(strategy, walk_max=None):
    """br_tpu's batched pass of ``strategy`` on ``batch_stack``: numpy
    (out, out_len, cap, aux), each with a leading chunk axis."""
    return jax_pass_outputs({"batch": batch_stack()}, strategy,
                            walk_max=walk_max, batch=True)["batch"]


def record_greedy_rewind():
    """br_tpu's greedy pass at ms = MS_REWIND on greedy_rewind_case()
    (about half a minute, eagerly)."""
    return jax_pass_outputs({"greedy_rewind": greedy_rewind_case()},
                            "greedy", ms=MS_REWIND)


def record_two_stress():
    """br_tpu's one and two passes on the two-error stress family."""
    case = {"two_stress": two_stress_case(TWO_STRESS_SEED)}
    return {st: jax_pass_outputs(case, st)["two_stress"]
            for st in ("one", "two")}


#: the large k of the HashSet corrector tests (one even), and the k at
#: which br_tpu's Tpu2Corrector is recorded beside its oracle
HASH_KS = (19, 20, 21, 25, 31)
HASH_ENGINE_K = 21
#: the chunk of the large-k corrector tests (2^12 positions)
HASH_CHUNK = 1 << 12
FULL = ["one", "two", "graph", "greedy", "gap-size"]


def hash_golden_path(k: int) -> str:
    return os.path.join(os.path.dirname(__file__), "golden",
                        f"torch_hash_k{k}.npz")


def hash_cases(k: int):
    """(genome, reads) of the large-k corrector tests at k: fuzz reads of
    a 6 kb random genome; a read whose substitutions 8 apart nest past
    SLOTS records (its site caps, on the wide retry too, so the native
    engine corrects it); an impure read; a read too long for a chunk of
    HASH_CHUNK positions."""
    rng = np.random.default_rng(2000 + k)
    g = rng.choice(BASES, size=6000).tobytes()
    reads = fuzz_reads(rng, g, 8, 3, k=k)
    lo = int(rng.integers(0, 5000))
    r = bytearray(g[lo : lo + 400])
    for t in range(11):
        p = 60 + 8 * t
        r[p] = ord("ACTG"[("ACTG".index(chr(r[p])) + 1) % 4])
    reads.append(bytes(r))
    reads.append(g[:300] + b"N" + g[301:700])
    reads.append(g[:4000])
    return g, reads


def hash_of_solid(solid):
    """The port's HashSet holding exactly the canonical k-mers of a
    SolidSet: bit idx of the bitfield is the canonical k-mer whose
    popcount is even and whose top 2k-1 bits are idx."""
    from br_tpu_torch import codec
    from br_tpu_torch.set.hash import HashSet

    idx = np.flatnonzero(np.unpackbits(solid.bits, bitorder="little"))
    idx = idx.astype(np.uint64)
    low = codec.popcount_np(idx) & np.uint64(1)
    return HashSet(solid.k, ((idx << np.uint64(1)) | low).tolist())


def record_hash(k: int, engine: bool = True):
    """br_tpu's Tpu2Corrector (where ``engine``) and its oracle on
    hash_cases(k) with the default chain, both two_side values: name ->
    list of reads.  The Tpu2Corrector takes every read but the last, too
    long for the port's test chunk (br_tpu's bucketed engine has no such
    bound, and would compile its programs again for that read's length
    bucket); the oracle takes them all.  br_tpu's large-k engine takes
    tens of minutes and tens of GB on the CPU, so the recordings hold it
    at k = 21 (its own test's k, tests/test_engine2.py) and the oracle at
    every k."""
    from br_tpu.correct import build_methods, correct_read
    from br_tpu.correct.engine2 import Tpu2Corrector
    from br_tpu.set.hash import HashSet

    g, reads = hash_cases(k)
    hset = HashSet.from_sequences([g], k)
    methods = build_methods(FULL, hset, C, MS)
    out = {}
    for two_side in (False, True):
        if engine:
            tc_ = Tpu2Corrector(hset, FULL, confirm=C, max_search=MS)
            tc_.TARGET_ELEMS = 1 << 15
            out[f"tpu2_{int(two_side)}"] = tc_.correct_batch(reads[:-1],
                                                              two_side)
        out[f"oracle_{int(two_side)}"] = [
            correct_read(r, methods, two_side) for r in reads]
    return out


def save_reads(outs, path):
    """name -> list of bytes, as (lengths, concatenated bytes) arrays."""
    arrs = {}
    for name, seqs in outs.items():
        arrs[f"{name}/len"] = np.array([len(s) for s in seqs], np.int64)
        arrs[f"{name}/bytes"] = np.frombuffer(b"".join(seqs), np.uint8)
    np.savez_compressed(path, **arrs)


def load_reads(path):
    """The inverse of save_reads."""
    z = np.load(path)
    out = {}
    for key in z.files:
        name, kind = key.rsplit("/", 1)
        if kind != "len":
            continue
        lens, data = z[f"{name}/len"], z[f"{name}/bytes"].tobytes()
        ends = np.cumsum(lens)
        out[name] = [data[e - n : e] for e, n in zip(ends, lens)]
    return out


if __name__ == "__main__":
    import sys

    for st in sys.argv[1:] or STRATEGIES + ("two_stress", "greedy_rewind"):
        if st.startswith("hash_k"):   # hash_k19 ... hash_k31
            k = int(st[6:])
            save_reads(record_hash(k, engine=k == HASH_ENGINE_K),
                       hash_golden_path(k))
            print("wrote", hash_golden_path(k), flush=True)
            continue
        if st.endswith("_k17"):   # one_k17 ... gap-size_k17
            st = st[:-4]
            save_golden(record_k17(st), golden_path_k17(st))
            print("wrote", golden_path_k17(st), flush=True)
            continue
        if st == "two_stress":
            save_golden(record_two_stress(), TWO_STRESS_GOLDEN)
            print("wrote", TWO_STRESS_GOLDEN, flush=True)
            continue
        if st == "greedy_rewind":
            save_golden(record_greedy_rewind(), REWIND_GOLDEN)
            print("wrote", REWIND_GOLDEN, flush=True)
            continue
        save_golden(record(st), golden_path(st))
        print("wrote", golden_path(st), flush=True)
