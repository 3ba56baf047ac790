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

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_cases.py [strategy ...]
"""

from __future__ import annotations

import os

import numpy as np

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


def pack(reads, caps=None, rng=None):
    """(codes, rstart, rlen) of one chunk; ``caps`` overrides slot sizes.
    Slack after each read holds stale random codes (never zeros)."""
    codes = np.zeros(CHUNK, np.uint8)
    rstart = np.full(R, CHUNK, np.int32)
    rlen = np.zeros(R, np.int32)
    rng = rng or np.random.default_rng(0)
    off = 0
    for b, read in enumerate(reads):
        cap = slot_len(len(read)) if caps is None else caps[b]
        assert off + cap <= CHUNK and b < R
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


def jax_pass_outputs(cases, strategy="one", walk_max=None, eager=True):
    """Run br_tpu's pass of ``strategy`` on every case, eagerly unless
    ``eager`` is False (then it compiles for many minutes)."""
    import contextlib

    import jax

    from br_tpu.correct.engine3 import make_pass3_fn
    from br_tpu.set.solid import SolidSet

    kw = {} if walk_max is None else {"walk_max": walk_max}
    fn = make_pass3_fn(K, strategy, C, MS, C, CHUNK, R, **kw)
    outs = {}
    for name, (g, codes, rstart, rlen) in cases.items():
        # device arrays: eager vmapped code cannot index numpy arrays
        args = [jax.numpy.asarray(x) for x in (
            SolidSet.from_sequences([g], K).device_words(), codes, rstart,
            rlen)]
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


def run_port_pass(strategy, case, walk_max=None, device="cpu"):
    """The port's pass of ``strategy`` on one case: numpy (out, out_len,
    cap, aux)."""
    import torch

    from br_tpu_torch.correct.engine3 import make_pass3_fn
    from br_tpu_torch.set.solid import SolidSet

    g, codes, rstart, rlen = case
    kw = {} if walk_max is None else {"walk_max": walk_max}
    fn = make_pass3_fn(K, strategy, C, MS, C, CHUNK, R, **kw)
    out = fn(SolidSet.from_sequences([g], K).device_words(device),
             *(torch.from_numpy(x).to(device) for x in (codes, rstart,
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


def load_golden(path=GOLDEN):
    z = np.load(path)
    names = sorted({key.split("/")[0] for key in z.files})
    return {n: (z[f"{n}/out"], z[f"{n}/out_len"], z[f"{n}/cap"],
                z[f"{n}/aux"]) for n in names}


if __name__ == "__main__":
    import sys

    for st in sys.argv[1:] or STRATEGIES:
        save_golden(record(st), golden_path(st))
        print("wrote", golden_path(st), flush=True)
