"""Large k on the CPU: the port's ``HashSet`` and sorted-table probe
against br_tpu's, the five plain passes through a sorted table against
br_tpu's recorded passes, and the corrector at k = 19, 20, 21, 25 and 31
against br_tpu's recorded oracle outputs (and ``Tpu2Corrector``'s at
k = 21) and the port's own oracle.  Inputs are drawn from seeded numpy
generators; equality is exact throughout.

br_tpu's large-k corrector runs for tens of minutes on the CPU, so its
outputs on ``tests/torch_cases.hash_cases`` are recorded in
``golden/torch_hash_k<k>.npz`` (``python tests/torch_cases.py
hash_k21 ...``); the ``slow`` test records them again live."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cases as tc
from br_tpu.correct import device_codec as jdc
from br_tpu.set.hash import HashSet as JHashSet
from br_tpu_torch import cli, codec
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct import reference as P
from br_tpu_torch.correct.engine3 import Torch3Corrector
from br_tpu_torch.correct.hash_probe import hash_probe
from br_tpu_torch.native import NativeCorrector
from br_tpu_torch.set import HashSet
from br_tpu_torch.set.solid import SolidSet

FULL = tc.FULL
SET_KS = (19, 21, 25, 31)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain passes run many small tensor ops, which torch's CPU
    thread pool slows down where test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _genome(seed, n=3000):
    rng = np.random.default_rng(seed)
    return rng.choice(tc.BASES, size=n).tobytes()


def _csv(genome, k, step=7):
    rows = [genome[i : i + k].decode() for i in range(0, len(genome) - k,
                                                       step)]
    return "kmer,count\n" + "".join(f"{r},3\n" for r in rows)


def _edge_keys(k, table):
    """Keys past the last real entry of a padded table, the k = 31
    sentinel 1 << 63, the all-ones word, and k-mers with bits set past 2k
    (uint64)."""
    rng = np.random.default_rng(7 * k)
    real = table[table < (np.uint64(1) << np.uint64(2 * k))]
    top = int(real.max()) if real.size else 0
    return np.concatenate([
        np.array([top + 1, (1 << (2 * k)) - 1, 1 << 63, (1 << 64) - 1,
                  1 << (2 * k), 1 << min(2 * k + 1, 63)], np.uint64),
        rng.integers(0, 1 << 62, 200, dtype=np.uint64)
        | np.uint64(1 << (2 * k))])


def _same_sets(mine, theirs, k, seed):
    assert len(mine) == len(theirs)
    assert np.array_equal(mine.sorted_table(), theirs.sorted_table())
    assert np.array_equal(mine.device_table(), theirs.device_table())
    rng = np.random.default_rng(seed)
    km = rng.integers(0, 1 << (2 * k), 2000, dtype=np.uint64)
    km[:500] = theirs.sorted_table()[:500] if len(theirs) >= 500 else 0
    km = np.concatenate([km, _edge_keys(k, theirs.device_table())])
    assert np.array_equal(mine.get_many(km), theirs.get_many(km))
    # get: the entries, random k-mers, their reverse complements (of
    # either popcount parity), k-mers with bits set past 2k and the edge
    # keys; and the device table's plain probe on all of them
    xs = km.tolist()
    xs += [codec.revcomp(x, k) for x in xs[:2000]]
    xs += [x | 1 << (2 * k + 1) for x in xs[:100]]
    got = [mine.get(x) for x in xs]
    assert got == [theirs.get(x) for x in xs]
    probe = dc.make_hash_probe(mine.device_table_tensor("cpu"), k)
    keys = torch.from_numpy(np.array(xs, np.uint64).view(np.int64))
    assert probe(keys).tolist() == got


@pytest.mark.parametrize("k", SET_KS)
def test_hash_set_matches_br_tpu(k):
    """from_sequences and from_csv at large k: the same sorted and padded
    tables and the same membership as br_tpu's HashSet (get and get_many
    on the edge keys too, as the device table's probe reads them); the
    device table carries those bits."""
    g = _genome(k)
    mine = HashSet.from_sequences([g, g[:100], b"ACG"], k)
    theirs = JHashSet.from_sequences([g, g[:100], b"ACG"], k)
    _same_sets(mine, theirs, k, k)
    t = mine.device_table_tensor("cpu").table
    assert t.dtype == torch.int64
    assert np.array_equal(t.numpy().view(np.uint64), theirs.device_table())
    text = _csv(g, k)
    _same_sets(HashSet.from_csv(io.StringIO(text), k),
               JHashSet.from_csv(io.StringIO(text), k), k, k + 1)


def test_hash_set_empty_one_entry_and_updates():
    for k in (21, 31):
        _same_sets(HashSet(k), JHashSet(k), k, 0)
        mine, theirs = HashSet(k), JHashSet(k)
        x = int(np.random.default_rng(k).integers(0, 1 << (2 * k)))
        mine.set(x)
        theirs.set(x)
        _same_sets(mine, theirs, k, 1)
        assert mine.device_table().size == 1 and mine.get(x)
        mine.set(x, False)
        theirs.set(x, False)
        _same_sets(mine, theirs, k, 2)


def _probe_inputs(k, table):
    """K-mers below the first entry, above the last, equal to every entry
    (canonical and reverse-complemented) and one past each, random ones,
    and the edge keys (_edge_keys)."""
    rng = np.random.default_rng(k)
    real = table[table < (np.uint64(1) << np.uint64(2 * k))]
    from br_tpu_torch import codec

    kms = [real, codec.revcomp_np(real, k), real + np.uint64(1),
           real - np.uint64(1),
           rng.integers(0, 1 << (2 * k), 3000, dtype=np.uint64),
           np.array([0, 1, (1 << (2 * k)) - 1], np.uint64),
           _edge_keys(k, table)]
    if k == 31:
        kms.append(rng.integers(0, 1 << 60, 500, dtype=np.uint64)
                   | np.uint64(3 << 60))
    return np.concatenate(kms)


def _even(x):
    """The uint64 k-mers of even popcount (their own canonical form)."""
    return x[(codec.popcount_np(x) & np.uint64(1)) == 0]


def _probe_set(k, case):
    """br_tpu's HashSet of a probe case at k: ``genome`` the k-mers of a
    random genome; ``empty``; ``one`` entry; ``one_bucket``, 300 entries
    sharing their top 20 bits (every index the tables take has at most
    20 bits here: all in one bucket, the worst skew); ``edges``, in each
    of the 64 buckets of a 128-entry table its first and last canonical
    k-mer."""
    rng = np.random.default_rng(200 + k)
    if case == "genome":
        return JHashSet.from_sequences([_genome(100 + k, 2000)], k)
    if case == "empty":
        return JHashSet(k)
    if case == "one":
        return JHashSet(k, [int(_even(rng.integers(
            0, 1 << (2 * k), 8, dtype=np.uint64))[0])])
    if case == "one_bucket":
        low = rng.choice(1 << (2 * k - 20), 1200, replace=False)
        x = _even((np.uint64(0xABCDE) << np.uint64(2 * k - 20))
                  | low.astype(np.uint64))[:300]
        return JHashSet(k, x.tolist())
    shift = 2 * k - 6   # a 128-entry table: levels 7, b = 6
    edges = []
    for i in range(64):
        lo = np.arange(i << shift, (i << shift) + 8, dtype=np.uint64)
        hi = np.arange(((i + 1) << shift) - 8, (i + 1) << shift,
                       dtype=np.uint64)
        edges += [_even(lo)[0], _even(hi)[-1]]
    return JHashSet(k, [int(x) for x in edges])


PROBE_CASES = ["genome", "empty", "one", "one_bucket", "edges"]


@pytest.mark.parametrize("case", PROBE_CASES)
@pytest.mark.parametrize("k", [19, 20, 21, 31])
def test_hash_probe_matches_br_tpu(k, case):
    """The plain bucketed probe (and K9's wrapper on the CPU) equals
    br_tpu's make_hash_probe, JAX on the CPU (a binary search of the
    whole table), on the port's SortedTable of the same sentinel-padded
    table (at k = 31 the sentinel is 1 << 63): a genome's set, the empty
    set, one entry, every entry in one bucket and entries at bucket
    edges.  The bare table, without its index, is refused."""
    theirs = _probe_set(k, case)
    table = theirs.device_table()
    mine = HashSet(k, theirs.sorted_table().tolist())
    st = mine.device_table_tensor("cpu")
    assert np.array_equal(st.table.numpy().view(np.uint64), table)
    if case == "one_bucket":
        assert int((st.starts[1:] > st.starts[:-1]).sum()) == 1
        assert st.bucket_levels == 9
    if case == "edges":
        assert st.buckets == 64 and bool((st.starts.diff() == 2).all())
    km = _probe_inputs(k, table)
    want = np.asarray(jdc.make_hash_probe(jnp.asarray(table), k)(
        jnp.asarray(km)))
    kt = torch.from_numpy(km.view(np.int64))
    got = dc.make_hash_probe(st, k)(kt).numpy()
    assert np.array_equal(got, want) and not want.all()
    assert want.any() == (case != "empty")
    assert np.array_equal(hash_probe(st, kt, k).numpy(), want)
    assert np.array_equal(dc.make_probe(st, k)(kt).numpy(), want)
    assert np.array_equal(mine.get_many(km), want)
    bare = st.table
    for fn in (lambda: hash_probe(bare, kt, k),
               lambda: dc.make_probe(bare, k)):
        with pytest.raises(TypeError, match="bucket index"):
            fn()


def test_hash_of_solid_is_the_solid_set():
    """A HashSet of the canonical k-mers of a bitfield holds the k-mers
    that HashSet.from_sequences of the same genome holds (k = 13)."""
    cases = tc.all_cases()
    g = tc.pieces_of(cases["repeat_rich"][0])
    solid = SolidSet.from_sequences(g, tc.K)
    assert np.array_equal(tc.hash_of_solid(solid).sorted_table(),
                          HashSet.from_sequences(g, tc.K).sorted_table())


#: per strategy, the family with the most sites and repairs (dense
#: errors) and the chains past SLOTS; the walkers' long walks
K13_RUNS = [(st, name) for st in tc.STRATEGIES
            for name in ("dense", "slot_overflow")]
K13_RUNS += [(st, "long_walk") for st in tc.WALKERS]


@pytest.fixture(scope="module")
def k13_cases():
    return tc.all_cases()


@pytest.mark.parametrize("strategy,name", K13_RUNS)
def test_hash_pass_k13_matches_recording(k13_cases, strategy, name):
    """Each plain pass through the sorted table of the case genome's
    k-mers equals br_tpu's recorded pass (bitfield probe), out_len, cap
    and aux included: the same membership, the same pass."""
    case = k13_cases[name]
    solid = SolidSet.from_sequences(tc.pieces_of(case[0]), tc.K)
    table = tc.hash_of_solid(solid).device_table_tensor("cpu")
    got = tc.run_port_pass(strategy, case, table=table)
    golden = tc.load_golden(tc.golden_path(strategy))
    tc.assert_matches_recording(got, golden[name], case[2], case[3])


@pytest.mark.parametrize("strategy,rec,ms", [
    ("one", "mixed", tc.MS), ("two", "mixed", tc.MS),
    ("graph", "mixed", tc.MS), ("gap-size", "mixed", tc.MS),
    ("greedy", "mixed", tc.MS), ("greedy", "mixed_ms15", 15)])
def test_hash_pass_k17_matches_recording(strategy, rec, ms):
    """The five plain passes at k = 17 through a sorted table equal
    br_tpu's k = 17 recordings (greedy also at ms = 15)."""
    cases = tc.k17_cases()
    table = HashSet.from_sequences(cases["mixed"][0],
                             tc.K17).device_table_tensor("cpu")
    _p, codes, rstart, rlen = cases["mixed"]
    got = tc.run_port_pass(strategy, cases["mixed"], ms=ms, k=tc.K17,
                           table=table)
    golden = tc.load_golden(tc.golden_path_k17(strategy))
    tc.assert_matches_recording(got, golden[rec], rstart, rlen)


@pytest.fixture(scope="module")
def hash_runs():
    """k -> (reads, set, the port's oracle methods), built once."""
    out = {}
    for k in tc.HASH_KS:
        g, reads = tc.hash_cases(k)
        hset = HashSet.from_sequences([g], k)
        out[k] = (reads, hset, P.build_methods(FULL, hset, tc.C, tc.MS))
    return out


@pytest.mark.parametrize("two_side", [False, True])
@pytest.mark.parametrize("k", tc.HASH_KS)
def test_hash_corrector_matches_recordings_and_oracle(hash_runs, k,
                                                      two_side):
    """The default chain with a HashSet on the CPU (the sorted-table
    plain passes, the wide retry, the native engine for a read capped
    twice, an impure read and a read too long for a chunk) gives the
    bytes br_tpu's Tpu2Corrector and its oracle gave, and the port's
    oracle's."""
    reads, hset, methods = hash_runs[k]
    want = tc.load_reads(tc.hash_golden_path(k))
    tcor = Torch3Corrector(hset, FULL, tc.C, tc.MS, chunk=tc.HASH_CHUNK,
                           nreads=tc.R, device="cpu", threads=2)
    got = tcor.correct_batch(reads, two_side)
    assert got == want[f"oracle_{int(two_side)}"]
    if k == tc.HASH_ENGINE_K:
        # br_tpu's engine took every read but the last, too long for a
        # chunk of the port
        assert got[:-1] == want[f"tpu2_{int(two_side)}"]
    assert got == [P.correct_read(r, methods, two_side) for r in reads]
    st = tcor.last_stats
    assert st["impure"] == 1 and st["too_long"] == 1, st
    assert st["capped"] >= 1 and st["wide_retried"] >= 1, st
    assert sum(a != b for a, b in zip(got, reads)) >= 8


def test_native_engine_on_hash_set(hash_runs):
    """The native engine with a HashSet (br_create_hash) equals the
    port's oracle."""
    reads, hset, methods = hash_runs[21]
    native = NativeCorrector(hset, FULL, tc.C, tc.MS, threads=2)
    for two_side in (False, True):
        assert native.correct_batch(reads, two_side) == [
            P.correct_read(r, methods, two_side) for r in reads]


@pytest.mark.parametrize("fmt", ["fasta", "csv"])
def test_cli_large_kmer_runs(monkeypatch, tmp_path, capsys, fmt):
    """``large-kmer -f fasta|csv -k 21`` through main() on the CPU, at the
    tests' chunk geometry: the HashSet of the input, the default chain,
    the oracle's bytes."""
    monkeypatch.setattr(Torch3Corrector, "CHUNK", tc.CHUNK)
    monkeypatch.setattr(Torch3Corrector, "R", tc.R)
    g, reads = tc.hash_cases(21)
    reads = reads[:6]
    fa = tmp_path / "r.fa"
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, r)
                            for i, r in enumerate(reads)))
    src = tmp_path / ("g.fa" if fmt == "fasta" else "g.csv")
    if fmt == "fasta":
        src.write_bytes(b">g\n" + g + b"\n")
        hset = HashSet.from_sequences([g], 21)
    else:
        src.write_text(_csv(g, 21, step=1))
        hset = HashSet.from_csv(io.StringIO(_csv(g, 21, step=1)), 21)
    out = tmp_path / "o.fa"
    assert cli.main(["-i", str(fa), "-o", str(out), "--device", "cpu",
                     "--line-width", "0", "large-kmer", "-i", str(src),
                     "-f", fmt, "-k", "21"]) == 0
    methods = P.build_methods(FULL, hset, tc.C, tc.MS)
    got = out.read_bytes().split(b"\n")[1::2]
    assert got == [P.correct_read(r, methods, False) for r in reads]
    assert got != reads and capsys.readouterr().err == ""


@pytest.mark.slow
@pytest.mark.parametrize("k", tc.HASH_KS)
def test_hash_recording_is_br_tpu_output(k):
    """Record br_tpu's large-k outputs again, live (the Tpu2Corrector at
    k = 21: tens of minutes)."""
    fresh = tc.record_hash(k, engine=k == tc.HASH_ENGINE_K)
    assert fresh == tc.load_reads(tc.hash_golden_path(k))
