"""The port's device solid-set build (``br_tpu_torch.set.device_build``,
K8's plain versions on the CPU) against br_tpu's device build and the
port's host ``Counter``.

The plain build (``torch.unique`` with counts) and the partitioned sweep
through K8's plain count and pack equal ``build_solid_words_on_device``
(its sort path and its partitioned path) at k = 11 and 13, and at k = 17
on a small corpus (set bits compared by index: the module's one 1 GiB
field); and ``Counter(k).to_solid(a)`` for a = 0, 1, 254, 255 on reads
with a k-mer seen more than 255 times, where br_tpu's exact count
differs at a = 255 and the port keeps the host's saturated count.  The
narrow count (w-bit counters saturating at a + 1) holds ``min(count, a +
1)`` of the host's count, and its pack equals both builds, for every a
that crosses a counter width (-1, 0, 1, 2, 3, 6, 7, 14, 15, 254, 255,
256), on reads whose k-mers are seen 254, 255, 256 and 300 times."""

import numpy as np
import pytest
import torch

import torch_cases as tc
from br_tpu.set.device_build import build_solid_words_on_device
from br_tpu_torch import cli
from br_tpu_torch.count import Counter
from br_tpu_torch.set import device_build as db


def _reads(seed, k, n=40, repeat=0):
    rng = np.random.default_rng(seed)
    g = rng.choice(tc.BASES, size=3000).tobytes()
    return (tc.fuzz_reads(rng, g, n, 4, k=k) + [g[:300]] * repeat
            + [g[5:5 + k - 1], b""])


def _words(reads, k, a, **kw):
    return db.build_solid_words(reads, k, a, "cpu", **kw)


def _cap4(k, a):
    """A byte cap that cuts the half-space into 4 partitions of a's
    counters."""
    w = db.counter_bits(a) if 0 <= a <= 254 else 1
    return (1 << (2 * k - 1)) * w // 32


#: abundances that cross every counter width (1, 2, 4, 8 bits) and both
#: ends, where nothing is counted
ABUNDANCES = (-1, 0, 1, 2, 3, 6, 7, 14, 15, 254, 255, 256)
#: times the k-mers of one random segment each are seen
REPEATS = (254, 255, 256, 300)


def _repeat_reads(seed, k):
    """Genome reads with errors, then one random 40-base segment a count
    of REPEATS, each repeated that many times (split over two reads so
    two batches count it)."""
    rng = np.random.default_rng(seed)
    g = rng.choice(tc.BASES, size=3000).tobytes()
    reads = tc.fuzz_reads(rng, g, 30, 4, k=k)
    for n in REPEATS:
        seg = rng.choice(tc.BASES, size=40).tobytes()
        reads += [seg] * n
    return reads


def test_counter_bits_cross_every_width():
    want = {0: 1, 1: 2, 2: 2, 3: 4, 6: 4, 7: 4, 14: 4, 15: 8, 254: 8}
    assert {a: db.counter_bits(a) for a in want} == want
    for a in (-1, 255, 256):
        with pytest.raises(ValueError):
            db.counter_bits(a)
    assert db.partition_size(17, 2, db.DEFAULT_MAX_COUNT_BYTES) == 1 << 33
    assert db.partition_size(17, 8, db.DEFAULT_MAX_COUNT_BYTES) == 1 << 32
    assert db.partition_size(13, 2, 1 << 20) == 1 << 22
    assert db.partition_size(1, 2, 1 << 20) == db.GROUP


@pytest.mark.parametrize("k", [11, 13])
def test_narrow_count_and_pack_match_br_tpu(k):
    """The plain K8a leaves min(count, a + 1) in each w-bit counter (the
    host Counter's u8 count, k-mers seen 254 to 300 times among them),
    and the plain K8b's bits equal ``Counter.to_solid(a)`` and br_tpu's
    device build for every a below 255; at a < 0 (every bit) and a >=
    255 (none) the sweep counts nothing and follows the Counter, where
    br_tpu's exact count keeps the k-mers seen 256 and 300 times."""
    reads = _repeat_reads(k + 100, k)
    counter = Counter(k).count_sequences(reads)
    raw = counter.raw()
    assert sorted(set(raw[raw > 200].tolist())) == [254, 255]
    batches = [db.pack_reads(reads[:200], k, "cpu"),
               db.pack_reads(reads[200:], k, "cpu")]
    half = 1 << (2 * k - 1)
    for a in ABUNDANCES:
        want = counter.to_solid(a).host_words()
        if not 0 <= a <= 254:
            got = db.build_words([batches], k, a)
            assert np.array_equal(got.numpy().view(np.uint32), want), a
            continue
        w = db.counter_bits(a)
        counts = torch.zeros(half * w // 32, dtype=torch.int32)
        for p in batches:
            db.count_kmers(p, k, 0, a, counts)
        fields = db.counter_fields(counts, w).numpy()
        assert np.array_equal(fields, np.minimum(raw, a + 1)), a
        words = counts   # a = 0: the 1-bit counters are the bitfield
        if w > 1:
            words = torch.empty(half // 32, dtype=torch.int32)
            db.threshold_pack(counts, a, words, clear=False)
        got = words.numpy().view(np.uint32)
        assert np.array_equal(got, want), a
        jw = np.asarray(build_solid_words_on_device(reads, k, a))
        assert np.array_equal(got, jw), a
    assert not want.any()   # a = 256: empty
    assert np.asarray(build_solid_words_on_device(reads, k, 255)).any()


@pytest.mark.parametrize("k", [11, 13])
def test_plain_build_matches_br_tpu(k):
    reads = _reads(k, k)
    for a in (0, 1, 3):
        want = np.asarray(build_solid_words_on_device(reads, k, a))
        part = np.asarray(build_solid_words_on_device(
            reads, k, a, max_count_bytes=-(1 << 22)))
        assert np.array_equal(want, part)
        got = _words(reads, k, a).numpy().view(np.uint32)
        assert np.array_equal(got, want)
        batches = [db.pack_reads(reads[:15], k, "cpu"),
                   db.pack_reads(reads[15:], k, "cpu")]
        swept = db.build_words([batches], k, a,
                               max_count_bytes=_cap4(k, a))
        assert np.array_equal(swept.numpy().view(np.uint32), want)
        assert want.any()


def test_plain_build_k17_matches_br_tpu():
    reads = _reads(17, 17, n=12)
    jw = np.asarray(build_solid_words_on_device(reads, 17, 0))
    nz = np.flatnonzero(jw)
    want = jw[nz]
    del jw
    got = _words(reads, 17, 0).numpy().view(np.uint32)
    assert np.array_equal(np.flatnonzero(got), nz)
    assert np.array_equal(got[nz], want)
    assert len(nz) > 1000


def test_build_matches_counter_at_every_saturation():
    """A k-mer seen 300 times: min(count, 255) > a as the host Counter
    counts, a = 255 included (br_tpu's exact count keeps it there)."""
    k = 11
    reads = _reads(3, k, repeat=300)
    counter = Counter(k).count_sequences(reads)
    assert counter.raw().max() == 255
    for a in (0, 1, 254, 255):
        want = counter.to_solid(a).host_words()
        got = _words(reads, k, a).numpy().view(np.uint32)
        assert np.array_equal(got, want), a
        batches = [db.pack_reads(reads[:100], k, "cpu"),
                   db.pack_reads(reads[100:], k, "cpu")]
        swept = db.build_words([batches], k, a,
                               max_count_bytes=_cap4(k, a))
        assert np.array_equal(swept.numpy().view(np.uint32), want), a
    assert not got.any()   # a = 255: empty
    assert np.asarray(build_solid_words_on_device(reads, k, 255)).any()


def test_device_set_round_trip_and_cli(monkeypatch):
    """``fasta -a`` builds a DeviceSolidSet on the corrector's device,
    whose host copy is the Counter's set; without -a, the selection
    methods keep the host Counter."""
    reads = _reads(5, 13, repeat=3)
    solid = db.DeviceSolidSet(13, _words(reads, 13, 2))
    want = Counter(13).count_sequences(reads).to_solid(2)
    assert np.array_equal(solid.host().bits, want.bits)
    assert solid.host() is solid.host()
    assert solid.count_ones() == want.count_ones() > 0
    args = cli.build_parser().parse_args(
        ["--device", "cpu", "fasta", "-i", "x.fa", "-k", "14", "-a", "2"])
    called = []

    def records(path):
        called.append(path)
        return [(b"r%d" % i, s, None) for i, s in enumerate(reads)]

    monkeypatch.setattr(cli, "read_records", records)
    got = cli.build_set(args)
    assert isinstance(got, db.DeviceSolidSet) and got.k == 13
    assert got.words.device.type == "cpu"
    assert np.array_equal(got.host().bits, want.bits)
    args.abundance = None
    args.abundance_selection = "first-minimum"
    host = cli.build_set(args)
    assert type(host).__name__ == "SolidSet" and called == ["x.fa"] * 2
    assert np.array_equal(
        host.bits, Counter(13).count_sequences(reads).to_solid(6).bits)
