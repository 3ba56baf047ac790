"""The port's mesh layer (``br_tpu_torch.parallel.mesh``, the plain K10
and K11 on the CPU) and its sharded corrector against the JAX package.

Inputs are made with numpy from fixed seeds; every comparison is exact
(integer arithmetic).  The shards of a CPU mesh share the CPU, as the
shards of a one-card mesh share the card.

* K11's plain unpack and pack equal br_tpu's ``make_unpack3_fn`` and
  ``make_pack3_fn`` (JAX on the CPU) on codes of every byte value.
* K10's plain merge equals a numpy reference, ``min(sum, cap)`` field by
  field, for every counter width, D = 1 to 4 and counters at and near the
  cap.
* ``count_sharded`` on 4 CPU shards equals ``counts_to_u8`` of br_tpu's
  ``count_sharded`` on JAX's one-device CPU mesh; ``solid_sharded`` equals
  br_tpu's ``Counter(k).to_solid(a)`` for a from -1 to 255, on reads whose
  k-mers pass the cap only once the shards are merged.
* The sharded corrector on 2 and 3 CPU shards (chunks round robin, a
  count that neither divides) equals the single-device port and br_tpu's
  ``correct_read``, with equal ``last_stats``.
"""

import jax
import numpy as np
import pytest
import torch

from br_tpu.correct import build_methods, correct_read
from br_tpu.correct.engine3 import make_pack3_fn, make_unpack3_fn
from br_tpu.count import Counter as JCounter
from br_tpu.parallel import count_sharded as jcount_sharded
from br_tpu.parallel import data_parallel_mesh as jmesh
from br_tpu.parallel.mesh import counts_to_u8 as jcounts_to_u8
from br_tpu.set.solid import SolidSet as JSolidSet
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct.engine3 import Torch3Corrector
from br_tpu_torch.parallel import mesh as pm
from br_tpu_torch.set import device_build as db
from br_tpu_torch.set.solid import SolidSet

BASES = np.frombuffer(b"ACTG", np.uint8)
CHAIN = ["one", "two", "graph", "greedy", "gap-size"]


def _cpu_mesh(d):
    return pm.data_parallel_mesh(["cpu"] * d)


@pytest.mark.parametrize("chunk", [1 << 12, 1 << 10])
def test_pack_unpack_match_br_tpu(chunk):
    rng = np.random.default_rng(chunk)
    codes = rng.integers(0, 256, chunk, dtype=np.uint8)
    want = np.asarray(make_pack3_fn(chunk)(codes))
    packed = dc.pack_codes(torch.from_numpy(codes))
    assert np.array_equal(packed.numpy(), want)
    assert np.array_equal(dc.pack_codes_plain(torch.from_numpy(codes))
                          .numpy(), want)
    back = dc.unpack_codes(packed, chunk)
    assert np.array_equal(back.numpy(), np.asarray(make_unpack3_fn(chunk)(
        want)))
    assert np.array_equal(back.numpy(), codes & 3)
    # rows of a batch pack on their own
    rows = torch.from_numpy(codes.reshape(4, -1).copy())
    assert torch.equal(dc.pack_codes(rows).reshape(-1), packed)
    with pytest.raises(ValueError):
        dc.unpack_codes(packed, chunk + 4)
    with pytest.raises(TypeError):
        dc.pack_codes(torch.from_numpy(codes).int())


def _merge_ref(rows, w, cap):
    """min(sum, cap) of every w-bit field of (D, n) uint32 words."""
    f = np.stack([(rows >> s) & ((1 << w) - 1) for s in range(0, 32, w)])
    m = np.minimum(f.sum(axis=1), cap)
    return sum(m[j] << (w * j) for j in range(32 // w)).astype(np.uint32)


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_merge_counts_plain_matches_numpy(w):
    rng = np.random.default_rng(w)
    top = (1 << w) - 1
    for d in (1, 2, 3, 4):
        for cap in sorted({1, max(1, top // 2), top - 1 or 1, top}):
            # fields near the cap, and a few at 0 and at the field's top
            f = rng.integers(max(0, cap - 2), top + 1, (d, 257, 32 // w))
            f[:, :16] = rng.integers(0, top + 1, (d, 16, 32 // w))
            rows = sum(f[..., j].astype(np.uint64) << (w * j)
                       for j in range(32 // w)).astype(np.uint32)
            t = torch.from_numpy(rows.view(np.int32))
            want = _merge_ref(rows.astype(np.uint64), w, cap)
            got = pm.merge_counts(t, w, cap)
            assert np.array_equal(got.numpy().view(np.uint32), want)
            assert torch.equal(pm.merge_counts_plain(t, w, cap), got)
    with pytest.raises(ValueError):
        pm.merge_counts(t, w, top + 1)


def test_count_sharded_matches_br_tpu():
    rng = np.random.default_rng(0)
    k, B, L = 7, 8, 200
    batch = rng.choice(BASES, (B, L)).astype(np.uint8)
    # one k-mer seen past 255 times, across the shards
    batch[:, :100] = ord("A")
    lens = np.full(B, L, np.int32)
    lens[-1] = 50   # a ragged lane
    want = jcounts_to_u8(jcount_sharded(jmesh(jax.devices()[:1]), batch,
                                        lens, k))
    for d in (4, 3):
        got = pm.count_sharded(_cpu_mesh(d), batch, lens, k)
        assert got.dtype == torch.uint8
        assert np.array_equal(pm.counts_to_u8(got).numpy(), want)
    assert want.max() == 255
    # the host u32 view saturates the same way
    host = JCounter(k, count_dtype=np.uint32)
    for b in range(B):
        host.count_sequence(batch[b, :lens[b]].tobytes())
    assert np.array_equal(pm.counts_to_u8(host.counts), want)


def _sharded_reads(seed, k, n=24, repeat=80):
    """Reads of a random genome, plus a k-mer repeated ``repeat`` times in
    each quarter of the reads (its count passes 255 only once the shards
    are merged), short and empty reads."""
    rng = np.random.default_rng(seed)
    g = rng.choice(BASES, 4000).tobytes()
    reads = []
    for i in range(n):
        st = int(rng.integers(0, len(g) - 300))
        reads.append(g[st:st + int(rng.integers(20, 300))])
    motif = g[:k] * repeat
    for q in range(4):
        reads.insert(q * (n // 4), motif)
    return reads + [g[:k - 1], b""]


@pytest.mark.parametrize("d", [4, 3])
def test_solid_sharded_matches_counter(d):
    k = 7
    reads = _sharded_reads(d, k)
    host = JCounter(k)
    host.count_sequences(reads)
    assert host.raw().max() == 255
    mesh = _cpu_mesh(d)
    for a in (-1, 0, 1, 2, 3, 14, 15, 254, 255):
        want = host.to_solid(a).bits
        got = pm.solid_sharded(mesh, reads, k, a)
        assert isinstance(got, db.DeviceSolidSet)
        assert np.array_equal(got.host().bits, want), a
        assert torch.equal(got.words, db.build_solid_words(reads, k, a,
                                                           "cpu"))
    # the half-space in 4 partitions of the D rows' counters
    got = pm.solid_sharded(mesh, reads, k, 2,
                           max_count_bytes=d * (1 << (2 * k - 1)) // 16)
    assert np.array_equal(got.host().bits, host.to_solid(2).bits)


def test_mesh_devices():
    mesh = _cpu_mesh(3)
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),)
    t = torch.arange(8, dtype=torch.int32)
    copies = pm.replicated(mesh, t)
    assert len(copies) == 3 and all(c is t for c in copies)
    shards = pm.shard_batch(mesh, np.zeros((6, 5), np.uint8),
                            np.arange(6))
    assert [tuple(b.shape) for b, _n in shards] == [(2, 5)] * 3
    with pytest.raises(ValueError):
        pm.shard_batch(mesh, np.zeros((4, 5), np.uint8), np.arange(4))


def test_default_mesh_is_cuda_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.data_parallel_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.data_parallel_mesh(["cuda:0"])


def _parallel_case():
    """tests/test_parallel.py's sharded case (k = 9, 16 reads of 100
    bases, one substitution each), plus a clean read, an impure read and
    one too long for a chunk."""
    rng = np.random.default_rng(1)
    genome = rng.choice(BASES, 1200).astype(np.uint8).tobytes()
    reads = []
    for _ in range(16):
        st = int(rng.integers(0, len(genome) - 100))
        read = bytearray(genome[st:st + 100])
        read[50] = int(rng.choice(BASES))
        reads.append(bytes(read))
    reads.insert(5, reads[2][:40] + b"N" + reads[2][41:])
    reads.insert(9, genome + genome[:800])
    # a 17th read: 5 chunks of 4 slots, which 2 and 3 shards do not divide
    reads.append(genome[600:700])
    return genome, reads


@pytest.mark.parametrize("d", [2, 3])
def test_sharded_corrector_matches_single_and_br_tpu(d):
    genome, reads = _parallel_case()
    methods = build_methods(CHAIN, JSolidSet.from_sequences([genome], 9),
                            5, 7)
    want = [correct_read(r, methods, False) for r in reads]
    solid = SolidSet.from_sequences([genome], 9)
    single = Torch3Corrector(solid, CHAIN, 5, 7, chunk=1 << 11, nreads=4,
                             device="cpu")
    assert single.correct_batch(reads, two_side=False) == want
    sharded = Torch3Corrector(solid, CHAIN, 5, 7, chunk=1 << 11, nreads=4,
                              device="cpu")
    sharded.mesh = _cpu_mesh(d)
    assert sharded.correct_batch(reads, two_side=False) == want
    assert sharded.last_stats == single.last_stats
    st = sharded.last_stats
    assert st["impure"] == 1 and st["too_long"] == 1
    assert st["chunks"] == 5   # 2 and 3 shards do not divide it
