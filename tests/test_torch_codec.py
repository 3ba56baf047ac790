"""The port's tensor codec against the JAX package's device codec, and
the port's copied host modules against their originals.

Inputs are made with numpy from fixed seeds and handed to both packages;
equality is exact (integer arithmetic)."""

import io

import jax.numpy as jnp
import numpy as np
import torch

from br_tpu.correct import device_codec as jdc
from br_tpu.set.solid import SolidSet as JSolidSet
from br_tpu_torch.correct import device_codec as tdc
from br_tpu_torch.set.solid import SolidSet, solid_words_from_numpy


def _rand_kmers(k, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_revcomp_canonical_match_jax():
    for k in (3, 7, 11, 13, 15):
        km = _rand_kmers(k, seed=k).astype(np.uint32)
        want_rc = np.asarray(jdc.revcomp32(jnp.asarray(km), k))
        want_cano = np.asarray(jdc.canonical_any(jnp.asarray(km), k))
        assert np.array_equal(tdc.revcomp32(_t(km), k).numpy(),
                              want_rc.astype(np.int64))
        assert np.array_equal(tdc.canonical_any(_t(km), k).numpy(),
                              want_cano.astype(np.int64))


def test_rolling_kmers_match_jax():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(3, 300), dtype=np.uint8)
    for k in (5, 11, 13, 15):
        want = np.asarray(jdc.rolling_kmers32(jnp.asarray(codes), k))
        got = tdc.rolling_kmers(torch.from_numpy(codes), k)
        assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_solid_probe_matches_jax_and_host():
    rng = np.random.default_rng(5)
    for k in (11, 13):
        genome = rng.choice(np.frombuffer(b"ACTG", np.uint8),
                            size=3000).tobytes()
        jsolid = JSolidSet.from_sequences([genome], k)
        km = _rand_kmers(k, seed=6 + k)
        # half the probes hit: real k-mers of the genome
        codes = (np.frombuffer(genome, np.uint8) >> 1) & 3
        real = np.asarray(jdc.rolling_kmers32(jnp.asarray(codes), k))
        km[: len(km) // 2] = real[k : k + len(km) // 2]
        want = np.asarray(jdc.make_solid_probe_any(
            jnp.asarray(jsolid.device_words()), k)(
                jnp.asarray(km.astype(np.uint32))))
        table = solid_words_from_numpy(jsolid.device_words(), "cpu")
        got = tdc.make_solid_probe_any(table, k)(_t(km)).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got, jsolid.get_many(km))
        assert got.any() and not got.all()


def test_pack_unpack_encode_match_jax():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, size=(2, 256), dtype=np.uint8)
    want = np.asarray(jdc.pack_codes(jnp.asarray(codes)))
    packed = tdc.pack_codes(torch.from_numpy(codes))
    assert np.array_equal(packed.numpy(), want)
    back = tdc.unpack_codes(packed, 256)
    assert np.array_equal(back.numpy(), np.asarray(
        jdc.unpack_codes(jnp.asarray(want), 256)))
    ascii_ = np.frombuffer(b"ACGTacgtNn", np.uint8)
    assert np.array_equal(
        tdc.encode_ascii(torch.from_numpy(ascii_.copy())).numpy(),
        np.asarray(jdc.encode_ascii(jnp.asarray(ascii_))))


def test_solid_set_copy_matches_original():
    rng = np.random.default_rng(8)
    seqs = [rng.choice(np.frombuffer(b"ACGT", np.uint8), 500).tobytes()
            for _ in range(3)]
    a = JSolidSet.from_sequences(seqs, 11)
    b = SolidSet.from_sequences(seqs, 11)
    assert np.array_equal(a.bits, b.bits)
    assert np.array_equal(a.device_words(), b.host_words())
    w = b.device_words("cpu")
    assert w.dtype == torch.int32
    assert np.array_equal(w.numpy().view(np.uint32), a.device_words())
    buf = io.BytesIO()
    b.to_stream(buf)
    buf.seek(0)
    assert np.array_equal(JSolidSet.from_stream(buf).bits, a.bits)


def _top_kmers(k, n=4096, seed=0):
    """Random 2k-bit k-mers, the first quarter with the top bits set (the
    group swaps move them to bit 63 and back)."""
    km = _rand_kmers(k, n, seed)
    top = np.uint64(((1 << (2 * k)) - 1) ^ ((1 << (2 * k - 4)) - 1))
    km[: n // 4] |= top
    return km


def test_revcomp_canonical_64_match_jax_and_host():
    """k = 17 in 64-bit math: br_tpu's canonical_any (u64) and the host
    codec's canonical_np give the port's, k-mers with bit 33 set among
    them; parity64 and revcomp64 agree with the 32-bit forms below k =
    16."""
    from br_tpu_torch import codec

    for k in (17, 19, 31):
        km = _top_kmers(k, seed=k)
        want = codec.canonical_np(km, k).astype(np.int64)
        got = tdc.canonical_any(_t(km.astype(np.int64)), k).numpy()
        assert np.array_equal(got, want)
        if k == 17:
            j = np.asarray(jdc.canonical_any(jnp.asarray(km), k))
            assert np.array_equal(got, j.astype(np.int64))
            assert (got >> 33).any() and (got < 0).sum() == 0
    for k in (3, 13, 15):
        km = _t(_top_kmers(k, seed=k))
        assert torch.equal(tdc.revcomp64(km, k), tdc.revcomp32(km, k))
        assert torch.equal(tdc.parity64(km), tdc.parity32(km))


def test_rolling_kmers_k17_match_jax():
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, size=(3, 300), dtype=np.uint8)
    want = np.asarray(jdc.rolling_kmers(jnp.asarray(codes), 17))
    got = tdc.rolling_kmers(torch.from_numpy(codes), 17)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert tdc.kmer_dtype(17) == torch.int64
    assert tdc.kmer_dtype(15) == torch.int32
