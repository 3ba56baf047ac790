"""The chunk-batched chain on the CPU: the batched pass
(``make_pass3_fn(batch=True)``) and reversal on stacks of chunks, and
``Torch3Corrector`` at several ``NC_MAX``, against the JAX package.

* Every strategy's batched plain pass on stacks of the recorded cases
  (one stack with an empty chunk) equals br_tpu's recordings
  (golden/torch_<strategy>_pass_k13.npz) chunk by chunk, and on
  ``batch_stack`` (three chunks of one genome) the port's pass on each
  chunk alone; the slow tier holds it to br_tpu's own batched pass, run
  live (it cannot be recorded here: tests/torch_cases.py).
* The batched reversal equals br_tpu's ``make_reverse3_fn(batch=True)``.
* The corrector at NC_MAX = 2 and 3, on one device and on a two-shard
  mesh, gives NC_MAX = 1's output and ``last_stats``, and br_tpu's
  oracle's bytes; ``warmup`` changes no output.
"""

import numpy as np
import pytest
import torch

import torch_cases as tc
from br_tpu.correct import build_methods as j_build_methods
from br_tpu.correct import correct_read as j_correct_read
from br_tpu.set.solid import SolidSet as JSolidSet
from br_tpu_torch import kernels
from br_tpu_torch.correct.engine3 import Torch3Corrector, make_pass3_fn
from br_tpu_torch.correct.layout import WIDE_WALK_MAX
from br_tpu_torch.correct.reverse import reverse_slots
from br_tpu_torch.set.solid import SolidSet

FULL = ["one", "two", "graph", "greedy", "gap-size"]
#: (strategy, walk_max) of every pass: the walkers also wide
PASSES = [(st, None) for st in tc.STRATEGIES] + [
    (st, WIDE_WALK_MAX) for st in tc.WALKERS]
#: (strategy, walk_max, family) of every recorded pass: ``one`` holds no
#: long-walk family, the wide profile only that one
RECORDED = [(st, None, name) for st in tc.STRATEGIES for name in tc.FAMILIES
            if (st, name) != ("one", "long_walk")] + [
    (st, WIDE_WALK_MAX, "long_walk") for st in tc.WALKERS]


def _empty_chunk(rng):
    """A chunk without reads: every slot unused, stale codes."""
    return (rng.integers(0, 4, tc.CHUNK, dtype=np.uint8),
            np.full(tc.R, tc.CHUNK, np.int32), np.zeros(tc.R, np.int32))


def _batched(strategy, table, chunks, walk_max=None):
    """The port's batched pass on a stack of chunks: numpy (out, out_len,
    cap, aux), each with a leading chunk axis."""
    kw = {} if walk_max is None else {"walk_max": walk_max}
    fn = make_pass3_fn(tc.K, strategy, tc.C, tc.MS, tc.C, tc.CHUNK, tc.R,
                       batch=True, **kw)
    arrays = [torch.from_numpy(np.stack([ch[j] for ch in chunks]))
              for j in range(3)]
    return tuple(t.numpy() for t in fn(table, *arrays))


def _chunk(got, c):
    return tuple(x[c] for x in got)


@pytest.fixture(scope="module")
def cases():
    return tc.all_cases()


@pytest.fixture(scope="module")
def goldens():
    return {st: tc.load_golden(tc.golden_path(st)) for st in tc.STRATEGIES}


@pytest.mark.parametrize("strategy,walk_max,name", RECORDED)
def test_batched_pass_matches_recordings(cases, goldens, strategy, walk_max,
                                         name):
    """Stacks [X, X] (NC = 2) and [X, empty, X] (NC = 3) of a recorded
    case X: each X chunk equals br_tpu's recording of X, codes, lengths,
    caps and aux; the empty chunk writes zeros and counts nothing."""
    want = goldens[strategy][name if walk_max is None else f"{name}_wide"]
    g, codes, rstart, rlen = cases[name]
    table = SolidSet.from_sequences(tc.pieces_of(g), tc.K).device_words("cpu")
    x = (codes, rstart, rlen)
    empty = _empty_chunk(np.random.default_rng(3))
    for stack, live in (([x, x], (0, 1)), ([x, empty, x], (0, 2))):
        got = _batched(strategy, table, stack, walk_max)
        assert got[0].shape == (len(stack), tc.CHUNK)
        assert got[3].shape == (len(stack), 8)
        for c in live:
            tc.assert_matches_recording(_chunk(got, c), want, rstart, rlen)
        if len(stack) == 3:
            out, n, cap, aux = _chunk(got, 1)
            assert not out.any() and not n.any() and not cap.any()
            assert not aux.any()


@pytest.fixture(scope="module")
def stack():
    pieces, codes, rstart, rlen = tc.batch_stack()
    table = SolidSet.from_sequences(pieces, tc.K).device_words("cpu")
    return table, [(codes[c], rstart[c], rlen[c]) for c in range(3)]


@pytest.mark.parametrize("strategy,walk_max", PASSES)
def test_batched_pass_on_one_genome(stack, strategy, walk_max):
    """Three chunks of one genome (``batch_stack``: the mixed and the
    long-walk families and a sparse chunk) against its one bitfield: the
    port's batched pass equals its pass on each chunk alone in every
    output word, and every chunk has sites."""
    table, chunks = stack
    got = _batched(strategy, table, chunks, walk_max)
    kw = {} if walk_max is None else {"walk_max": walk_max}
    one = make_pass3_fn(tc.K, strategy, tc.C, tc.MS, tc.C, tc.CHUNK, tc.R,
                        **kw)
    for c in range(len(chunks)):
        alone = one(table, *(torch.from_numpy(a) for a in chunks[c]))
        for a, b in zip(_chunk(got, c), alone):
            assert np.array_equal(a, b.numpy())
    assert got[3][:, 0].min() > 0


def test_batched_reverse_matches_br_tpu():
    """The batched reversal of three chunks (one empty) equals br_tpu's
    ``make_reverse3_fn(batch=True)`` run directly."""
    import jax.numpy as jnp

    from br_tpu.correct.engine3 import make_reverse3_fn

    rng = np.random.default_rng(11)
    genome = rng.choice(tc.BASES, size=4000).tobytes()
    chunks = [tc.pack(tc.fuzz_reads(rng, genome, n, 3), rng=rng)
              for n in (28, 5)]
    chunks.insert(1, _empty_chunk(rng))
    codes, rstart, rlen = (np.stack([ch[j] for ch in chunks])
                           for j in range(3))
    want = make_reverse3_fn(tc.CHUNK, tc.R, batch=True)(
        jnp.asarray(codes), jnp.asarray(rstart), jnp.asarray(rlen))
    got = reverse_slots(torch.from_numpy(codes), torch.from_numpy(rstart),
                        torch.from_numpy(rlen))
    assert np.array_equal(got.numpy(), np.asarray(want))
    for c in range(3):   # and each chunk as a group of its own
        assert torch.equal(got[c], reverse_slots(
            *(torch.from_numpy(a[c]) for a in (codes, rstart, rlen))))


CHUNK_SMALL, R_SMALL = 1 << 12, 8


def _corrector_input():
    """Genome pieces and about 40 reads of them over chunks of 2^12
    positions (five): fuzz reads, an impure read, a read too long
    for a chunk, and a read with a 400-base deletion in a short piece,
    whose graph walk caps at walk_max 248 and finishes on the wide
    sibling."""
    rng = np.random.default_rng(21)
    genome = rng.choice(tc.BASES, size=12000).tobytes()
    short = rng.choice(tc.BASES, size=2400).tobytes()
    reads = tc.fuzz_reads(rng, genome, 36, 4)
    impure = bytearray(reads[3])
    impure[len(impure) // 2] = ord("N")
    reads[3] = bytes(impure)
    reads.insert(10, short[200:700] + short[1100:1700])
    long_read = bytearray(genome[5000:9500])
    for p in range(300, 4400, 500):
        long_read[p] = ord("ACTG"[("ACTG".index(chr(long_read[p])) + 1)
                                  % 4])
    reads.insert(20, bytes(long_read))
    return [genome, short], reads


@pytest.fixture(scope="module")
def corrector_case():
    pieces, reads = _corrector_input()
    solid = SolidSet.from_sequences(pieces, tc.K)
    theirs = j_build_methods(FULL, JSolidSet.from_sequences(pieces, tc.K),
                             tc.C, tc.MS)
    return solid, reads, [j_correct_read(r, theirs, False) for r in reads]


def _run(solid, reads, nc, mesh=None, warm=False):
    cor = Torch3Corrector(solid, FULL, tc.C, tc.MS, chunk=CHUNK_SMALL,
                          nreads=R_SMALL, device="cpu")
    cor.NC_MAX = nc
    if mesh is not None:
        from br_tpu_torch.parallel.mesh import data_parallel_mesh

        cor.mesh = data_parallel_mesh(["cpu"] * mesh)
    if warm:
        cor.warmup(False, nc=nc)
    return cor.correct_batch(reads, False), dict(cor.last_stats), cor


@pytest.mark.parametrize("mesh", [None, 2])
def test_corrector_nc_max_matches_one_and_br_tpu(corrector_case, mesh):
    """NC_MAX = 2 and 3 (groups of 2 and 3 chunks, the last short) give
    NC_MAX = 1's bytes and last_stats, and br_tpu's oracle's bytes; the
    impure, the too-long and the wide-retried reads among them."""
    solid, reads, want = corrector_case
    out1, st1, _ = _run(solid, reads, 1, mesh)
    assert out1 == want
    assert st1["impure"] == 1 and st1["too_long"] == 1
    assert st1["wide_retried"] >= 1 and st1["chunks"] >= 5
    for nc in (2, 3):
        out, st, cor = _run(solid, reads, nc, mesh)
        assert out == out1 and st == st1
        assert st["chunks"] % nc   # a short last group
        assert cor._wide.NC_MAX == nc


def test_warmup_leaves_output_unchanged(corrector_case):
    """``warmup`` (one group of nc empty chunks through the chain, here
    and on the wide sibling, and the native engine loaded) before a batch
    changes none of its bytes or counts."""
    solid, reads, want = corrector_case
    out, st, cor = _run(solid, reads, 3, warm=True)
    assert out == want
    assert st == _run(solid, reads, 1)[1]
    assert cor._engine is not None and cor._wide is not None


def test_group_arrays_are_chunk_arrays(corrector_case):
    """A group's host arrays are its chunks' arrays, row by row, and a
    one-chunk group launches through the same wrappers as a chunk."""
    solid, reads, _ = corrector_case
    cor = Torch3Corrector(solid, FULL, tc.C, tc.MS, chunk=CHUNK_SMALL,
                          nreads=R_SMALL, device="cpu")
    plans = cor._plan(reads, set(), set())
    group = cor._group_arrays(reads, plans[:3])
    for c, (idxs, starts) in enumerate(plans[:3]):
        for a, b in zip(group, cor._chunk_arrays(reads, idxs, starts)):
            assert np.array_equal(a[c], b)
    with pytest.raises(ValueError, match="NC_MAX"):
        cor.NC_MAX = 0
        cor._groups(plans)


def test_group_checks():
    """kernels.check takes a group's rows (lead = (NC,)); a chain
    wrapper's arguments must share the codes' leading axis."""
    t = torch.zeros((3, 16), dtype=torch.uint8)
    kernels.check(t, "codes", torch.uint8, t.device, 16, (3,))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.check(t, "codes", torch.uint8, t.device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.check(t.t(), "codes", torch.uint8, t.device, lead=(16,))
    assert kernels.group_lead(t) == (3,) and kernels.group_lead(t[0]) == ()
    with pytest.raises(ValueError, match="group"):
        kernels.group_lead(t[None])
    rs = torch.zeros(tc.R, dtype=torch.int32)
    with pytest.raises(ValueError, match="rstart"):
        reverse_slots(t, rs, rs)


@pytest.mark.slow
@pytest.mark.parametrize("strategy,walk_max", PASSES)
def test_batched_pass_matches_br_tpu_batched(stack, strategy, walk_max):
    """br_tpu's own batched pass (``make_pass3_fn(batch=True)``, eagerly:
    JAX compiles each vmapped while loop, tens of GB of host memory) on
    ``batch_stack``: the port's batched pass equals it chunk by chunk."""
    table, chunks = stack
    want = tc.record_batch(strategy, walk_max)
    got = _batched(strategy, table, chunks, walk_max)
    for c, (_codes, rstart, rlen) in enumerate(chunks):
        tc.assert_matches_recording(_chunk(got, c), _chunk(want, c), rstart,
                                    rlen)
