"""Seeded Badread-style long reads, with the read model as data.

The benchmark's copy of ``br_tpu_torch/corpus.py`` (itself a copy of
``scripts/make_corpus.py``): the same PCG64 stream, drawn in the same
order, so that a traffic mix with that generator's constants gives its
reads byte for byte.  Only the assembly of a read from its errors is
vectorized.

Model: a uniform random genome; read length ~ gamma(``shape``) scaled to
``mean``, truncated to an integer and clamped to [``min``, ``max``];
uniform start; a read reverse-complemented with probability
``reverse_share``; per-read identity ~ uniform(``identity_pct``);
``n = int(len * (100 - identity) / 100)`` error positions drawn
uniformly, repeats merged, each a substitution, an insertion (a random
base before the original) or a deletion with the shares of ``errors``.

With ``sizes_seed`` in the mix, the lengths and identities are drawn
once from that seed, so that every run's seed gets the same set of them
(the same amount of work and of errors), in an order, a genome, starts,
strands and error positions of its own.  Without it, the generator is
the port's.

A traffic mix (``portbench/traffic/<name>.json``) holds::

    {"length": {"shape": 1.4, "mean": 12000, "min": 150, "max": 62000},
     "reverse_share": 0.5, "identity_pct": [95.0, 98.0],
     "errors": {"sub": 0.5, "ins": 0.25, "del": 0.25}, "sizes_seed": 1}
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, np.uint8)
COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def _check_model(model: dict) -> None:
    err = model["errors"]
    if abs(err["sub"] + err["ins"] + err["del"] - 1.0) > 1e-9:
        raise ValueError(f"error shares must sum to 1, got {err}")
    lo, hi = model["identity_pct"]
    if not 0.0 < lo <= hi <= 100.0:
        raise ValueError(f"identity_pct {model['identity_pct']}")


def make_reads(rng, genome, n_reads: int, model: dict):
    """Yield (start, strand, fragment length, identity, read) per read."""
    _check_model(model)
    length = model["length"]
    lo, hi = model["identity_pct"]
    sub, ins = model["errors"]["sub"], model["errors"]["ins"]
    glen = len(genome)
    fixed = model.get("sizes_seed")
    draw = rng if fixed is None else np.random.Generator(np.random.PCG64(fixed))
    lens = np.clip((draw.gamma(length["shape"], length["mean"]
                               / length["shape"], n_reads)).astype(np.int64),
                   length["min"], length["max"])
    idents = None
    if fixed is not None:
        idents = draw.uniform(lo, hi, n_reads)
        order = rng.permutation(n_reads)
        lens, idents = lens[order], idents[order]
    starts = rng.integers(0, np.maximum(1, glen - lens), n_reads)
    for r in range(n_reads):
        frag = genome[starts[r] : starts[r] + lens[r]]
        strand = "+"
        if rng.random() < model["reverse_share"]:
            frag = COMP[frag[::-1]]
            strand = "-"
        identity = rng.uniform(lo, hi) if idents is None else idents[r]
        n_err = int(len(frag) * (100.0 - identity) / 100.0)
        pos = np.unique(rng.integers(0, len(frag), n_err))
        kinds = rng.random(len(pos))
        sub_m = kinds < sub
        ins_m = (kinds >= sub) & (kinds < sub + ins)
        subs = BASES[rng.integers(0, 4, len(pos))]
        inss = BASES[rng.integers(0, 4, len(pos))]
        # each position gives 0 bytes (deletion), 1 (the substituted or
        # the original base) or 2 (the inserted base, then the original)
        base = frag.copy()
        base[pos[sub_m]] = subs[sub_m]
        emit = np.ones(len(frag), np.int64)
        emit[pos[~sub_m & ~ins_m]] = 0
        emit[pos[ins_m]] = 2
        read = np.repeat(base, emit)
        read[np.cumsum(emit)[pos[ins_m]] - 2] = inss[ins_m]
        yield starts[r], strand, len(frag), identity, read


def make_corpus(n_reads: int, genome_size: int, model: dict, seed: int):
    """The seeded corpus as a list of (definition, read) bytes pairs."""
    rng = np.random.Generator(np.random.PCG64(seed))
    genome = BASES[rng.integers(0, 4, genome_size)]
    out = []
    for i, (start, strand, flen, ident, read) in enumerate(
            make_reads(rng, genome, n_reads, model)):
        hdr = (f"sim{i:06d} random_seq,{strand}strand,"
               f"{start}-{start + flen} length={len(read)} "
               f"error-free_length={flen} read_identity={ident:.2f}%")
        out.append((hdr.encode(), read.tobytes()))
    return out


def write_fasta(path: str, records) -> None:
    """The records as FASTA, one line a sequence (the generator's
    layout)."""
    with open(path, "wb") as fh:
        fh.write(b"".join(b">" + d + b"\n" + s + b"\n" for d, s in records))
