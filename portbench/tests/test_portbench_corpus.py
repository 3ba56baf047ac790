"""The benchmark's generator gives ``br_tpu_torch/corpus.py``'s reads
byte for byte at that generator's constants (identity 95-98 %) without
``sizes_seed``; with it, every seed gets the same lengths and identities
in an order of its own."""

import json

import pytest

from br_tpu_torch.corpus import write_corpus
from portbench import corpus
from portbench.tests.conftest import ROOT

MIX = json.loads((ROOT / "portbench" / "traffic"
                  / "ont-r9-95to98.json").read_text())
MODEL = {k: v for k, v in MIX.items() if k != "sizes_seed"}


@pytest.mark.parametrize("seed,reads,genome,mean,max_len", [
    (42, 30, 50_000, 12000, 62000),
    (7, 60, 8000, 900, 3000),
    (2**33 + 12345, 25, 200_000, 12000, 62000),
])
def test_corpus_equals_port_generator(tmp_path, seed, reads, genome, mean,
                                      max_len):
    port = tmp_path / "port.fa"
    write_corpus(str(port), reads, genome, mean, max_len, seed)
    model = dict(MODEL, length=dict(MODEL["length"], mean=mean, max=max_len))
    ours = tmp_path / "ours.fa"
    corpus.write_fasta(str(ours), corpus.make_corpus(reads, genome, model,
                                                     seed))
    assert ours.read_bytes() == port.read_bytes()


def test_model_error_shares_must_sum_to_one():
    bad = dict(MODEL, errors={"sub": 0.5, "ins": 0.3, "del": 0.3})
    with pytest.raises(ValueError):
        corpus.make_corpus(2, 1000, bad, 1)


def _sizes(records):
    out = []
    for d, _s in records:
        words = dict(w.split("=") for w in d.decode().split()[2:])
        out.append((int(words["error-free_length"]),
                    words["read_identity"]))
    return out


def test_sizes_seed_gives_every_seed_the_same_sizes():
    mix = dict(MIX, length=dict(MIX["length"], mean=900, max=3000))
    a = corpus.make_corpus(40, 20_000, mix, 11)
    b = corpus.make_corpus(40, 20_000, mix, 2**33 + 12)
    assert sorted(_sizes(a)) == sorted(_sizes(b))
    assert _sizes(a) != _sizes(b) and a != b
    assert corpus.make_corpus(40, 20_000, mix, 11) == a
