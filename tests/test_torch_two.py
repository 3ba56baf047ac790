"""The port's ``two`` pass (K1, K5 and K3 plain versions, on the CPU)
against the JAX package's recorded pass, and the port's ``Two`` oracle
against ``br_tpu``'s.

The recordings (golden/torch_two_pass_k13.npz, tests/torch_cases.py) hold
br_tpu's pass at k=13, CHUNK=2^14, R=32, c=5 on seven chunk families; the
slow tier recomputes them with JAX."""

import pytest

import torch_cases as tc


@pytest.fixture(scope="module")
def cases():
    return tc.all_cases()


@pytest.fixture(scope="module")
def golden():
    return tc.load_golden(tc.golden_path("two"))


@pytest.mark.parametrize("name", tc.FAMILIES)
def test_two_pass_matches_jax(cases, golden, name):
    g, codes, rstart, rlen = cases[name]
    got = tc.run_port_pass("two", cases[name])
    tc.assert_matches_recording(got, golden[name], rstart, rlen)
    if name in ("uniform", "dense", "repeat_rich"):
        assert got[3][5] > 10     # records applied


def test_two_oracle_matches_br_tpu():
    tc.assert_catalog_agrees("two")
    tc.assert_oracles_agree("two", seed=202)
