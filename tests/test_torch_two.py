"""The port's ``two`` pass (K1, K5 and K3 plain versions, on the CPU)
against the JAX package's recorded pass, and the port's ``Two`` oracle
against ``br_tpu``'s.

The recordings (golden/torch_two_pass_k13.npz, tests/torch_cases.py) hold
br_tpu's pass at k=13, CHUNK=2^14, R=32, c=5 on seven chunk families; the
slow tier recomputes them with JAX.  golden/torch_two_stress_k13.npz holds
br_tpu's ``one`` and ``two`` passes on the two-error stress family
(``torch_cases.two_stress_case``), where the port's passes (K1, K2 or K5
and K3 plain versions) must match every output, ``cap`` and all of
``aux`` included."""

import numpy as np
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


@pytest.fixture(scope="module")
def two_stress():
    return tc.two_stress_case(tc.TWO_STRESS_SEED)


@pytest.mark.parametrize("strategy", ["one", "two"])
def test_pass_on_two_stress_matches_jax(two_stress, strategy):
    want = tc.load_golden(tc.TWO_STRESS_GOLDEN)[strategy]
    got = tc.run_port_pass(strategy, two_stress)
    tc.assert_matches_recording(got, want, two_stress[2], two_stress[3])
    assert np.array_equal(got[3], want[3])     # every aux counter
    assert got[3][1] > 0 and got[2].any()      # CAP_OVERFLOW, capped reads


@pytest.mark.slow
def test_two_stress_recording_is_jax_pass_output():
    """Record br_tpu's passes on the stress family again (eager JAX,
    about a minute on the CPU) and compare with the recording."""
    want = tc.load_golden(tc.TWO_STRESS_GOLDEN)
    for st, arrs in tc.record_two_stress().items():
        for a, b in zip(arrs, want[st]):
            assert np.array_equal(a, b), st
