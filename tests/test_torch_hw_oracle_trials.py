"""The smallest varlen and kvcache trials (by M N H D) of the port's fuzz,
seeds 0-29, trials 0-2 of each, through both packages (the JAX
repository's benchmarks/fuzz_oracle.py in interpret mode, the port's
plain versions; CPU): each package's output passes the reference's gate
(2 x the bf16 oracle's error + 1e-5) against the other package's fp32
oracle.  The trials are picked from the port's draws, which
test_torch_hw_oracle.py holds equal to the JAX script's."""

import pytest
import torch
import torch_fuzz_cases as fc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_calls():
    return {seed: calls[1] for seed, calls in
            fc.record(range(30), jax_too=False).items()}


@pytest.mark.parametrize("kind", ["varlen", "kvcache"])
def test_smallest_trial_matches_across_packages(port_calls, kind,
                                                monkeypatch):
    seed, i = fc.smallest_trial(port_calls, kind)
    fc.check_trial_across_packages(monkeypatch, seed, i, kind)
