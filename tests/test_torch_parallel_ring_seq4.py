"""The port's ring attention on seq 4, causal, against the JAX package's
(test_torch_parallel_ring.py says how): four steps, where a rank meets
chunks two and three ranks away (non-causal in
test_torch_parallel_ring_seq4_noncausal.py)."""

import pytest
import torch

import torch_ring_jax as rj

torch.set_num_threads(1)

CASES = ["seq4_causal"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return rj.run_attention(tmp_path_factory.mktemp("ring"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_ring_attention_seq4_matches_jax(run, name):
    rj.check_attention_against_jax(run, name)
