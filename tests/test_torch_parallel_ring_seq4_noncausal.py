"""The port's ring attention on seq 4, non-causal, against the JAX
package's (test_torch_parallel_ring.py says how): every rank attends
every chunk, past and future, over four steps."""

import pytest
import torch

import torch_ring_jax as rj

torch.set_num_threads(1)

CASES = ["seq4_noncausal"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return rj.run_attention(tmp_path_factory.mktemp("ring"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_ring_attention_seq4_noncausal_matches_jax(run, name):
    rj.check_attention_against_jax(run, name)
