"""The port's ring attention with ALiBi on seq 2 x model 2 against the JAX
package's (test_torch_parallel_ring.py says how): each rank's slopes are
its global heads', and each step's bias uses the chunk pair's global
offset (JAX's test_ring_alibi, narrowed, with gradients)."""

import pytest
import torch

import torch_ring_jax as rj

torch.set_num_threads(1)

CASES = ["seq2_model2_alibi"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return rj.run_attention(tmp_path_factory.mktemp("ring"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_ring_alibi_matches_jax(run, name):
    rj.check_attention_against_jax(run, name)
