"""The port's zigzag ring (parallel/ring.py, layout="zigzag") on gloo ranks
against the JAX package's ring_attention(layout="zigzag") on the same mesh
(seq 4: JAX's test_ring_zigzag and test_ring_zigzag_grad, narrowed;
test_torch_parallel_ring.py says how): each rank's two stripes' output
within 1e-5, the gradients within 1e-4.  Seq 2 with softcap in
test_torch_parallel_zigzag_softcap.py."""

import pytest
import torch

import torch_ring_jax as rj

torch.set_num_threads(1)

CASES = ["zigzag_seq4"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return rj.run_attention(tmp_path_factory.mktemp("zigzag"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_zigzag_ring_matches_jax(run, name):
    rj.check_attention_against_jax(run, name)
