"""The port's ring attention (parallel/ring.py, contiguous layout) on gloo
ranks (tests/torch_ring_cases.py::ring_body, one spawn for the file)
against the JAX package's ring_attention on the same-shaped mesh of its
virtual CPU devices (the cases of tests/test_parallel.py, narrowed): each
rank's output block within 1e-5 of JAX's, the gradients (every rank's
summed) within 1e-4 of jax.grad's.  Chunks run through K1-K3's plain
versions here.  Seq 2, causal and not, and seq 2 x model 2 with GQA;
seq 4 in test_torch_parallel_ring_seq4.py."""

import pytest
import torch

import torch_ring_jax as rj

torch.set_num_threads(1)

CASES = ["seq2_causal", "seq2_noncausal", "seq2_model2_gqa"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return rj.run_attention(tmp_path_factory.mktemp("ring"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_ring_attention_matches_jax(run, name):
    rj.check_attention_against_jax(run, name)
