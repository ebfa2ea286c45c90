"""The port's ulysses_attention (parallel/ring.py: two all-to-alls around
flash_attn_func) on gloo ranks against the JAX package's on the same
mesh: the three kwarg sets of tests/test_parallel.py::test_ulysses_attention
on seq 4 and a data 2 x seq 2 mesh, outputs within 1e-5, gradients (every
rank's summed) within 1e-4 of jax.grad's."""

import pytest
import torch

import torch_ring_jax as rj

torch.set_num_threads(1)

CASES = ["causal", "causal_window", "noncausal_softcap", "data2_seq2_causal"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return rj.run_attention(tmp_path_factory.mktemp("ulysses"), CASES,
                            "ulysses")


@pytest.mark.parametrize("name", CASES)
def test_ulysses_attention_matches_jax(run, name):
    rj.check_attention_against_jax(run, name, "ulysses")
