"""The port's zigzag ring (parallel/ring.py, layout="zigzag") on gloo ranks
against the JAX package's ring_attention(layout="zigzag") on the same mesh
on seq 2 with softcap (test_torch_parallel_zigzag.py says how; seq 4
there).  A zigzag chunk's second half attends the whole of a later
rank's chunk: softcap's tanh runs on every one of those scores."""

import pytest
import torch

import torch_ring_jax as rj

torch.set_num_threads(1)

CASES = ["zigzag_seq2_softcap"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return rj.run_attention(tmp_path_factory.mktemp("zigzag"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_zigzag_softcap_ring_matches_jax(run, name):
    rj.check_attention_against_jax(run, name)
