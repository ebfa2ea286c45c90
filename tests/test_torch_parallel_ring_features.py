"""The port's ring attention with a sliding window (causal with softcap on
seq 4, non-causal with both window sides on seq 2) against the JAX
package's (test_torch_parallel_ring.py says how): per-step offsets, rows
left with no live key inside a chunk, and chunks wholly outside the
window, which launch nothing (JAX's test_ring_window_softcap and
test_ring_window_noncausal, narrowed, with gradients).  ALiBi is
test_torch_parallel_ring_alibi.py's."""

import pytest
import torch

import torch_ring_jax as rj

torch.set_num_threads(1)

CASES = ["seq4_window_softcap", "seq2_window_noncausal"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return rj.run_attention(tmp_path_factory.mktemp("ring"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_ring_features_match_jax(run, name):
    rj.check_attention_against_jax(run, name)
