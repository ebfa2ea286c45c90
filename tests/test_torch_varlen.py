"""The port's flash_attn_varlen_func against the JAX package's, forward and
backward, over two sequence layouts of tests/test_varlen.py: lengths
[64, 128, 32] and ragged [37, 200, 1], causal on and off; GQA 4/2.  Same
inputs and tolerances as tests/torch_varlen_cases.py: out and LSE 1e-5,
dq/dk/dv 1e-4, fp32.  Cross lengths: test_torch_varlen_cross.py."""

import pytest
import torch

import torch_varlen_cases as vc

torch.set_num_threads(1)

LENS = {
    "equal": ([64, 128, 32], [64, 128, 32]),
    "ragged": ([37, 200, 1], [37, 200, 1]),
}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lens", list(LENS))
def test_flash_attn_varlen_func_matches_jax(lens, causal):
    vc.check_varlen(*LENS[lens], dict(causal=causal))
