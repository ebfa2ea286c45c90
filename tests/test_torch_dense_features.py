"""The port's flash_attn_func against the JAX package's with each mask,
bias and dropout feature: window, causal window, softcap, ALiBi, and
dropout p = 0.17 with an equal seed (bit-equal dmask).  Same inputs and
tolerances as test_torch_dense.py (tests/torch_dense_cases.py): out and LSE
1e-5, dq/dk/dv 1e-4, fp32."""

import pytest
import torch

import torch_dense_cases as dc

torch.set_num_threads(1)

# name: (B, Hq, Hk, M, N, D, kwargs)
CASES = {
    "window": (1, 2, 2, 128, 128, 64, dict(window_size=(31, 16))),
    "window_causal": (1, 2, 2, 128, 128, 64,
                      dict(causal=True, window_size=(40, 0))),
    "softcap": (1, 2, 2, 128, 128, 64, dict(causal=True, softcap=30.0)),
    "alibi": (1, 2, 2, 128, 128, 64, dict(causal=True, alibi=True)),
    "dropout": (1, 2, 1, 96, 128, 32,
                dict(causal=True, dropout_p=0.17, dropout_seed=1234)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attn_func_features_match_jax(name):
    dc.check_flash_attn_func(*CASES[name])
