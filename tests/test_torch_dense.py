"""The port's dense attention (ops/flash_attention.py::flash_attn_func over
the plain versions of K1, K2 and K3) against the JAX package's
flash_attn_func and jax.grad (Pallas interpret mode), fp32, same numpy
inputs, at a subset of tests/test_dense.py's SHAPES: GQA, ragged M != N,
head_dim 40 (JAX pads it to 48, the port's plain path takes it as is) and M > N causal with fully masked rows.  Mask,
bias and dropout features are in test_torch_dense_features.py.

Tolerances (tests/torch_dense_cases.py): out and LSE 1e-5, dq/dk/dv 1e-4."""

import pytest
import torch

import torch_dense_cases as dc

torch.set_num_threads(1)

# name: (B, Hq, Hk, M, N, D, kwargs)
CASES = {
    "gqa_causal": (2, 4, 2, 192, 192, 64, dict(causal=True)),
    "cross_m_lt_n": (1, 2, 1, 128, 256, 64, dict(causal=True)),
    "ragged_d40": (1, 2, 2, 200, 136, 40, dict()),
    "m_gt_n_causal_masked_rows": (1, 2, 2, 256, 64, 64, dict(causal=True)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attn_func_matches_jax(name):
    out, lse, dq = dc.check_flash_attn_func(*CASES[name])
    if name == "m_gt_n_causal_masked_rows":
        _, _, _, M, N, _, _ = CASES[name]
        dead = M - N              # rows before M - N see no key
        assert not out[:, :dead].any() and not dq[:, :dead].any()
        assert torch.isneginf(lse[:, :, :dead]).all()
