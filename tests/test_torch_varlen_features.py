"""The port's flash_attn_varlen_func against the JAX package's with each
mask and bias feature, forward and backward, over lengths [64, 128, 32]:
window, causal window, softcap, ALiBi as (Hq,) and as (B, Hq) slopes (the
latter with GQA group 4).  Tolerances of tests/torch_varlen_cases.py: out
and LSE 1e-5, dq/dk/dv 1e-4, fp32.  Dropout and dlse:
test_torch_varlen_dropout.py."""

import numpy as np
import pytest
import torch

import torch_varlen_cases as vc

torch.set_num_threads(1)

LENS = [64, 128, 32]
SLOPES_H = np.asarray([0.5 ** (i + 1) for i in range(vc.Hq)], np.float32)
SLOPES_BH = np.random.default_rng(3).uniform(0.01, 0.3, (3, 8)).astype(
    np.float32)

# name: (kwargs, extra check_varlen arguments)
CASES = {
    "window": (dict(window_size=(31, 8)), {}),
    "window_causal": (dict(causal=True, window_size=(20, 0)), {}),
    "softcap": (dict(causal=True, softcap=25.0), {}),
    "alibi_h": (dict(causal=True, alibi_slopes=SLOPES_H), {}),
    "alibi_bh_gqa4": (dict(causal=True, alibi_slopes=SLOPES_BH),
                      dict(hq=8, hk=2)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_varlen_features_match_jax(name):
    kw, extra = CASES[name]
    vc.check_varlen(LENS, LENS, kw, **extra)
