"""The port's flash_attn_varlen_func against the JAX package's with
`sort_sequences`, over lengths [37, 100, 64, 80]: outputs and gradients,
causal on and off, and with dropout, which both packages then key on the
sorted sequence order.  Tolerances of tests/torch_varlen_cases.py: out
1e-5, dq/dk/dv 1e-4, fp32."""

import pytest
import torch

import torch_varlen_cases as vc

torch.set_num_threads(1)

SORT_LENS = [37, 100, 64, 80]


@pytest.mark.parametrize("kw", [dict(causal=False), dict(causal=True),
                                dict(causal=True, dropout_p=0.2,
                                     dropout_seed=11)],
                         ids=["noncausal", "causal", "causal_dropout"])
def test_varlen_sort_sequences_matches_jax(kw):
    vc.check_varlen(SORT_LENS, SORT_LENS, dict(kw, sort_sequences=True),
                    probs=False)
