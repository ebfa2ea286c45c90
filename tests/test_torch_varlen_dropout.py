"""The port's flash_attn_varlen_func against the JAX package's with
dropout p = 0.25, forward and backward over lengths [64, 128, 32] (dmask
bit-equal, gradients through the same keep bits), and with a cotangent on
the LSE output (dlse, folded into delta by the backward).  Tolerances of
tests/torch_varlen_cases.py: out and LSE 1e-5, dq/dk/dv 1e-4, fp32."""

import torch

import torch_varlen_cases as vc

torch.set_num_threads(1)

LENS = [64, 128, 32]


def test_varlen_dropout_matches_jax():
    vc.check_varlen(LENS, LENS, dict(causal=True, dropout_p=0.25,
                                     dropout_seed=3))


def test_varlen_dlse_matches_jax():
    vc.check_varlen(LENS, LENS, dict(causal=True), dlse=True)
