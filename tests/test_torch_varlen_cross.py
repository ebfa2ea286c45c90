"""The port's flash_attn_varlen_func against the JAX package's where the
per-sequence key count differs from the q count, forward and backward:
cross lengths q [16, 48] against k [128, 96] (causal on and off), and
q [64, 64, 96] against keys cut by `seqused_k` [40, 0, 80] (the middle
sequence has no live key: O = 0, LSE = -inf, zero gradients) or shifted by
`leftpad_k` [10, 0, 33] (with more q rows than live keys in the last, so
causal leaves leading rows fully masked).  Tolerances of
tests/torch_varlen_cases.py: out and LSE 1e-5, dq/dk/dv 1e-4, fp32."""

import numpy as np
import pytest
import torch

import torch_varlen_cases as vc

torch.set_num_threads(1)

CROSS = ([16, 48], [128, 96])
LENS = [64, 64, 96]


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_cross_lengths_match_jax(causal):
    vc.check_varlen(*CROSS, dict(causal=causal))


def test_varlen_seqused_k_with_an_empty_sequence_matches_jax():
    out, lse, dq, dk, dv = vc.check_varlen(
        LENS, LENS, dict(causal=True,
                         seqused_k=np.asarray([40, 0, 80], np.int32)))
    assert not out[64:128].any() and torch.isneginf(lse[:, 64:128]).all()
    assert not dq[64:128].any()
    # keys past seqused_k (40.. of the first, all of the second) get nothing
    assert not dk[40:128].any() and not dv[40:128].any()


def test_varlen_leftpad_k_matches_jax():
    out, lse, dq, dk, dv = vc.check_varlen(
        LENS, LENS, dict(causal=True,
                         leftpad_k=np.asarray([10, 0, 33], np.int32)))
    assert not dk[:10].any() and not dv[128:161].any()
    # the last sequence: 96 q rows, 63 live keys, causal: 33 empty rows
    assert torch.isneginf(lse[:, 128:161]).all() and not out[128:161].any()
