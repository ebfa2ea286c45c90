"""The port's ring attention with dropout on a data 2 x seq 2 mesh against
the JAX package's (test_torch_parallel_ring.py says how; JAX's
test_ring_grad_dropout, narrowed): each rank's batch rows key the dropout
by their global index (b0), so the ranks of the two data lines draw
different masks, as the single device does.  Also against the unsharded
port flash_attn_func with the same seed (JAX's
test_ring_dropout_matches_dense): the global (row, col, batch, head)
keying gives the single-device keep mask, so the outputs agree within
1e-5 and the gradients within 1e-4."""

import numpy as np
import pytest
import torch

import torch_ring_cases as rc
import torch_ring_jax as rj
from flash_attn_v100_tpu_torch import flash_attn_func

torch.set_num_threads(1)

CASES = ["data2_seq2_dropout"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return rj.run_attention(tmp_path_factory.mktemp("ring"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_ring_dropout_matches_jax(run, name):
    rj.check_attention_against_jax(run, name)


def test_ring_dropout_matches_unsharded_flash_attn_func(run):
    name = CASES[0]
    x = rc.attn_inputs(name, rc.RING_CASES)
    q, k, v = (torch.from_numpy(x[n]).requires_grad_(True) for n in "qkv")
    out = flash_attn_func(q, k, v, causal=True, dropout_p=0.3,
                          dropout_seed=rc.RING_SEED)
    (out * torch.from_numpy(x["do"])).sum().backward()
    got, grads = rj.assembled(run, name)
    np.testing.assert_allclose(got, out.detach().numpy(), rtol=0,
                               atol=rj.ATOL)
    for g, t in zip(grads, (q, k, v)):
        np.testing.assert_allclose(g, t.grad.numpy(), rtol=0,
                                   atol=rj.GRAD_ATOL)
    # the mask dropped something: the output differs from no dropout's
    ref = flash_attn_func(q, k, v, causal=True).detach().numpy()
    assert np.abs(got - ref).max() > 1e-2
