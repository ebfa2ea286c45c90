"""The port's sharded training path with attention dropout 0.1 on a data
2 x model 2 mesh (seq 1: flash_attn_func's kernels on each rank's heads)
against the JAX package's (test_torch_parallel_train.py says how and to
which gates), on one layer and without the logits, to keep the file's
JAX compile short.  JAX's result is the global function, its dropout
keyed by global (batch, head) ids: the port keys each rank's mask by its
batch and head offsets and the global head count, so the masks are the
single-device ones."""

import pytest
import torch

import torch_parallel_cases as pc
import torch_ring_jax as rj

torch.set_num_threads(1)

MESH = (2, 1, 2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = rj.train_inputs(MESH, dropout_p=0.1, n_layers=1)
    job = pc.Spawned("torch_ring_cases.train_body", 4,
                     tmp_path_factory.mktemp("train"), inputs)
    ref = rj.jax_train(inputs, logits=False)
    return [r for r in job.results() if r is not None], ref


def test_losses_match_jax(run):
    rj.check_train_losses(*run)


def test_gradients_match_jax(run):
    rj.check_train_leaves(*run, "grads", rj.GRAD_ATOL)


def test_sgd_step_matches_jax(run):
    rj.check_train_leaves(*run, "sgd", rj.ATOL)


def test_adamw_step_matches_jax(run):
    rj.check_train_leaves(*run, "adam", rj.GRAD_ATOL)
