"""The port's sharded training path on a data 2 x seq 2 mesh (ring
attention over "seq", the batch over "data") against the JAX package's
(test_torch_parallel_train.py says how and to which gates)."""

import pytest
import torch

import torch_parallel_cases as pc
import torch_ring_jax as rj

torch.set_num_threads(1)

MESH = (2, 2, 1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = rj.train_inputs(MESH)
    job = pc.Spawned("torch_ring_cases.train_body", 4,
                     tmp_path_factory.mktemp("train"), inputs)
    ref = rj.jax_train(inputs)
    return [r for r in job.results() if r is not None], ref


def test_logits_match_jax(run):
    rj.check_train_logits(*run)


def test_losses_match_jax(run):
    rj.check_train_losses(*run)


def test_gradients_match_jax(run):
    rj.check_train_leaves(*run, "grads", rj.GRAD_ATOL)


def test_sgd_step_matches_jax(run):
    rj.check_train_leaves(*run, "sgd", rj.ATOL)


def test_adamw_step_matches_jax(run):
    rj.check_train_leaves(*run, "adam", rj.GRAD_ATOL)
