"""The port's sharded training path (models/transformer.py: forward,
loss_fn, sgd_train_step and make_train_step with mesh=) on a seq 2 x
model 2 mesh of gloo ranks (tests/torch_ring_cases.py::train_body, one
spawn for the file) against the JAX package's on the same-shaped mesh of
its virtual CPU devices (tests/torch_ring_jax.py::jax_train, one jitted
call), on ModelConfig.tiny() (fp32, 2 layers) with the same weights and
tokens (4, 33): ring attention over "seq", the projections
tensor-parallel over "model".  Each rank's logits block within 1e-4 of
JAX's forward(mesh=), its losses within 1e-5 of JAX's loss_fn(mesh=), its
gradient shards within 1e-4 of jax.grad's, its shards after one SGD step
within 1e-5 and after one AdamW step within 1e-4 of JAX's updates."""

import pytest
import torch

import torch_parallel_cases as pc
import torch_ring_jax as rj

torch.set_num_threads(1)

MESH = (1, 2, 2)


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
