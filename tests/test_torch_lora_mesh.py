"""The port's LoRA fine-tuning on a mesh (integrations/lora.py:
make_lora_train_step(cfg, lcfg, mesh=)) on seq 2 x model 2 gloo ranks
(tests/torch_ring_cases.py::lora_body, one spawn for the file) against
the JAX package's jitted make_lora_train_step(cfg, lcfg, mesh=mesh) on the
same-shaped mesh of its virtual CPU devices (tests/torch_lora_jax.py), on
ModelConfig.tiny(n_layers=1) (fp32) with rank-2 adapters on all seven
projections and tokens (2, 33): ring attention over "seq", the base
column- and row-sharded over "model".  Every rank's materialize on its
shard equals the shard of the unsharded one; its step's loss within 1e-5
of JAX's; each adapter's gradient (summed over "seq" and "model") and its
value after one AdamW step within 1e-4.  The (2, 1, 2) mesh, with its
"data" sum, is tests/test_torch_lora_mesh_data.py."""

import pytest
import torch

import torch_lora_jax as lj
import torch_parallel_cases as pc

torch.set_num_threads(1)

MESH = (1, 2, 2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = lj.lora_inputs(MESH)
    job = pc.Spawned("torch_ring_cases.lora_body", 4,
                     tmp_path_factory.mktemp("lora"), inputs)
    ref = lj.jax_lora(inputs)
    return [r for r in job.results() if r is not None], ref


def test_materialize_on_shards_is_the_shard_of_materialize(run):
    lj.check_materialize(run[0])


def test_loss_matches_jax(run):
    lj.check_loss(*run)


def test_adapter_gradients_match_jax(run):
    lj.check_leaves(*run, "grads")


def test_adamw_step_matches_jax(run):
    lj.check_leaves(*run, "adam")
