"""The port's sharded serving engine on seq 2 x model 2 (4 gloo ranks, one
spawn; tests/torch_parallel_cases.py::engine_body) against the JAX
package's ServingEngine(mesh=make_mesh(seq=2, model=2)) on the tiny fp32
config: every rank's greedy tokens identical to JAX's."""

import jax
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.models.transformer import param_shardings
from flash_attn_v100_tpu.parallel.mesh import make_mesh as jax_mesh
from flash_attn_v100_tpu.runtime.engine import ServingEngine as JaxEngine

import torch_engine_scenarios as sc
import torch_parallel_cases as pc

torch.set_num_threads(1)

NAME = "seq2_model2_fp32"


@pytest.fixture(scope="module")
def models():
    return sc.make_models()


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    return pc.spawn("engine_body", 4, tmp_path_factory.mktemp("engine"),
                    dict(params=pc.numpy_params(models[1][1]),
                         cases=[NAME]))


def test_sharded_engine_matches_jax_sharded_engine(ranks, models):
    (jcfg, jparams), _ = models
    (data, sp, tp), kw, script = pc.ENGINE_CASES[NAME]
    mesh = jax_mesh(data=data, seq=sp, model=tp)
    params = jax.device_put(jparams, param_shardings(jparams, jcfg, mesh))
    eng = JaxEngine(params, jcfg, max_batch=2, page_size=8, mesh=mesh, **kw)
    assert eng.seq_shards == sp
    want = pc.run_script(eng, script)
    for r in ranks:
        assert r[NAME]["tokens"] == want["tokens"]
    assert np.all([len(t) == 6 for t in want["tokens"].values()])
