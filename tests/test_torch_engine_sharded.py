"""The sharded serving engine on 4 gloo ranks (one spawn for the file;
tests/torch_parallel_cases.py::engine_body), the JAX package's sharded
engine cases on the tiny fp32 config: tensor-parallel on model 2; seq 2 x
model 2 with int8 and fp32 pools; seq 4 with a sequence crossing shard
boundaries mid-decode; seq 4 holding 5-page sequences with 2 pages a
shard; prefix-cache copies across shard offsets.  Every rank's greedy
tokens equal the port's unsharded engine's
(tests/test_torch_engine_sharded_jax.py holds one case against the JAX
package's sharded engine)."""

import pytest
import torch

from flash_attn_v100_tpu_torch import ServingEngine

import torch_engine_scenarios as sc
import torch_parallel_cases as pc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return sc.make_models()


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    return pc.spawn("engine_body", 4, tmp_path_factory.mktemp("engine"),
                    dict(params=pc.numpy_params(models[1][1]),
                         cases=list(pc.ENGINE_CASES)))


def _unsharded(models, name):
    """The port's engine on one process, the case's script and pool, with
    pages enough for every sequence."""
    _, (tcfg, tparams) = models
    _, kw, script = pc.ENGINE_CASES[name]
    kw = dict(dict(max_batch=2, page_size=8), **dict(kw, num_pages=16))
    return pc.run_script(ServingEngine(tparams, tcfg, device="cpu", **kw),
                         script)


@pytest.mark.parametrize("name", list(pc.ENGINE_CASES))
def test_sharded_engine_matches_unsharded(ranks, models, name):
    (data, sp, tp), kw, _ = pc.ENGINE_CASES[name]
    want = _unsharded(models, name)
    members = [r[name] for r in ranks if name in r]
    assert len(members) == data * sp * tp
    for got in members:
        assert got["tokens"] == want["tokens"], (got["tokens"],
                                                 want["tokens"])
        assert got["seq_shards"] == sp
        # each rank holds its heads and its shard's pages (+ scratch)
        assert got["pool_shape"][:2] == (2 // tp, (kw["num_pages"] + 1) * 2)
        assert (got["prefix_hits"], got["prefix_tokens_reused"]) == (
            want["prefix_hits"], want["prefix_tokens_reused"])
    if name == "seq4_prefix_offsets":
        # 3 full pages copied: slots 0-1 on seq rank 0, slot 2 on rank 1
        assert members[0]["prefix_hits"] == 1
        assert members[0]["prefix_tokens_reused"] == 24
    if name == "seq4_capacity":
        # 5 pages at once for the long sequence: no single shard's 2 could
        assert len(want["tokens"]["long"]) == 14
