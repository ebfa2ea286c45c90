"""One-process parts of the port's parallel layer: shard_params against the
JAX package's param_shardings (init_params' tree, with Qwen2-style biases,
and HF Llama / Qwen2 trees from convert_hf_model, each rank's slice equal
to the block JAX places on the device at its coordinates), meshes without
a process group, initialize() and make_hybrid_mesh on one process, and the
sharded attention on a one-rank mesh against the unsharded calls."""

import jax
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.integrations import huggingface as jhf
from flash_attn_v100_tpu.models.transformer import param_shardings
from flash_attn_v100_tpu.parallel.mesh import make_mesh as jax_mesh
from flash_attn_v100_tpu_torch import flash_attn_func, flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.integrations import huggingface as thf
from flash_attn_v100_tpu_torch.models import transformer as tm
from flash_attn_v100_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, attention_specs,
    flash_attn_func_sharded, flash_attn_with_kvcache_sharded, initialize,
    make_hybrid_mesh, make_mesh, merge_lse_across)

import torch_engine_scenarios as sc

torch.set_num_threads(1)


def _rank_mesh(shape, rank):
    """The Mesh rank `rank` of a (data, seq, model) grid would hold, with
    no process group (slicing needs only the coordinates)."""
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), rank, {})


def _check_slices(params_t, cfg_t, params_j, cfg_j, shape=(1, 2, 2)):
    jm = jax_mesh(*shape)
    jtree = {k: v for k, v in params_j.items() if k != "lm_head"}
    placed = jax.device_put(jtree, param_shardings(jtree, cfg_j, jm))
    for r in range(int(np.prod(shape))):
        mesh = _rank_mesh(shape, r)
        local = tm.shard_params(params_t, cfg_t, mesh)
        dev = jm.devices[tuple(mesh.coords[a]
                               for a in (DATA_AXIS, SEQ_AXIS, MODEL_AXIS))]

        def block(x):
            return next(np.array(s.data) for s in x.addressable_shards
                        if s.device == dev)
        assert torch.equal(local["embed"], torch.from_numpy(
            block(placed["embed"])))
        assert torch.equal(local["ln_f"], torch.from_numpy(
            block(placed["ln_f"])))
        for lt, lj in zip(local["layers"], placed["layers"]):
            assert sorted(lt) == sorted(lj)
            for k in lt:
                assert lt[k].is_contiguous()
                assert torch.equal(lt[k], torch.from_numpy(block(lj[k]))), k
        if "lm_head" in params_t:          # replicated
            assert torch.equal(local["lm_head"], params_t["lm_head"])


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_shard_params_match_jax_param_shardings(qkv_bias):
    (jcfg, jparams), (tcfg, tparams) = sc.make_models(qkv_bias=qkv_bias)
    _check_slices(tparams, tcfg, jparams, jcfg)
    _check_slices(tparams, tcfg, jparams, jcfg, shape=(2, 1, 2))


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_shard_params_of_converted_hf_trees(family):
    tfs = pytest.importorskip("transformers")
    cfg = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=128,
               rms_norm_eps=1e-6, tie_word_embeddings=False)
    torch.manual_seed(0)
    with torch.no_grad():
        model = (tfs.LlamaForCausalLM(tfs.LlamaConfig(**cfg))
                 if family == "llama"
                 else tfs.Qwen2ForCausalLM(tfs.Qwen2Config(**cfg))).eval()
    params_t, cfg_t = thf.convert_hf_model(model, dtype=torch.float32,
                                           device="cpu")
    params_j, cfg_j = jhf.convert_hf_model(model, dtype=jax.numpy.float32)
    assert "lm_head" in params_t
    assert ("bq" in params_t["layers"][0]) == (family == "qwen2")
    _check_slices(params_t, cfg_t, params_j, cfg_j)


def test_shard_params_rejects_heads_that_do_not_divide():
    _, (tcfg, tparams) = sc.make_models()
    with pytest.raises(ValueError):          # 2 kv heads over model 4
        tm.shard_params(tparams, tcfg, _rank_mesh((1, 1, 4), 0))


def test_one_process_meshes_and_entry_points(monkeypatch):
    for var in ("FA_COORDINATOR", "FA_NUM_PROCESSES", "FA_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False                 # no env: a no-op
    monkeypatch.setenv("FA_NUM_PROCESSES", "1")
    assert initialize() is False
    monkeypatch.setenv("FA_NUM_PROCESSES", "2")
    with pytest.raises(ValueError):              # no coordinator / id
        initialize()
    m = make_mesh()
    assert m.shape == {DATA_AXIS: 1, SEQ_AXIS: 1, MODEL_AXIS: 1}
    assert m.coords == {DATA_AXIS: 0, SEQ_AXIS: 0, MODEL_AXIS: 0}
    assert m.group is None and set(m.groups.values()) == {None}
    assert make_mesh(data=-1).shape[DATA_AXIS] == 1
    for kw in (dict(model=2), dict(seq=0)):
        with pytest.raises(ValueError):
            make_mesh(**kw)
    assert make_hybrid_mesh().shape == m.shape
    for kw in (dict(seq=2), dict(data=2)):
        with pytest.raises(ValueError):
            make_hybrid_mesh(**kw)
    assert attention_specs(m, shard_kv_heads=True) == (
        (DATA_AXIS, None, MODEL_AXIS, None),
        (DATA_AXIS, None, MODEL_AXIS, None))
    assert attention_specs(m, shard_kv_heads=False, seq_shard_kv=True)[1] \
        == (DATA_AXIS, SEQ_AXIS, None, None)


def test_one_rank_mesh_is_the_unsharded_call():
    """On a mesh of one rank the collectives are identities: the sharded
    functions give the unsharded calls' results exactly."""
    mesh = make_mesh()
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    q, k, v = mk(2, 16, 4, 32), mk(2, 16, 2, 32), mk(2, 16, 2, 32)
    assert torch.equal(flash_attn_func_sharded(q, k, v, mesh, causal=True),
                       flash_attn_func(q, k, v, causal=True))
    qd, kc, vc = mk(2, 1, 4, 32), mk(2, 2, 64, 32), mk(2, 2, 64, 32)
    lens = torch.tensor([40, 9], dtype=torch.int32)
    kn, vn = mk(2, 1, 2, 32), mk(2, 1, 2, 32)
    kc2, vc2 = kc.clone(), vc.clone()
    got = flash_attn_with_kvcache_sharded(
        qd, kc, vc, mesh, lens, k=kn, v=vn, causal=True,
        return_softmax_lse=True)
    want = flash_attn_with_kvcache(
        qd, kc2, vc2, kn, vn, cache_seqlens=lens, causal=True,
        kv_cache_layout="HND", return_softmax_lse=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    lse_t = want[1].permute(0, 2, 1)[..., None]
    o, lse = merge_lse_across(want[0], lse_t, mesh, SEQ_AXIS)
    assert torch.equal(o, want[0]) and torch.equal(lse, lse_t)
