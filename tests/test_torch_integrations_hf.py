"""The port's HF checkpoint import (integrations/huggingface.py) against the
JAX package's and against transformers itself, on tiny Llama, Mistral
(sliding window 8) and Qwen2 (q/k/v biases randomized) models built from
local config objects (nothing is downloaded).

Tolerances: converted tensors bit-equal to the JAX converter's (through
params_from_jax) at fp32 and bf16, with equal ModelConfig fields; fp32
logits within 2e-3 of transformers' forward; greedy ServingEngine tokens
(device="cpu") equal to HF `generate`'s."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.integrations import huggingface as jhf
from flash_attn_v100_tpu_torch import ServingEngine
from flash_attn_v100_tpu_torch.integrations import huggingface as thf
from flash_attn_v100_tpu_torch.models import transformer as tm

tfs = pytest.importorskip("transformers")

torch.set_num_threads(1)

_SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=128,
              rms_norm_eps=1e-6, rope_theta=10000.0,
              tie_word_embeddings=False)


def _llama():
    cfg = tfs.LlamaConfig(attention_bias=False, **_SMALL)
    torch.manual_seed(0)
    with torch.no_grad():
        return tfs.LlamaForCausalLM(cfg).eval()


def _mistral():
    # sliding_window 8 << seqlen so the local-attention mask bites
    cfg = tfs.MistralConfig(sliding_window=8, **_SMALL)
    torch.manual_seed(1)
    with torch.no_grad():
        return tfs.MistralForCausalLM(cfg).eval()


def _qwen2():
    cfg = tfs.Qwen2Config(**_SMALL)
    torch.manual_seed(2)
    with torch.no_grad():
        model = tfs.Qwen2ForCausalLM(cfg).eval()
        # HF zero-inits the biases: randomize them so the import covers them
        for layer in model.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj):
                proj.bias.normal_(0.0, 0.5)
    return model


FAMILIES = {"llama": _llama, "mistral": _mistral, "qwen2": _qwen2}
_MODELS = {}


def _model(family):
    if family not in _MODELS:
        _MODELS[family] = FAMILIES[family]()
    return _MODELS[family]


def _assert_same_params(params_t, params_j):
    want = tm.params_from_jax(jax.device_get(params_j), device="cpu")
    assert sorted(params_t) == sorted(want)
    for lt, lw in zip(params_t["layers"], want["layers"]):
        assert sorted(lt) == sorted(lw)
    for a, b in zip(tm.param_leaves(params_t), tm.param_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _assert_same_config(cfg_t, cfg_j, dtype):
    fields_t, fields_j = dataclasses.asdict(cfg_t), dataclasses.asdict(cfg_j)
    assert fields_t.pop("dtype") == dtype
    fields_j.pop("dtype")
    assert fields_t == fields_j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_conversion_bit_equal_to_jax(family, dtype):
    model = _model(family)
    params_t, cfg_t = thf.convert_hf_model(model, dtype=getattr(torch, dtype),
                                           device="cpu")
    params_j, cfg_j = jhf.convert_hf_model(model, dtype=getattr(jnp, dtype))
    _assert_same_params(params_t, params_j)
    _assert_same_config(cfg_t, cfg_j, getattr(torch, dtype))
    assert ("bq" in params_t["layers"][0]) == (family == "qwen2")
    assert "lm_head" in params_t
    assert cfg_t.window_size() == ((7, -1) if family == "mistral"
                                   else (-1, -1))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_transformers(family):
    model = _model(family)
    params, cfg = thf.convert_hf_model(model, dtype=torch.float32,
                                       device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        ref = model(torch.from_numpy(toks)).logits.float()
        got = tm.forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("family,prompt_len", [("llama", 6), ("mistral", 12)])
def test_engine_greedy_matches_hf_generate(family, prompt_len):
    """Greedy decode through the paged engine; Mistral's 12-token prompt is
    longer than its window of 8, so the window applies to cached keys."""
    model = _model(family)
    params, cfg = thf.convert_hf_model(model, dtype=torch.float32,
                                       device="cpu")
    prompt = np.random.default_rng(7).integers(
        1, cfg.vocab_size, prompt_len).tolist()
    n_new = 6
    with torch.no_grad():
        out = model.generate(torch.tensor([prompt]), max_new_tokens=n_new,
                             do_sample=False, use_cache=True, pad_token_id=0)
    ref = out[0, len(prompt):].tolist()
    eng = ServingEngine(params, cfg, max_batch=2, num_pages=16,
                        page_size=16, device="cpu")
    rid = eng.submit(prompt, max_new_tokens=n_new)
    assert eng.run_to_completion()[rid] == ref


def _plain_config(hf_config, drop=()):
    """A SimpleNamespace with the config's own (config.json) fields."""
    fields = {k: v for k, v in hf_config.to_dict().items() if k not in drop}
    return types.SimpleNamespace(**fields)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_dict_and_plain_config_convert_as_the_model(family):
    model = _model(family)
    want, cfg_want = thf.convert_hf_model(model, dtype=torch.bfloat16,
                                          device="cpu")
    got, cfg_got = thf.convert_hf_model(
        model.state_dict(), _plain_config(model.config),
        dtype=torch.bfloat16, device="cpu")
    assert cfg_got == cfg_want
    for a, b in zip(tm.param_leaves(got), tm.param_leaves(want)):
        assert torch.equal(a, b)
    # a plain config without tie_word_embeddings keeps the untied lm_head
    untied, _ = thf.convert_hf_model(
        model.state_dict(),
        _plain_config(model.config, drop=("tie_word_embeddings",)),
        dtype=torch.bfloat16, device="cpu")
    assert torch.equal(untied["lm_head"], want["lm_head"])
    # a tied checkpoint drops it: logits come from embed^T
    tied, _ = thf.convert_hf_model(
        model.state_dict(),
        types.SimpleNamespace(**dict(vars(_plain_config(model.config)),
                                     tie_word_embeddings=True)),
        dtype=torch.bfloat16, device="cpu")
    assert "lm_head" not in tied


def test_convert_defaults_to_the_card():
    """device=None means the GPU: with none present the converter raises
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thf.convert_hf_model(_model("llama"))
