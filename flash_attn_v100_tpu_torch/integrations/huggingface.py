"""HuggingFace checkpoint import: Llama / Mistral / Qwen2 families.

Converts a `transformers` causal-LM checkpoint into the port's parameter
dict (`models/transformer.py`), so real weights run through the training
step and the serving engine.  The HF model, or a (state_dict, config)
pair, goes straight to torch tensors: each tensor is taken to fp32,
transposed where HF's layout differs, then cast to `dtype` on `device`, a
round to nearest even, so the bytes equal the JAX package's converter
(which goes through numpy).

Supported families (all share the Llama block structure):
  * Llama / TinyLlama / Vicuna ... - the baseline.
  * Mistral - `sliding_window` local attention, lowered to the kernels'
    `window_size=(sliding_window - 1, 0)` left window.
  * Qwen2 - biased q/k/v projections (`qkv_bias`); sliding window only
    when the checkpoint enables `use_sliding_window`.

Layout notes:
  * HF stores projections as (out, in) torch Linears; the port's dict is
    (in, out) -> transpose.
  * HF rotary is the non-interleaved half-split convention -> matches the
    model's `interleaved=False`.
  * Tied embeddings (no separate lm_head) are supported; untied
    checkpoints produce a `lm_head` entry.

Config fields are read with `getattr` and defaults, so a plain object (a
`types.SimpleNamespace` carrying a checkpoint's `config.json` fields)
serves as well as an HF config.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from flash_attn_v100_tpu_torch.config import (
    DeviceLike, as_torch_dtype, resolve_device)
from flash_attn_v100_tpu_torch.models.transformer import ModelConfig


def _family_features(hf_config, state) -> Dict[str, Any]:
    """Derive family-specific ModelConfig fields from an HF config +
    state_dict: sliding window (Mistral always-on when set; Qwen2 behind
    `use_sliding_window`) and q/k/v projection biases (Qwen2)."""
    model_type = getattr(hf_config, "model_type", "llama")
    sliding = getattr(hf_config, "sliding_window", None)
    if model_type == "qwen2" and not getattr(hf_config, "use_sliding_window",
                                             False):
        sliding = None
    qkv_bias = "model.layers.0.self_attn.q_proj.bias" in state
    return dict(sliding_window=sliding, qkv_bias=qkv_bias)


def config_from_hf(hf_config, dtype=torch.bfloat16, **extra) -> ModelConfig:
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads)
    return ModelConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads", None)
        or hf_config.num_attention_heads,
        head_dim=head_dim,
        ffn_dim=hf_config.intermediate_size,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        max_seq_len=getattr(hf_config, "max_position_embeddings", 4096),
        norm_eps=getattr(hf_config, "rms_norm_eps", 1e-5),
        dtype=as_torch_dtype(dtype),
        **extra,
    )


def convert_hf_model(model_or_state: Any, hf_config: Optional[Any] = None,
                     dtype=torch.bfloat16, device: DeviceLike = None
                     ) -> Tuple[Dict, ModelConfig]:
    """(HF *ForCausalLM | state_dict, config) -> (params, ModelConfig),
    the tensors in `dtype` on `device` (default: the GPU,
    config.resolve_device).

    Family (Llama / Mistral / Qwen2) is auto-detected from the config's
    `model_type` and the checkpoint's bias keys."""
    dev = resolve_device(device)
    dt = as_torch_dtype(dtype)
    if hf_config is None:
        hf_config = model_or_state.config
        state = model_or_state.state_dict()
    else:
        state = model_or_state
    cfg = config_from_hf(hf_config, dtype=dt,
                         **_family_features(hf_config, state))

    def arr(name, transpose=False):
        t = state[name].detach().float()
        if transpose:
            t = t.t().contiguous()
        return t.to(dtype=dt, device=dev)

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layer = dict(
            wq=arr(p + "self_attn.q_proj.weight", transpose=True),
            wk=arr(p + "self_attn.k_proj.weight", transpose=True),
            wv=arr(p + "self_attn.v_proj.weight", transpose=True),
            wo=arr(p + "self_attn.o_proj.weight", transpose=True),
            w1=arr(p + "mlp.gate_proj.weight", transpose=True),
            w3=arr(p + "mlp.up_proj.weight", transpose=True),
            w2=arr(p + "mlp.down_proj.weight", transpose=True),
            ln1=arr(p + "input_layernorm.weight"),
            ln2=arr(p + "post_attention_layernorm.weight"),
        )
        if cfg.qkv_bias:
            layer.update(
                bq=arr(p + "self_attn.q_proj.bias"),
                bk=arr(p + "self_attn.k_proj.bias"),
                bv=arr(p + "self_attn.v_proj.bias"),
            )
        layers.append(layer)
    params = dict(
        embed=arr("model.embed_tokens.weight"),
        layers=layers,
        ln_f=arr("model.norm.weight"),
    )
    if "lm_head.weight" in state and not getattr(
            hf_config, "tie_word_embeddings", False):
        params["lm_head"] = arr("lm_head.weight", transpose=True)
    return params, cfg


# The JAX package's older name for the same function (its converter was
# Llama-only before the Mistral / Qwen2 families).
convert_hf_llama = convert_hf_model
