"""Llama-family decoder (TinyLlama, Mistral's sliding window, Qwen2's qkv
bias) on the port's attention ops: training and decode.

Parameters are a plain dict with the JAX package's names (`embed`,
`layers[i]` with wq/wk/wv/wo/w1/w3/w2/ln1/ln2 and optional bq/bk/bv,
`ln_f`, optional `lm_head`); `params_from_jax` carries a JAX parameter tree
across.  Training (`forward`, `loss_fn`, `sgd_train_step`,
`make_train_step`) runs attention through `flash_attn_func` (K1 forward,
K2/K3 backward); decode through `flash_attn_with_kvcache`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flash_attn_v100_tpu_torch.config import (
    DeviceLike, as_torch_dtype, resolve_device)
from flash_attn_v100_tpu_torch.ops.flash_attention import (
    flash_attn_func, normalize_seed)
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.rotary import apply_rotary_emb


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 128
    ffn_dim: int = 5632
    rope_theta: float = 10000.0
    max_seq_len: int = 4096
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    dropout_p: float = 0.0
    # Mistral-family local attention: each token sees the previous
    # `sliding_window` positions inclusive -> window_size (sw - 1, causal)
    sliding_window: Optional[int] = None
    # Qwen2-family biased q/k/v projections
    qkv_bias: bool = False

    def window_size(self) -> Tuple[int, int]:
        if self.sliding_window is None:
            return (-1, -1)
        return (self.sliding_window - 1, -1)

    @staticmethod
    def tiny(**kw) -> "ModelConfig":
        base = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                    n_kv_heads=2, head_dim=32, ffn_dim=256, max_seq_len=256,
                    dtype=torch.float32)
        base.update(kw)
        return ModelConfig(**base)

    @staticmethod
    def tinyllama_1b(**kw) -> "ModelConfig":
        """TinyLlama-1.1B widths (config.json of
        TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T)."""
        base = dict(vocab_size=32000, dim=2048, n_layers=22, n_heads=32,
                    n_kv_heads=4, head_dim=64, ffn_dim=5632,
                    rope_theta=10000.0, max_seq_len=2048, norm_eps=1e-5,
                    dtype=torch.bfloat16)
        base.update(kw)
        return ModelConfig(**base)


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                lm_head: bool = False) -> Dict:
    """He-style random init from one torch.Generator seeded with `seed`,
    weights in cfg.dtype on `device`.  `lm_head=True` adds an untied
    output projection (dim, vocab) as Llama checkpoints carry."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = as_torch_dtype(cfg.dtype)

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dt)

    hd, hq, hk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    layers = []
    for _ in range(cfg.n_layers):
        layer = dict(
            wq=dense(cfg.dim, (cfg.dim, hq * hd)),
            wk=dense(cfg.dim, (cfg.dim, hk * hd)),
            wv=dense(cfg.dim, (cfg.dim, hk * hd)),
            wo=dense(hq * hd, (hq * hd, cfg.dim)),
            w1=dense(cfg.dim, (cfg.dim, cfg.ffn_dim)),
            w3=dense(cfg.dim, (cfg.dim, cfg.ffn_dim)),
            w2=dense(cfg.ffn_dim, (cfg.ffn_dim, cfg.dim)),
            ln1=torch.ones(cfg.dim, dtype=dt, device=dev),
            ln2=torch.ones(cfg.dim, dtype=dt, device=dev),
        )
        if cfg.qkv_bias:
            layer.update(bq=torch.zeros(hq * hd, dtype=dt, device=dev),
                         bk=torch.zeros(hk * hd, dtype=dt, device=dev),
                         bv=torch.zeros(hk * hd, dtype=dt, device=dev))
        layers.append(layer)
    embed = torch.randn((cfg.vocab_size, cfg.dim), generator=gen, device=dev,
                        dtype=torch.float32) * 0.02
    params = dict(embed=embed.to(dt), layers=layers,
                  ln_f=torch.ones(cfg.dim, dtype=dt, device=dev))
    if lm_head:
        params["lm_head"] = dense(cfg.dim, (cfg.dim, cfg.vocab_size))
    return params


def params_from_jax(tree, device: DeviceLike = None, dtype=None,
                    requires_grad: bool = False) -> Dict:
    """A JAX parameter tree (nested dicts/lists of arrays, e.g. after
    `jax.device_get`) -> the port's parameter dict with the same names, as
    torch tensors on `device` (in `dtype` if given), leaves that require
    grad if `requires_grad` (as torch optimizers need).  Carries `lm_head`
    and the Qwen2 `bq/bk/bv` when present."""
    dev = resolve_device(device)
    dt = as_torch_dtype(dtype)

    def conv(x):
        a = np.asarray(x)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            # ml_dtypes bfloat16 has no torch counterpart in numpy form
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(device=dev, dtype=dt or t.dtype).requires_grad_(
            requires_grad)

    out = dict(embed=conv(tree["embed"]), ln_f=conv(tree["ln_f"]),
               layers=[{k: conv(v) for k, v in lp.items()}
                       for lp in tree["layers"]])
    if tree.get("lm_head") is not None:
        out["lm_head"] = conv(tree["lm_head"])
    return out


def rope_tables(cfg: ModelConfig, seqlen: Optional[int] = None,
                device: DeviceLike = None):
    """(cos, sin) fp32 (seqlen, head_dim // 2) on `device` (default: the
    GPU, config.resolve_device)."""
    seqlen = seqlen or cfg.max_seq_len
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (-np.arange(0, half) / half)
    ang = np.arange(seqlen)[:, None] * freqs[None, :]
    dev = resolve_device(device)
    return (torch.as_tensor(np.cos(ang), dtype=torch.float32, device=dev),
            torch.as_tensor(np.sin(ang), dtype=torch.float32, device=dev))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """fp32 statistics; cast back to x.dtype BEFORE the scale multiply (the
    JAX package's rounding order)."""
    x32 = x.to(torch.float32)
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * scale


def qkv_proj(h, lp, cfg: ModelConfig, B: int, T: int):
    """Projections for one block; Qwen2-family checkpoints carry biases.
    The head counts follow the weights: a rank's column shard
    (shard_params) gives its own heads."""
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return tuple(x.reshape(B, T, -1, cfg.head_dim) for x in (q, k, v))


def mlp(x, lp):
    h2 = x @ lp["w1"]
    return (torch.nn.functional.silu(h2) * (x @ lp["w3"])) @ lp["w2"]


def logits_head(x, params):
    """Final projection: untied `lm_head` when present, else embed^T; a
    16-bit matmul then a cast to fp32."""
    head = params.get("lm_head")
    head = params["embed"].T if head is None else head
    return (x @ head).to(torch.float32)


def param_leaves(params: Dict) -> List[torch.Tensor]:
    """Every tensor of a parameter dict, in a fixed order."""
    leaves = [params["embed"], params["ln_f"]]
    if "lm_head" in params:
        leaves.append(params["lm_head"])
    for lp in params["layers"]:
        leaves += [lp[k] for k in sorted(lp)]
    return leaves


def param_shardings(params: Dict, cfg: ModelConfig, mesh) -> Dict:
    """Tensor-parallel placement, the JAX package's: which mesh axis shards
    each dimension of each parameter (None: replicated), in the parameter
    dict's structure.  wq/wk/wv (and their biases) column-sharded on
    "model", one block of heads a rank; wo row-sharded (the all-reduce after
    it is paged_forward's); w1/w3 column-, w2 row-sharded; norms, embed and
    an untied lm_head replicated."""
    from flash_attn_v100_tpu_torch.parallel.mesh import MODEL_AXIS
    del cfg, mesh   # the specs name axes; shard_params checks the sizes
    col, row, rep = (None, MODEL_AXIS), (MODEL_AXIS, None), ()

    def layer_spec(lp):
        spec = dict(wq=col, wk=col, wv=col, wo=row, w1=col, w3=col, w2=row,
                    ln1=rep, ln2=rep)
        if "bq" in lp:
            spec.update(bq=(MODEL_AXIS,), bk=(MODEL_AXIS,), bv=(MODEL_AXIS,))
        return spec

    out = dict(embed=rep, layers=[layer_spec(lp) for lp in params["layers"]],
               ln_f=rep)
    if "lm_head" in params:
        out["lm_head"] = rep
    return out


def shard_params(params: Dict, cfg: ModelConfig, mesh) -> Dict:
    """This rank's slices of `params` (init_params' or convert_hf_model's
    dict) under `param_shardings`, contiguous copies.  The kv heads must
    divide the model axis, so that each rank's q heads find their kv heads
    on the same rank."""
    from flash_attn_v100_tpu_torch.parallel.mesh import MODEL_AXIS, local_shard
    tp = mesh.shape[MODEL_AXIS]
    if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.ffn_dim % tp:
        raise ValueError(f"heads {cfg.n_heads}/{cfg.n_kv_heads} and ffn "
                         f"{cfg.ffn_dim} must divide the model axis ({tp})")
    specs = param_shardings(params, cfg, mesh)

    def cut(x, spec):
        return local_shard(x, spec, mesh).contiguous() if spec else x
    out = {k: cut(v, specs[k]) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: cut(v, sp[k]) for k, v in lp.items()}
                     for lp, sp in zip(params["layers"], specs["layers"])]
    return out


def _map_params(params: Dict, fn: Callable) -> Dict:
    out = {k: fn(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: fn(v) for k, v in lp.items()}
                     for lp in params["layers"]]
    return out


# ======================================================================
# Training path
# ======================================================================

def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *, mesh=None,
            dropout_seeds=None, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab) fp32, differentiable in the
    parameters.  With cfg.dropout_p > 0, layer i's attention dropout is
    keyed by `dropout_seeds[i]` (an (n_layers, 2) array of (lo, hi) words,
    e.g. JAX's key_data(fold_in(rng_key, i))[:2]), else by two words drawn
    from `generator`."""
    if mesh is not None:
        raise NotImplementedError("mesh= (sharded training: ring and "
                                  "Ulysses attention) comes with the next "
                                  "port slice")
    B, S = tokens.shape
    dev = tokens.device
    cos, sin = rope_tables(cfg, cfg.max_seq_len, device=dev)
    pos = torch.arange(S, device=dev)[None, :]
    x = params["embed"][tokens]
    for i, lp in enumerate(params["layers"]):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, cfg, B, S)
        q = apply_rotary_emb(q, cos, sin, pos, interleaved=False)
        k = apply_rotary_emb(k, cos, sin, pos, interleaved=False)
        seed = normalize_seed(
            cfg.dropout_p,
            None if dropout_seeds is None else dropout_seeds[i], generator)
        attn = flash_attn_func(q, k, v, causal=True, dropout_p=cfg.dropout_p,
                               window_size=cfg.window_size(),
                               dropout_seed=seed)
        x = x + attn.reshape(B, S, -1) @ lp["wo"]
        x = x + mlp(rmsnorm(x, lp["ln2"], cfg.norm_eps), lp)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return logits_head(x, params)


def loss_fn(params, tokens: torch.Tensor, cfg: ModelConfig, **kw
            ) -> torch.Tensor:
    """Next-token cross entropy, the mean over B * (S - 1) positions."""
    logits = forward(params, tokens[:, :-1], cfg, **kw)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].to(torch.long))[..., 0]
    return nll.mean()


def sgd_train_step(params, tokens: torch.Tensor, cfg: ModelConfig,
                   lr: float = 1e-2, **kw):
    """One plain-SGD step; returns (loss, new_params) with p - lr * g in p's
    dtype.  `params` is left as it is."""
    leaves = _map_params(params, lambda t: t.detach().requires_grad_(True))
    flat = param_leaves(leaves)
    loss = loss_fn(leaves, tokens, cfg, **kw)
    grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    new = _map_params(leaves, lambda t: (t - lr * grads[id(t)].to(t.dtype))
                      .detach())
    return loss.detach(), new


def make_train_step(cfg: ModelConfig, optimizer=None, mesh=None):
    """-> (step, init_opt).  `init_opt(params)` builds the optimizer over the
    parameters' leaves, which must require grad (`params_from_jax(...,
    requires_grad=True)`, or `requires_grad_()` on each): AdamW(lr 3e-4,
    weight_decay 0.01, betas 0.9/0.999, eps 1e-8, decay on every leaf), the
    defaults of optax.adamw, unless `optimizer` (leaves -> torch optimizer)
    is given.  `step(params, opt, tokens, dropout_seeds=None,
    generator=None) -> (loss, params, opt)` updates the parameters in
    place."""
    if mesh is not None:
        raise NotImplementedError("mesh= (sharded training: ring and "
                                  "Ulysses attention) comes with the next "
                                  "port slice")
    if optimizer is None:
        def optimizer(leaves):
            return torch.optim.AdamW(leaves, lr=3e-4, weight_decay=0.01)

    def init_opt(params):
        return optimizer(param_leaves(params))

    def step(params, opt, tokens, dropout_seeds=None, generator=None):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg, dropout_seeds=dropout_seeds,
                       generator=generator)
        loss.backward()
        opt.step()
        return loss.detach(), params, opt

    return step, init_opt


# ======================================================================
# Decode path (serving)
# ======================================================================

def init_kv_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                   device: DeviceLike = None) -> List[Tuple[torch.Tensor,
                                                            torch.Tensor]]:
    """Per-layer HND contiguous caches (B, Hk, N, D)."""
    dt = as_torch_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dt, device=dev),
             torch.zeros(shape, dtype=dt, device=dev))
            for _ in range(cfg.n_layers)]


def decode_step(params, caches, tokens, cache_seqlens, cfg: ModelConfig):
    """One decode step: tokens (B, T_new) -> (logits (B, T_new, vocab) fp32,
    caches).  Rotary is fused into the kvcache op at the cache position;
    the caches are appended in place and returned for the JAX call shape."""
    B, T = tokens.shape
    dev = tokens.device
    cos, sin = rope_tables(cfg, cfg.max_seq_len, device=dev)
    x = params["embed"][tokens]
    for lp, (kc, vc) in zip(params["layers"], caches):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, cfg, B, T)
        attn, _ = flash_attn_with_kvcache(
            q, kc, vc, k=k, v=v, rotary_cos=cos, rotary_sin=sin,
            cache_seqlens=cache_seqlens, causal=True,
            window_size=cfg.window_size(), rotary_interleaved=False,
            kv_cache_layout="HND")
        x = x + attn.reshape(B, T, -1) @ lp["wo"]
        x = x + mlp(rmsnorm(x, lp["ln2"], cfg.norm_eps), lp)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return logits_head(x, params), caches
