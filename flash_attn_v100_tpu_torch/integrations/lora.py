"""LoRA fine-tuning on the flagship model.

The reference's end-to-end training check is an unsloth LoRA SFT through
the attention kernels; this is that as a component of the port: adapters on
the attention (and optionally MLP) projections, gradients flowing through
`flash_attn_func`'s backward kernels (K2 dQ, K3 dK/dV, which run in full:
frozen base weights still need dX; only the base weights' GEMMs drop out),
base weights frozen.

Adapters live in a dict of their own (`lora`: `layers[i][name]` with fp32
`a` (in, r) and `b` (r, out)); the base `params` stay untouched.
`materialize(params, lora)` returns effective weights W + (alpha/r)·A·B for
the wrapped matrices, the product rounded to W's dtype before the add (the
JAX package's order), so every consumer (the training forward, decode, the
serving engine) runs unchanged.

On a mesh (`mesh=`, parallel/mesh.py) each rank holds its base shard
(`shard_params`) and the whole adapters, replicated: `materialize` cuts
each rank's delta as `param_shardings` cuts the base leaf (A @ B[:, cols]
for the column-sharded wq/wk/wv/w1/w3, A[rows, :] @ B for the row-sharded
wo/w2), and the train step sums the adapter gradients over "data" and
"seq" (the rank's tokens) and over "model" (the rank's slice of A or B),
so every rank holds the global gradient and takes the global step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flash_attn_v100_tpu_torch.config import DeviceLike, resolve_device
from flash_attn_v100_tpu_torch.models.transformer import (
    ModelConfig, _map_params, loss_fn, param_shardings)
from flash_attn_v100_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, all_reduce_flat, local_shard)

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Sequence[str] = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def lora_init(params, lcfg: LoraConfig, seed: int = 0,
              device: DeviceLike = None) -> Dict:
    """A ~ N(0, 1/r) fp32 from a torch.Generator seeded with `seed`, B = 0
    fp32 - standard LoRA init (adapters start as a no-op).  Leaves on
    `device` (default: the GPU), requiring grad."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = []
    for lp in params["layers"]:
        ad = {}
        for name in lcfg.targets:
            fan_in, fan_out = lp[name].shape
            a = torch.randn((fan_in, lcfg.rank), generator=gen, device=dev,
                            dtype=torch.float32) * lcfg.rank ** -0.5
            b = torch.zeros((lcfg.rank, fan_out), device=dev,
                            dtype=torch.float32)
            ad[name] = dict(a=a.requires_grad_(True),
                            b=b.requires_grad_(True))
        layers.append(ad)
    return dict(layers=layers)


def lora_from_jax(tree, device: DeviceLike = None) -> Dict:
    """A JAX adapter tree (`lora_init`'s layout, e.g. after
    `jax.device_get`) -> the port's adapters: fp32 leaves on `device`,
    requiring grad."""
    dev = resolve_device(device)

    def conv(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            dev).requires_grad_(True)

    return dict(layers=[{name: {k: conv(w) for k, w in ab.items()}
                         for name, ab in ad.items()}
                        for ad in tree["layers"]])


def lora_leaves(lora) -> List[torch.Tensor]:
    """Every adapter tensor, in the JAX tree's order (per layer: targets
    sorted by name, then a, b)."""
    return [ad[name][k] for ad in lora["layers"] for name in sorted(ad)
            for k in ("a", "b")]


def materialize(params, lora, lcfg: LoraConfig, mesh=None):
    """Effective params: W_eff = W + (scale * A @ B cast to W's dtype).
    With `mesh`, `params` is this rank's shard and each delta is cut as
    its base leaf is: A's rows by the leaf's first spec entry, B's columns
    by its second."""
    specs = (param_shardings(params, None, mesh)["layers"] if mesh is not None
             else [{} for _ in params["layers"]])
    out_layers = []
    for lp, ad, sp in zip(params["layers"], lora["layers"], specs):
        new = dict(lp)
        for name, w in ad.items():
            a, b = w["a"], w["b"]
            spec = tuple(sp.get(name, ())) + (None, None)
            if spec[0] is not None:
                a = local_shard(a, (spec[0], None), mesh)
            if spec[1] is not None:
                b = local_shard(b, (None, spec[1]), mesh)
            delta = (a @ b) * lcfg.scale
            new[name] = lp[name] + delta.to(lp[name].dtype)
        out_layers.append(new)
    out = dict(params)
    out["layers"] = out_layers
    return out


def merge(params, lora, lcfg: LoraConfig):
    """Bake adapters into the base weights (inference export): plain
    tensors, outside autograd."""
    with torch.no_grad():
        return materialize(params, lora, lcfg)


def lora_loss(lora, params, tokens, cfg: ModelConfig, lcfg: LoraConfig,
              **kw) -> torch.Tensor:
    """loss_fn of the materialized params; the base is a frozen operand
    (detached), so gradients reach the adapters only.  `kw` goes to
    loss_fn; with `mesh=` `params` is this rank's shard."""
    frozen = _map_params(params, torch.Tensor.detach)
    return loss_fn(materialize(frozen, lora, lcfg, kw.get("mesh")), tokens,
                   cfg, **kw)


def reduce_lora_grads(lora, mesh) -> None:
    """Each rank's adapter gradients hold its tokens' part of its slice's
    share: summed in place over "data", "seq" and "model" they are the
    global gradient on every rank."""
    if mesh is not None:
        all_reduce_flat([t.grad for t in lora_leaves(lora)], mesh,
                        (DATA_AXIS, SEQ_AXIS, MODEL_AXIS))


def make_lora_train_step(cfg: ModelConfig, lcfg: LoraConfig,
                         optimizer: Optional[Callable] = None, **fwd_kw
                         ) -> Tuple[Any, Any]:
    """-> (step, init_opt).  `init_opt(lora)` builds the optimizer over the
    adapter leaves: AdamW(lr 2e-4, weight_decay 0, betas 0.9/0.999, eps
    1e-8), optax.adamw's defaults otherwise, unless `optimizer` (leaves ->
    torch optimizer) is given.  `step(lora, opt, params, tokens,
    dropout_seeds=None, generator=None) -> (loss, lora, opt)` updates the
    adapters in place; the base params never require grad.  `fwd_kw` goes
    to lora_loss, as the JAX package passes it: with `mesh=`, every rank
    passes its base shard (`shard_params`), the whole adapters and the
    global tokens, and the adapter gradients are summed over the mesh
    (`reduce_lora_grads`) before the update."""
    mesh = fwd_kw.get("mesh")
    if optimizer is None:
        def optimizer(leaves):
            return torch.optim.AdamW(leaves, lr=2e-4, weight_decay=0.0)

    def init_opt(lora):
        return optimizer(lora_leaves(lora))

    def step(lora, opt, params, tokens, dropout_seeds=None, generator=None):
        opt.zero_grad(set_to_none=True)
        loss = lora_loss(lora, params, tokens, cfg, lcfg,
                         dropout_seeds=dropout_seeds, generator=generator,
                         **fwd_kw)
        loss.backward()
        reduce_lora_grads(lora, mesh)
        opt.step()
        return loss.detach(), lora, opt

    return step, init_opt
