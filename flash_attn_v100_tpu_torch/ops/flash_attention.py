"""Public dense attention API: `flash_attn_func`, forward and backward.

The surface of flash_attn_v100_tpu/ops/flash_attention.py::flash_attn_func:
  * layout (B, M, H, D) -> (B, M, H, D); GQA when Hk < Hq;
  * any head dim up to 256: the kernel wrappers pad it to the kernel's
    head dim and slice it back; the default scale D**-0.5 is taken on the
    caller's head dim;
  * M == 1 drops causal (bottom-right causal is a no-op for one row);
  * softcap and dropout are mutually exclusive;
  * `deterministic` is accepted and always holds: K3 sums dK/dV in one
    block per key tile with no atomics, so two backward calls are bitwise
    equal;
  * `return_attn_probs` returns (out, lse, dmask), dmask entries +1 kept /
    -1 dropped (None without dropout).
Gradients flow to q, k and v through a `torch.autograd.Function` that
saves (q, k, v, out, lse, seed) and runs K2 and K3 (ops/cuda/bwd.py); the
lse output is differentiable too (its cotangent enters as dlse).  ALiBi
slopes and the seed get no gradient.

Dropout seeds: an int becomes (lo, hi); a (2,) array or tensor is taken as
(lo, hi); a `torch.Generator` (the counterpart of JAX's `rng_key`) draws
two 32-bit words.

On CUDA tensors the kernels take bf16 or fp16 (fp16 computed natively) and
raise for other dtypes; CPU tensors of any float dtype take the plain
versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops import philox
from flash_attn_v100_tpu_torch.ops.cuda.bwd import flash_attn_dense_bwd
from flash_attn_v100_tpu_torch.ops.cuda.fwd import (
    dense_keep_mask, flash_attn_dense_fwd, slopes_bh)


@dataclasses.dataclass(frozen=True)
class _Cfg:
    softmax_scale: float
    params: masklib.MaskParams
    dropout_p: float


class _FlashAttnFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, slopes, seed, cfg: _Cfg):
        out, lse = flash_attn_dense_fwd(
            q, k, v, cfg.softmax_scale, cfg.params, alibi_slopes=slopes,
            dropout_p=cfg.dropout_p, dropout_seed=seed)
        ctx.save_for_backward(q, k, v, out, lse, slopes, seed)
        ctx.cfg = cfg
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, slopes, seed = ctx.saved_tensors
        cfg = ctx.cfg
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attn_dense_bwd(
            q, k, v, out, dout.contiguous(), lse, cfg.softmax_scale,
            cfg.params, alibi_slopes=slopes, dropout_p=cfg.dropout_p,
            dropout_seed=seed, dlse=dlse)
        return dq, dk, dv, None, None, None


def normalize_seed(dropout_p: float, dropout_seed=None,
                   generator: Optional[torch.Generator] = None
                   ) -> Optional[torch.Tensor]:
    """The (2,) int64 CPU tensor (lo, hi) the kernels are keyed with, or None
    without dropout."""
    if dropout_p <= 0.0:
        return None
    if generator is not None:
        words = torch.randint(0, 2 ** 32, (2,), generator=generator,
                              dtype=torch.int64, device=generator.device)
        return words.cpu()
    if dropout_seed is None:
        dropout_seed = 0
    if isinstance(dropout_seed, int):
        return torch.tensor(philox.split_seed(dropout_seed), dtype=torch.int64)
    seed = torch.as_tensor(np.asarray(dropout_seed, dtype=np.int64)
                           if not isinstance(dropout_seed, torch.Tensor)
                           else dropout_seed).to("cpu", torch.int64)
    if seed.shape == (2,):
        return seed & 0xFFFFFFFF
    return torch.tensor(philox.split_seed(int(seed)), dtype=torch.int64)


def flash_attn_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    *,
    dropout_seed=None,
    generator: Optional[torch.Generator] = None,
):
    """Dense flash attention, (B, M, H, D) -> (B, M, H, D); differentiable
    in q, k and v.  With `return_attn_probs` returns (out, lse, dmask)."""
    del deterministic  # always deterministic (module docstring)
    if softcap > 0.0 and dropout_p > 0.0:
        raise ValueError("softcap and dropout are mutually exclusive")
    B, M, Hq, D = q.shape
    N, Hk = k.shape[1], k.shape[2]
    if Hq % Hk != 0:
        raise ValueError("number of q heads must be divisible by number of "
                         "kv heads")
    if softmax_scale is None:
        softmax_scale = D ** -0.5

    params = masklib.MaskParams(
        causal=bool(causal and M > 1), window_left=int(window_size[0]),
        window_right=int(window_size[1]), softcap=float(softcap),
        has_alibi=alibi_slopes is not None)
    slopes = (None if alibi_slopes is None
              else slopes_bh(alibi_slopes, B, Hq, q.device))
    seed = normalize_seed(dropout_p, dropout_seed, generator)
    cfg = _Cfg(softmax_scale=float(softmax_scale), params=params,
               dropout_p=float(dropout_p))
    out, lse = _FlashAttnFn.apply(q, k, v, slopes, seed, cfg)

    if return_attn_probs:
        dmask = None
        if dropout_p > 0.0:
            keep = torch.stack([dense_keep_mask(b, Hq, M, N, dropout_p, seed,
                                                device=q.device)
                                for b in range(B)])
            dmask = torch.where(keep, 1.0, -1.0).to(q.dtype)
        return out, lse, dmask
    return out
