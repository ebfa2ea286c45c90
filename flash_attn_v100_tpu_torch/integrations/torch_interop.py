"""The torch-tensor entry points of the JAX package's interop module.

The JAX package hands torch tensors to its kernels through dlpack and back
(its `integrations/torch_interop.py`).  This package is torch already, so
the same five names are thin: each calls the port's own entry point on the
caller's tensors, on their device (the GPU's kernels for CUDA tensors, the
plain versions for CPU ones), without a copy.  Code written against the
JAX package's interop module switches by its import line alone.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func


def flash_attn_func_torch(q, k, v, **kwargs):
    """Dense attention on (B, M, H, D) tensors: `flash_attn_func`."""
    return flash_attn_func(q, k, v, **kwargs)


def flash_attn_varlen_func_torch(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                 max_seqlen_q, max_seqlen_k, **kwargs):
    """Packed attention: `flash_attn_varlen_func`."""
    return flash_attn_varlen_func(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                  max_seqlen_q, max_seqlen_k, **kwargs)


def flash_attn_with_kvcache_torch(q, k_cache, v_cache, **kwargs):
    """KV-cache attention: `flash_attn_with_kvcache` (appends in place;
    the return value has the JAX package's tuple shapes)."""
    return flash_attn_with_kvcache(q, k_cache, v_cache, **kwargs)


def flash_attn_backward_torch(q, k, v, dout, **kwargs) -> Tuple:
    """(out, dq, dk, dv): `flash_attn_func` forward (K1) and its backward
    (K2 dQ, K3 dK/dV) through autograd, the reference's
    `_flash_attn_backward` surface collapsed into one call."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        out = flash_attn_func(*leaves, **kwargs)
        grads = torch.autograd.grad(out, leaves, dout.to(out.dtype))
    return (out.detach(), *grads)


def make_torch_autograd_fn(**attn_kwargs):
    """`fa(q, k, v)`: `flash_attn_func` with `attn_kwargs` bound, an
    autograd function already (forward K1, backward K2/K3)::

        fa = make_torch_autograd_fn(causal=True)
        out = fa(q, k, v)          # requires_grad honored
    """
    return functools.partial(flash_attn_func, **attn_kwargs)
