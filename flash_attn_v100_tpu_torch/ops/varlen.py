"""Public varlen attention API: `flash_attn_varlen_func`, forward and
backward.

The surface of flash_attn_v100_tpu/ops/varlen.py::flash_attn_varlen_func:
  * packed q (Tq, Hq, D), k/v (Tk, Hk, D) split by int32 `cu_seqlens_q` /
    `cu_seqlens_k` (B + 1,); GQA when Hk < Hq; `max_seqlen_q` /
    `max_seqlen_k` are host ints bounding the sequences' lengths;
  * `seqused_k` caps a sequence's keys (0: none), `leftpad_k` skips its
    leading keys; masks are aligned per sequence (bottom-right causal);
  * any head dim up to 256 (the kernel wrappers pad to the kernel's head
    dim); the default scale D**-0.5 is taken on the caller's head dim;
  * causal holds only when max_seqlen_q > 1;
  * softcap and dropout are mutually exclusive;
  * `deterministic` is accepted and always holds (K7 sums dK/dV in one
    block per key tile, no atomics);
  * ALiBi slopes (Hq,) or (B, Hq);
  * the dropout seed is an int, a (2,) array or a `torch.Generator`
    (ops/flash_attention.py::normalize_seed);
  * `return_attn_probs` returns (out, lse (Hq, Tq), dmask), dmask
    (Tq, Hq, max_seqlen_k) +1 kept / -1 dropped (None without dropout);
  * `sort_sequences` packs the sequences in descending key-length order
    around the kernels and restores the order after (skipped with
    `return_attn_probs` and dropout): the outputs and gradients are JAX's,
    dropout keyed on the sorted sequence index as there.  On a
    per-sequence grid the order is only a scheduling order.
  * `block_table` (paged K/V, forward-only as in JAX): an HND pool
    (Hk, P, ps, D) with `kv_cache_layout="HND"` goes to K8
    (ops/cuda/varlen.py::flash_attn_varlen_fwd_paged), outside autograd;
    an NHD pool (P, ps, Hk, D) with ps % 128 == 0 is viewed as HND and goes
    there too; any other NHD pool (or `return_attn_probs`) is gathered page
    by page into a fixed-stride packed stream fed to K5-K7 with
    `seqused_k = min(seqused_k, seqlens)`, which is differentiable.
Gradients flow to q, k and v through a `torch.autograd.Function` that saves
(q, k, v, out, lse, cu_q, cu_k, seqused_k, leftpad_k, slopes, seed) and runs
K6 and K7; the lse output is differentiable too (its cotangent enters as
dlse).  On CUDA tensors the kernels take bf16 or fp16; CPU tensors of any
float dtype take the plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda.fwd import (
    KERNEL_HEAD_DIMS, dense_keep_mask, kernel_head_dim, pad_head_dim,
    slopes_bh)
from flash_attn_v100_tpu_torch.ops.cuda.varlen import (
    flash_attn_varlen_bwd, flash_attn_varlen_fwd, flash_attn_varlen_fwd_paged)
from flash_attn_v100_tpu_torch.ops.flash_attention import normalize_seed


@dataclasses.dataclass(frozen=True)
class _VarlenCfg:
    softmax_scale: float
    params: masklib.MaskParams
    dropout_p: float
    max_seqlen_q: int
    max_seqlen_k: int


class _FlashAttnVarlenFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, seqused_k, leftpad_k, slopes, seed,
                cfg: _VarlenCfg):
        out, lse = flash_attn_varlen_fwd(
            q, k, v, cu_q, cu_k, cfg.max_seqlen_q, cfg.max_seqlen_k,
            cfg.softmax_scale, cfg.params, alibi_slopes=slopes,
            dropout_p=cfg.dropout_p, dropout_seed=seed, seqused_k=seqused_k,
            leftpad_k=leftpad_k)
        ctx.save_for_backward(q, k, v, out, lse, cu_q, cu_k, seqused_k,
                              leftpad_k, slopes, seed)
        ctx.cfg = cfg
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        (q, k, v, out, lse, cu_q, cu_k, seqused_k, leftpad_k, slopes,
         seed) = ctx.saved_tensors
        cfg = ctx.cfg
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attn_varlen_bwd(
            q, k, v, out, dout.contiguous(), lse, cu_q, cu_k,
            cfg.max_seqlen_q, cfg.max_seqlen_k, cfg.softmax_scale,
            cfg.params, alibi_slopes=slopes, dropout_p=cfg.dropout_p,
            dropout_seed=seed, seqused_k=seqused_k, leftpad_k=leftpad_k,
            dlse=dlse)
        return dq, dk, dv, None, None, None, None, None, None, None


def _int32(x, dev) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x).to(dev, torch.int32)


def _gather_paged_kv(k_pages, v_pages, block_table, cu_seqlens_k,
                     max_seqlen_k: int):
    """NHD pages (P, ps, Hk, D) and a (B, >= pages) block table -> packed
    (B * per, Hk, D) K/V at a fixed stride per = ceil(max_seqlen_k / ps) *
    ps, its cu_seqlens and the true lengths.  Differentiable in the pages."""
    _, ps, Hk, D = k_pages.shape
    B = block_table.shape[0]
    pages = -(-max_seqlen_k // ps)
    table = block_table[:, :pages].to(device=k_pages.device, dtype=torch.long)
    per = pages * ps
    k = k_pages[table].reshape(B * per, Hk, D)
    v = v_pages[table].reshape(B * per, Hk, D)
    cu = torch.arange(B + 1, dtype=torch.int32, device=k.device) * per
    seqlens = cu_seqlens_k[1:] - cu_seqlens_k[:-1]
    return k, v, cu, seqlens


def _length_sort_perms(cu_q, cu_k, Tq: int, Tk: int):
    """Permutations packing the sequences in descending key-length order,
    on the device: (order (B,), new cu_q, new cu_k, perm_q (Tq,),
    inv_q (Tq,), perm_k (Tk,)); `perm` maps a sorted position to its source
    row, `inv` an original row to its sorted position."""
    B = cu_q.shape[0] - 1
    order = torch.argsort(-(cu_k[1:] - cu_k[:-1]), stable=True)

    def perm_axis(cu, T):
        lens = (cu[1:] - cu[:-1])[order]
        new_cu = F.pad(torch.cumsum(lens, 0, dtype=torch.int32), (1, 0))
        pos = torch.arange(T, dtype=torch.int32, device=cu.device)
        seg = torch.searchsorted(new_cu[1:], pos, right=True).clamp(0, B - 1)
        perm = (cu[order[seg]] + (pos - new_cu[seg])).clamp(0, T - 1)
        return new_cu, perm.long()

    new_cu_q, perm_q = perm_axis(cu_q, Tq)
    new_cu_k, perm_k = perm_axis(cu_k, Tk)
    inv_q = torch.zeros(Tq, dtype=torch.long, device=cu_q.device)
    inv_q[perm_q] = torch.arange(Tq, device=cu_q.device)
    return order, new_cu_q, new_cu_k, perm_q, inv_q, perm_k


def varlen_dropout_mask(cu_seqlens_q, Tq: int, Hq: int, max_seqlen_k: int,
                        dropout_p: float, seed, device=None) -> torch.Tensor:
    """The keep mask (Tq, Hq, max_seqlen_k) as the varlen kernels key it:
    rows at within-sequence q positions, columns 0.. max_seqlen_k - 1,
    bh = b * Hq + h; packed rows of no sequence take segment -1 and
    position 0, as build_ragged_info gives them."""
    cu = [int(x) for x in cu_seqlens_q.tolist()]
    keep = torch.empty((Tq, Hq, max_seqlen_k), dtype=torch.bool,
                       device=device)
    keep[:] = dense_keep_mask(-1, Hq, 1, max_seqlen_k, dropout_p, seed,
                              device=device).transpose(0, 1)
    for b in range(len(cu) - 1):
        if cu[b + 1] > cu[b]:
            keep[cu[b]:cu[b + 1]] = dense_keep_mask(
                b, Hq, cu[b + 1] - cu[b], max_seqlen_k, dropout_p, seed,
                device=device).transpose(0, 1)
    return keep


def _paged_forward(q, k_pool, v_pool, block_table, cu_q, cu_k,
                   max_seqlen_q, max_seqlen_k, softmax_scale, params, slopes,
                   seqused_k, leftpad_k):
    """K8 on an HND pool, forward-only (no autograd, as in JAX)."""
    D = q.shape[-1]
    if q.device.type == "cuda" and D not in KERNEL_HEAD_DIMS:
        Dk = kernel_head_dim(D)
        q, k_pool, v_pool = (pad_head_dim(t, Dk)
                             for t in (q, k_pool, v_pool))
    with torch.no_grad():
        out, lse = flash_attn_varlen_fwd_paged(
            q, k_pool, v_pool, block_table, cu_q, cu_k[1:] - cu_k[:-1],
            int(max_seqlen_q), int(max_seqlen_k), softmax_scale, params,
            alibi_slopes=slopes, seqused_k=seqused_k, leftpad_k=leftpad_k)
    return out[..., :D], lse


def flash_attn_varlen_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens_q,
    cu_seqlens_k,
    max_seqlen_q: int,
    max_seqlen_k: int,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    block_table=None,
    *,
    seqused_k=None,
    leftpad_k=None,
    dropout_seed=None,
    generator: Optional[torch.Generator] = None,
    kv_cache_layout: str = "NHD",
    sort_sequences: bool = False,
):
    """Varlen flash attention on packed (total, H, D) tensors; see the
    module docstring.  Returns out (Tq, Hq, D), or (out, lse, dmask) with
    `return_attn_probs`."""
    del deterministic  # always deterministic (module docstring)
    if softcap > 0.0 and dropout_p > 0.0:
        raise ValueError("softcap and dropout are mutually exclusive")
    dev = q.device
    cu_q = _int32(cu_seqlens_q, dev)
    cu_k = _int32(cu_seqlens_k, dev)
    sk = _int32(seqused_k, dev)
    lp = _int32(leftpad_k, dev)
    B = cu_q.shape[0] - 1

    paged_hnd = False
    if block_table is not None:
        if dropout_p > 0.0:
            raise ValueError("paged K/V with dropout is not supported")
        block_table = torch.as_tensor(block_table).to(dev, torch.int32)
        if (kv_cache_layout == "NHD" and k.shape[1] % 128 == 0
                and not return_attn_probs):
            # the pool viewed as HND (Hk, P, ps, D): K8 takes any strides
            k, v = k.permute(2, 0, 1, 3), v.permute(2, 0, 1, 3)
            kv_cache_layout = "HND"
        if kv_cache_layout == "HND":
            if k.shape[2] % 128:
                raise ValueError("HND paged varlen needs page_size % 128 == "
                                 f"0 (got {k.shape[2]})")
            if return_attn_probs:
                raise ValueError("return_attn_probs unsupported with paged "
                                 "HND pools")
            paged_hnd = True
        else:
            k, v, cu_k, seqlens = _gather_paged_kv(k, v, block_table, cu_k,
                                                   int(max_seqlen_k))
            sk = seqlens if sk is None else torch.minimum(sk, seqlens)

    Tq, Hq, D = q.shape
    Hk = k.shape[0] if paged_hnd else k.shape[1]
    if Hq % Hk != 0:
        raise ValueError("number of q heads must be divisible by number of "
                         "kv heads")
    if softmax_scale is None:
        softmax_scale = D ** -0.5
    params = masklib.MaskParams(
        causal=bool(causal and max_seqlen_q > 1),
        window_left=int(window_size[0]), window_right=int(window_size[1]),
        softcap=float(softcap), has_alibi=alibi_slopes is not None)
    slopes = (None if alibi_slopes is None
              else slopes_bh(alibi_slopes, B, Hq, dev))
    seed = normalize_seed(dropout_p, dropout_seed, generator)

    if paged_hnd:
        return _paged_forward(q, k, v, block_table, cu_q, cu_k, max_seqlen_q,
                              max_seqlen_k, float(softmax_scale), params,
                              slopes, sk, lp)[0]

    inv_q = None
    if (sort_sequences and B > 1
            and not (return_attn_probs and dropout_p > 0.0)):
        order, new_cu_q, cu_k, perm_q, inv_q, perm_k = _length_sort_perms(
            cu_q, cu_k, Tq, k.shape[0])
        q, k, v = q[perm_q], k[perm_k], v[perm_k]
        cu_q = new_cu_q
        sk = None if sk is None else sk[order]
        lp = None if lp is None else lp[order]
        slopes = None if slopes is None else slopes[order]

    cfg = _VarlenCfg(softmax_scale=float(softmax_scale), params=params,
                     dropout_p=float(dropout_p),
                     max_seqlen_q=int(max_seqlen_q),
                     max_seqlen_k=int(max_seqlen_k))
    out, lse = _FlashAttnVarlenFn.apply(q, k, v, cu_q, cu_k, sk, lp, slopes,
                                        seed, cfg)
    if inv_q is not None:
        out, lse = out[inv_q], lse[:, inv_q]

    if return_attn_probs:
        dmask = None
        if dropout_p > 0.0:
            keep = varlen_dropout_mask(cu_q, Tq, Hq, int(max_seqlen_k),
                                       dropout_p, seed, dev)
            dmask = torch.where(keep, 1.0, -1.0).to(q.dtype)
        return out, lse, dmask
    return out
