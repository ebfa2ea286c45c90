"""Public KV-cache attention API — `flash_attn_with_kvcache`.

Surface of flash_attn_v100_tpu/ops/kvcache.py for 16/32-bit caches:
  * q (B, T_new, Hq, D); contiguous cache (B_c, N, Hk, D) or paged cache
    (num_pages, page_size, Hk, D) + block_table (B, max_pages) in the
    token-major "NHD" layout, or (B_c, Hk, N, D) / (Hk, num_pages,
    page_size, D) in the head-major "HND" layout;
  * optional new k/v appended at cache_seqlens (+ leftpad);
  * fused rotary on q and new k (interleaved or half-split); the q position
    is cache_seqlens + row when causal/local, else cache_seqlens;
  * cache_batch_idx and cache_leftpad (each rejected with paged caches);
  * causal implies window_right = 0, and `causal` itself only matters when
    T_new > 1;
  * num_splits (0 = auto), return_softmax_lse.

The append updates `k_cache` / `v_cache` IN PLACE (the reference CUDA
contract); the return value still has the JAX package's tuple shapes so
callers port one to one:
    out                               # no new kv, no lse
    (out, lse)                        # return_softmax_lse
    (out, (k_cache, v_cache))         # new kv appended
    (out, lse, (k_cache, v_cache))    # both
where the caches are the caller's own tensors.  Every layout reaches the
kernels as a strided view, without a copy.

Attention runs in one of two kernels: the split-KV decode kernel (K4,
ops/cuda/decode.py) or, for paged prefills with group * T_new >=
VARLEN_PREFILL_MIN_ROWS and page_size % 128 == 0, the paged varlen forward
(K8, ops/cuda/varlen.py).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda.decode import (
    merge_partials, paged_decode_attention)
from flash_attn_v100_tpu_torch.ops.cuda.varlen import (
    flash_attn_varlen_fwd_paged)
from flash_attn_v100_tpu_torch.ops.rotary import apply_rotary_emb

# Paged prefills with at least this many q rows (group * T_new) route to the
# paged varlen forward instead of the decode-shaped kernel.  Module-level so
# tests and benchmarks can pin either path.
VARLEN_PREFILL_MIN_ROWS = 1024


def _pick_page_size(N: int) -> int:
    for ps in (512, 256, 128, 64, 32, 16, 8):
        if N % ps == 0:
            return ps
    return N


def uses_varlen_route(paged: bool, group: int, t_new: int,
                      page_size: int) -> bool:
    """Whether a call of this shape runs K8 (else K4)."""
    return (paged and group * t_new >= VARLEN_PREFILL_MIN_ROWS
            and page_size % 128 == 0)


def flash_attn_with_kvcache(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k: Optional[torch.Tensor] = None,
    v: Optional[torch.Tensor] = None,
    rotary_cos: Optional[torch.Tensor] = None,
    rotary_sin: Optional[torch.Tensor] = None,
    cache_seqlens: Optional[Union[int, torch.Tensor]] = None,
    cache_batch_idx: Optional[torch.Tensor] = None,
    cache_leftpad: Optional[torch.Tensor] = None,
    block_table: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    rotary_interleaved: bool = True,
    alibi_slopes: Optional[torch.Tensor] = None,
    num_splits: int = 0,
    return_softmax_lse: bool = False,
    *,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    kv_cache_layout: str = "NHD",
    q_position_lens: Optional[torch.Tensor] = None,
    append_window: Optional[Tuple] = None,
):
    """See the module docstring."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "quantized KV caches (k_scales/v_scales: int8/fp8/int4 pools) "
            "come with port slice 4 (quantized pools)")
    if q_position_lens is not None or append_window is not None:
        raise NotImplementedError(
            "q_position_lens/append_window (sequence-sharded decode) come "
            "with port slice 5 (parallel)")
    B, T_new, Hq, D_og = q.shape
    dev = q.device
    paged = block_table is not None
    if paged and cache_batch_idx is not None:
        raise ValueError("cache_batch_idx is not supported with paged KV cache")
    if paged and cache_leftpad is not None:
        raise ValueError("cache_leftpad is not supported with paged KV cache")
    if (k is None) != (v is None):
        raise ValueError("k and v must be given together")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        # the kernels read the pool as is: allocate caches in q's dtype
        raise TypeError(f"k_cache/v_cache ({k_cache.dtype}, {v_cache.dtype}) "
                        f"must have q's dtype {q.dtype}")
    if softmax_scale is None:
        softmax_scale = D_og ** -0.5

    # ---- head-major views of the caches (no copies) ----
    if kv_cache_layout == "NHD":
        if paged:
            kc, vc = k_cache.permute(2, 0, 1, 3), v_cache.permute(2, 0, 1, 3)
        else:
            kc, vc = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    elif kv_cache_layout == "HND":
        kc, vc = k_cache, v_cache
    else:
        raise ValueError(f"unknown kv_cache_layout {kv_cache_layout!r}")

    if paged:
        Hk, P, page_size, D = kc.shape
        N_capacity = block_table.shape[1] * page_size
    else:
        Bc, Hk, N, D = kc.shape
        page_size = _pick_page_size(N)
        N_capacity = N
    if D != D_og:
        raise ValueError("cache head dim must match q")
    group = Hq // Hk

    # ---- cache_seqlens / leftpad / batch index ----
    if cache_seqlens is None:
        cache_seqlens = N_capacity if k is None else 0
    if isinstance(cache_seqlens, int):
        cache_seqlens = torch.full((B,), cache_seqlens, dtype=torch.int32,
                                   device=dev)
    cache_seqlens = torch.as_tensor(cache_seqlens).to(device=dev,
                                                       dtype=torch.int32)
    qlens = cache_seqlens
    leftpad = (None if cache_leftpad is None
               else torch.as_tensor(cache_leftpad).to(device=dev,
                                                      dtype=torch.int32))
    appended = k is not None
    # positions of the new tokens (B, T): rotary and the append share them
    pos = qlens[:, None] + torch.arange(T_new, dtype=torch.int32, device=dev)

    # ---- rotary on q and new k ----
    local = window_size[0] >= 0 or window_size[1] >= 0
    if rotary_cos is not None:
        rot = dict(interleaved=rotary_interleaved)
        if appended and (causal or local):
            # q and k at the same positions: one rotation over both
            qk = apply_rotary_emb(torch.cat([q, k.to(q.dtype)], dim=2),
                                  rotary_cos, rotary_sin, pos, **rot)
            q, k = qk[:, :, :Hq], qk[:, :, Hq:].to(k.dtype)
        else:
            pos_q = pos if (causal or local) else qlens[:, None].expand(
                B, T_new)
            q = apply_rotary_emb(q, rotary_cos, rotary_sin, pos_q, **rot)
            if appended:
                k = apply_rotary_emb(k, rotary_cos, rotary_sin, pos, **rot)

    # ---- append new k/v in place ----
    # Duplicate targets (e.g. padded engine rows that all point at the
    # scratch page with cache_seqlens 0) give an undefined winner; callers
    # only let that happen where nobody reads the slot.
    if appended:
        if paged:
            col = (pos // page_size).clamp(0, block_table.shape[1] - 1)
            page_ids = torch.gather(block_table.to(dev), 1, col.long())
            off = pos % page_size
            h_ix = torch.arange(Hk, device=dev)[None, None, :]
            kc[h_ix, page_ids[..., None], off[..., None]] = k.to(kc.dtype)
            vc[h_ix, page_ids[..., None], off[..., None]] = v.to(vc.dtype)
        else:
            rows = pos if leftpad is None else pos + leftpad[:, None]
            b_ix = (torch.arange(B, device=dev) if cache_batch_idx is None
                    else torch.as_tensor(cache_batch_idx).to(dev))
            h_ix = torch.arange(Hk, device=dev)[None, :, None]
            kc[b_ix[:, None, None], h_ix, rows[:, None, :]] = k.transpose(
                1, 2).to(kc.dtype)
            vc[b_ix[:, None, None], h_ix, rows[:, None, :]] = v.transpose(
                1, 2).to(vc.dtype)

    lens_total = cache_seqlens + (T_new if appended else 0)

    # ---- page pool view + table ----
    if paged:
        pool_k, pool_v = kc[None], vc[None]            # (1, Hk, P, ps, D)
        tbl = block_table.to(device=dev, dtype=torch.int32)
    else:
        nb = N // page_size
        pool_k = kc.reshape(Bc, Hk, nb, page_size, D)
        pool_v = vc.reshape(Bc, Hk, nb, page_size, D)
        bidx = (torch.arange(B, dtype=torch.int32, device=dev)
                if cache_batch_idx is None
                else torch.as_tensor(cache_batch_idx).to(device=dev,
                                                         dtype=torch.int32))
        tbl = (bidx[:, None] * nb
               + torch.arange(nb, dtype=torch.int32, device=dev)[None, :])

    # causal => window_right = 0; the causal flag itself then only shapes
    # the triangle among the new tokens
    wl, wr = int(window_size[0]), int(window_size[1])
    if causal:
        wr = 0
    params = masklib.MaskParams(causal=bool(causal and T_new > 1),
                                window_left=wl, window_right=wr,
                                softcap=float(softcap),
                                has_alibi=alibi_slopes is not None)
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes).to(device=dev,
                                                  dtype=torch.float32)
        if slopes.dim() == 1:
            slopes = slopes[None].expand(B, Hq)

    dtype_og = q.dtype
    if uses_varlen_route(paged, group, T_new, page_size):
        # uniform cu_q = b * T_new and seqlens_k = lens_total reproduce the
        # decode alignment (first new token at lens_total - T_new)
        qp = q.reshape(B * T_new, Hq, D)
        cu_q = torch.arange(B + 1, dtype=torch.int32, device=dev) * T_new
        out, lse_v = flash_attn_varlen_fwd_paged(
            qp, pool_k[0], pool_v[0], tbl, cu_q, lens_total, T_new,
            int(tbl.shape[1]) * page_size, float(softmax_scale), params,
            alibi_slopes=slopes)
        out = out.reshape(B, T_new, Hq, D).to(dtype_og)
        lse = None
        if return_softmax_lse:
            lse = lse_v.reshape(Hq, B, T_new).permute(1, 0, 2)
    else:
        # q rows folded per kv head: row r = g * T_new + t, padded to 8
        n_rows = group * T_new
        Rq = max(-(-n_rows // 8) * 8, 8)
        q_rows = q.transpose(1, 2).reshape(B, Hk, n_rows, D)
        if Rq != n_rows:
            q_rows = torch.cat(
                [q_rows, q_rows.new_zeros(B, Hk, Rq - n_rows, D)], dim=2)
        slopes_rows = None
        if slopes is not None:
            sr = slopes.reshape(B, Hk, group, 1).expand(B, Hk, group, T_new)
            sr = sr.reshape(B, Hk, n_rows)
            if Rq != n_rows:
                sr = torch.cat([sr, sr.new_zeros(B, Hk, Rq - n_rows)], dim=2)
            slopes_rows = sr[..., None]
        # first new token's position in the live frame: the pre-append
        # length when appending, else lens - T_new
        o_part, lse_part = paged_decode_attention(
            q_rows, pool_k, pool_v, tbl, lens_total, leftpad,
            qpos_vec=qlens if appended else qlens - T_new,
            softmax_scale=float(softmax_scale), params=params, t_new=T_new,
            group=group, num_splits=num_splits,
            alibi_slopes_rows=slopes_rows)
        o, lse = merge_partials(o_part, lse_part)
        o = o[:, :, :n_rows].reshape(B, Hk, group, T_new, D)
        out = o.permute(0, 3, 1, 2, 4).to(dtype_og).reshape(B, T_new, Hq, D)
        if return_softmax_lse:
            lse = lse[:, :, :n_rows, 0].reshape(B, Hq, T_new)

    results = [out]
    if return_softmax_lse:
        results.append(lse)
    if appended:
        results.append((k_cache, v_cache))
    return results[0] if len(results) == 1 else tuple(results)
