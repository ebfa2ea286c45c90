"""Sharded attention: head-parallel dense attention and sequence-sharded
KV-cache attention with the cross-rank LSE merge.

Each function is the body the JAX package runs under `shard_map`
(flash_attn_v100_tpu/parallel/sharded.py), run by every rank of a
parallel/mesh.py Mesh on its own shards.  Heads split over "model" need no
collective inside attention (the per-(batch, head) kernels take a head
shard as it is); the KV sequence split over "seq" gives each rank a partial
result over its keys, and the returned fp32 LSE combines the partials
(`merge_lse_across`): two collectives over (rows, D), not over the cache.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.rotary import apply_rotary_emb
from flash_attn_v100_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, all_reduce, attention_specs,
    local_shard)


def flash_attn_func_sharded(q, k, v, mesh: Mesh, **kwargs):
    """Head- and data-parallel dense attention (K1 forward, K2/K3 through
    autograd).  q (B, M, Hq, D), k, v (B, N, Hk, D) are the global tensors,
    as every rank holds them; each rank attends with its block, batch on
    "data" and q heads on "model", and returns that block of the output,
    (B / data, M, Hq / model, D).  k/v heads are sharded with q's when Hk
    divides the model axis; else every rank takes the one kv head its q
    heads map to (global GQA kv_head = q_head // group), which needs each
    rank's q heads inside one group.  `alibi_slopes` (Hq,) or (B, Hq) are
    global too; head ids inside the call are local to the rank.  No
    collective: gradients reach the global inputs through the slices."""
    Hq, Hk = q.shape[2], k.shape[2]
    tp = mesh.shape[MODEL_AXIS]
    if Hq % tp:
        raise ValueError("q heads must divide the model axis")
    shard_kv = Hk % tp == 0
    hq_local = Hq // tp
    group = Hq // Hk
    if not shard_kv and group % hq_local:
        raise ValueError(
            f"with replicated kv heads each rank's q heads must lie inside "
            f"one GQA group: group={group} must be a multiple of "
            f"Hq/tp={hq_local}")
    q_spec, kv_spec = attention_specs(mesh, shard_kv_heads=shard_kv)
    q, k, v = (local_shard(x, s, mesh)
               for x, s in ((q, q_spec), (k, kv_spec), (v, kv_spec)))
    if not shard_kv:
        kvh = (mesh.index(MODEL_AXIS) * hq_local) // group
        k, v = k[:, :, kvh:kvh + 1], v[:, :, kvh:kvh + 1]
    slopes = kwargs.pop("alibi_slopes", None)
    if slopes is not None:
        slopes = torch.as_tensor(slopes).to(device=q.device,
                                            dtype=torch.float32)
        spec = (MODEL_AXIS,) if slopes.dim() == 1 else (DATA_AXIS, MODEL_AXIS)
        slopes = local_shard(slopes, spec, mesh)
    return flash_attn_func(q, k, v, alibi_slopes=slopes, **kwargs)


def merge_lse_across(o_local: torch.Tensor, lse_local: torch.Tensor,
                     mesh: Mesh, axis: str):
    """Combine sequence-sharded partial attention over the ranks of this
    rank's `axis` line: an all-reduce MAX of the LSE, then the weights'
    and the weighted outputs' SUM (one all-reduce of both).

    o_local: (..., D) normalized fp32 partial; lse_local: (..., 1) fp32.
    A row no rank saw a key for gives O = 0 and LSE = -inf."""
    m = all_reduce(lse_local.clone(), mesh, axis, dist.ReduceOp.MAX)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.where(torch.isfinite(lse_local), torch.exp(lse_local - m_safe),
                    torch.zeros_like(lse_local))
    D = o_local.shape[-1]
    sums = all_reduce(torch.cat([o_local * w, w], dim=-1).contiguous(),
                      mesh, axis)
    o, wsum = sums[..., :D], sums[..., D:]
    empty = wsum == 0.0
    one = torch.ones_like(wsum)
    o = o / torch.where(empty, one, wsum)
    lse = torch.where(empty, torch.full_like(wsum, float("-inf")),
                      m_safe + torch.log(torch.where(empty, one, wsum)))
    return o, lse


def flash_attn_with_kvcache_sharded(
    q, k_cache, v_cache, mesh: Mesh, cache_seqlens, *,
    k=None, v=None, rotary_cos=None, rotary_sin=None, block_table=None,
    k_scales=None, v_scales=None, causal: bool = False,
    window_size=(-1, -1), softcap: float = 0.0, alibi_slopes=None,
    softmax_scale: Optional[float] = None, num_splits: int = 0,
    rotary_interleaved: bool = True, return_softmax_lse: bool = False,
):
    """KV-cache attention with the KV sequence sharded over "seq" and heads
    over "model": each rank attends to its cache shard through
    flash_attn_with_kvcache (K4 / K4q) and the partials combine through
    `merge_lse_across`.  Every rank passes its own shards, as `shard_map`
    hands them to the JAX package's body:

      q (B, T_new, Hq_local, D): this rank's heads, the same on every seq
        rank; k, v (B, T_new, Hk_local, D) the new tokens' heads;
      k_cache / v_cache in the HND layout: contiguous (B, Hk_local, N_shard,
        D), rank s of the seq axis holding global rows [s * N_shard,
        (s + 1) * N_shard); or paged pools (Hk_local, P_local, page_size, D)
        with `block_table` (B, max_pages / seq) this rank's columns
        [s * mp, (s + 1) * mp) of the global table, holding local page ids;
        int8/fp8/int4 pools with `k_scales` / `v_scales` likewise (an int4
        pool packs two tokens a row: sizes below count tokens);
      cache_seqlens (B,) the GLOBAL live lengths before the append;
      alibi_slopes (Hq_local,) or (B, Hq_local).

    Rotary runs once on the full (B, T_new) rows at global positions; each
    rank then appends only the new tokens that fall in its shard (in place,
    as flash_attn_with_kvcache does).  Returns like flash_attn_with_kvcache:
    out (B, T_new, Hq_local, D) merged over "seq", [lse (B, Hq_local,
    T_new)], [this rank's cache tuple]."""
    B, T_new, Hq, D = q.shape
    paged = block_table is not None
    appended = k is not None
    quantized = k_scales is not None
    if softmax_scale is None:
        softmax_scale = D ** -0.5
    dev = q.device
    lens = torch.as_tensor(cache_seqlens).to(device=dev, dtype=torch.int32)
    int4 = (quantized and k_cache.dtype == torch.int8
            and k_scales.shape[2] == 2 * k_cache.shape[2])
    tok_mul = 2 if int4 else 1
    if paged:
        N_shard = block_table.shape[1] * tok_mul * k_cache.shape[2]
    else:
        N_shard = tok_mul * k_cache.shape[2]

    if rotary_cos is not None:
        local_w = window_size[0] >= 0 or window_size[1] >= 0
        pos = lens[:, None] + torch.arange(T_new, dtype=torch.int32,
                                           device=dev)
        pos_q = pos if (causal or local_w) else lens[:, None].expand(
            B, T_new)
        q = apply_rotary_emb(q, rotary_cos, rotary_sin, pos_q,
                             interleaved=rotary_interleaved)
        if appended:
            k = apply_rotary_emb(k, rotary_cos, rotary_sin, pos,
                                 interleaved=rotary_interleaved)

    shard_start = mesh.index(SEQ_AXIS) * N_shard
    total = lens + T_new if appended else lens
    # this shard's live rows (the inner call adds T_new back when it
    # appends); q positions keep the global frame, shard-local origin
    cs_local = ((total - shard_start).clamp(0, N_shard)
                - (T_new if appended else 0))
    res = flash_attn_with_kvcache(
        q, k_cache, v_cache, k=k, v=v, cache_seqlens=cs_local,
        block_table=block_table, k_scales=k_scales, v_scales=v_scales,
        causal=causal, window_size=window_size, softcap=softcap,
        alibi_slopes=alibi_slopes, softmax_scale=softmax_scale,
        num_splits=num_splits, kv_cache_layout="HND",
        return_softmax_lse=True, q_position_lens=lens - shard_start,
        append_window=(0, N_shard) if appended else None)
    out, lse = res[0], res[1]
    lse_t = lse.permute(0, 2, 1)[..., None]               # (B, T, Hq, 1)
    o, lse_m = merge_lse_across(out.to(torch.float32), lse_t, mesh,
                                SEQ_AXIS)
    results = [o.to(q.dtype)]
    if return_softmax_lse:
        results.append(lse_m[..., 0].permute(0, 2, 1))
    if appended:
        results.append(res[2])
    return results[0] if len(results) == 1 else tuple(results)
