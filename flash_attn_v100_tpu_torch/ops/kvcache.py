"""Public KV-cache attention API — `flash_attn_with_kvcache`.

Surface of flash_attn_v100_tpu/ops/kvcache.py:
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
  * num_splits (0 = auto), return_softmax_lse;
  * the sequence-sharded form (parallel/sharded.py): `q_position_lens`
    (B,) puts the new tokens at q_position_lens + t for rotary, the masks
    and the append (cache_seqlens then only counts the live rows), and
    `append_window=(start, length)` appends only the tokens whose position
    lies in [start, start + length), at position - start;
  * quantized caches (ops/quant.py): int8 or fp8 (float8_e4m3fn) payloads
    with `k_scales` / `v_scales` in the caches' layout, head_dim collapsed
    to 1; an int8 cache whose token dimension is half its scales' is
    int4-packed (two tokens a byte).  Appended k/v are quantized after
    rotary, per (token, head); an int4 token merges into its nibble of the
    shared byte (the partner's nibble is kept).

The append updates the caches (and scales) IN PLACE (the reference CUDA
contract); the return value still has the JAX package's tuple shapes so
callers port one to one:
    out                               # no new kv, no lse
    (out, lse)                        # return_softmax_lse
    (out, (k_cache, v_cache))         # new kv appended
    (out, lse, (k_cache, v_cache))    # both
with (k_cache, v_cache, k_scales, v_scales) in the last slot for a
quantized cache, all the caller's own tensors.  Every layout reaches the
kernels as a strided view, without a copy, except a head dim the kernels
do not take (they take 32/64/128/256): on CUDA q and a copy of the pool
views are padded with zeros up to the next one (`pad_pool_head_dim`), as
flash_attn_varlen_func pads its block-table route.

Attention runs in one of two kernels: the split-KV decode kernel (K4, or
K4q for quantized caches, ops/cuda/decode.py) or, for paged prefills with
group * T_new >= VARLEN_PREFILL_MIN_ROWS and page_size % 128 == 0, the
paged varlen forward (K8 / K8q, ops/cuda/varlen.py).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda.decode import (
    paged_decode_attention_merged)
from flash_attn_v100_tpu_torch.ops.cuda.fwd import (
    KERNEL_HEAD_DIMS, kernel_head_dim)
from flash_attn_v100_tpu_torch.ops.cuda.varlen import (
    flash_attn_varlen_fwd_paged)
from flash_attn_v100_tpu_torch.ops.quant import (
    FP8, payload_bytes, quantize_int4_values, quantize_kv)
from flash_attn_v100_tpu_torch.ops.rotary import apply_rotary_emb

# Paged prefills with at least this many q rows (group * T_new) route to the
# paged varlen forward instead of the decode-shaped kernel.  Module-level so
# tests and benchmarks can pin either path.
VARLEN_PREFILL_MIN_ROWS = 1024


# an int4 payload byte whose two nibbles both hold 0 (low nibble biased by
# +8, high nibble two's complement: ops/quant.py)
INT4_ZERO_BYTE = 0x08


def pad_pool_head_dim(pool: torch.Tensor, Dk: int, int4: bool = False):
    """A K/V pool (any payload) with zeros appended to its last (head) axis
    up to Dk: a copy.  Zero q and K columns add nothing to a score and zero
    V columns give output columns that are cut off, so the kernels (head
    dims 32/64/128/256) serve a model of another head dim; per-token
    scales are unchanged."""
    D = pool.shape[-1]
    if D == Dk:
        return pool
    raw = payload_bytes(pool)
    pad = raw.new_full((*raw.shape[:-1], Dk - D),
                       INT4_ZERO_BYTE if int4 else 0)
    return torch.cat([raw, pad], dim=-1).view(pool.dtype)


def _pick_page_size(N: int) -> int:
    for ps in (512, 256, 128, 64, 32, 16, 8):
        if N % ps == 0:
            return ps
    return N


def _put(pool, idx, val, keep=None) -> None:
    """pool[idx] = val, in place.  With `keep` (bool, broadcastable to the
    index shape) only the marked entries are written, with no host sync:
    every other entry repeats the write of the first marked one, or where
    none is marked writes back what it reads, so duplicate targets agree
    (the JAX package's scatter mode "drop")."""
    val = payload_bytes(val.to(pool.dtype))
    pool = payload_bytes(pool)
    if keep is None:
        pool[idx] = val
        return
    *idx, keep = torch.broadcast_tensors(*idx, keep)
    trail = pool.shape[len(idx):]
    n = keep.numel()
    val = val.expand(*keep.shape, *trail).reshape(n, *trail)
    idx = tuple(i.reshape(n) for i in idx)
    keep = keep.reshape(n)
    val = torch.where(keep.view(n, *[1] * len(trail)), val, pool[idx])
    src = torch.where(keep, torch.arange(n, device=keep.device),
                      keep.to(torch.int32).argmax())
    pool[tuple(i[src] for i in idx)] = val[src]


# ---- int4 appends into token-packed pools (ops/quant.py layout) ----
# An int4 token is a nibble of a byte it shares with its partner token (2t
# low nibble, biased by +8; 2t + 1 high nibble).  Both helpers below work
# in place on fixed shapes, with no host sync: where two new tokens share a
# byte, both write the same final value, so the scatter's duplicate indices
# agree.  `idx` indexes the pool to (B, T, Hk, D) bytes, one per new token.

def _nibbles(vals: torch.Tensor):
    """int4 values -> (low-nibble byte bits, high-nibble byte bits), int32."""
    v = vals.to(torch.int32)
    return (v + 8) & 0xF, (v & 0xF) << 4


def _tokens(idx, sl: slice):
    """The index tuple restricted to the new tokens `sl` (dim 1)."""
    return tuple(i[:, sl] if i.shape[1] > 1 else i for i in idx)


def _int4_rmw(pool, idx, vals, parity, keep=None) -> None:
    """Read-modify-write: each new token merges its nibble into its byte,
    keeping the other nibble; even offsets in one round, odd in a second
    (JAX's _int4_rmw_paged).  A token whose partner writes in the round
    writes the partner's value, else its byte as read."""
    lo, hi = _nibbles(vals)
    even = (parity == 0)[..., None, None]
    T = vals.shape[1]
    if T == 1:
        old = pool[idx].to(torch.int32)
        _put(pool, idx, torch.where(even, (old & 0xF0) | lo,
                                    (old & 0x0F) | hi), keep)
        return
    t = torch.arange(T, device=pool.device)[None, :, None, None]
    old = pool[idx].to(torch.int32)
    lo_prev = torch.cat([lo[:, :1], lo[:, :-1]], dim=1)
    _put(pool, idx, torch.where(
        even, (old & 0xF0) | lo,
        torch.where(t >= 1, (old & 0xF0) | lo_prev, old)), keep)
    old = pool[idx].to(torch.int32)
    hi_next = torch.cat([hi[:, 1:], hi[:, -1:]], dim=1)
    _put(pool, idx, torch.where(
        ~even, (old & 0x0F) | hi,
        torch.where(t < T - 1, (old & 0x0F) | hi_next, old)), keep)


def _int4_append(pool, idx, vals, parity, keep=None) -> None:
    """Multi-token append that reads the pool only at the two possible
    boundary tokens (JAX's _int4_append_paged): each pair (t, t + 1) with t
    at an even offset is one whole new byte; a first token at an odd offset
    and a last token at an even offset share their byte with an old token
    and merge into it.  T == 1 is the read-modify-write."""
    T = vals.shape[1]
    if T < 2:
        _int4_rmw(pool, idx, vals, parity, keep)
        return
    lo, hi = _nibbles(vals)
    even = (parity == 0)[..., None, None]
    pair = lo[:, :-1] | hi[:, 1:]                       # byte of (t, t + 1)
    old_first = pool[_tokens(idx, slice(0, 1))].to(torch.int32)
    old_last = pool[_tokens(idx, slice(T - 1, T))].to(torch.int32)
    as_even = torch.cat([pair, (old_last & 0xF0) | lo[:, -1:]], dim=1)
    as_odd = torch.cat([(old_first & 0x0F) | hi[:, :1], pair], dim=1)
    _put(pool, idx, torch.where(even, as_even, as_odd), keep)


def _paged_index(pool, page_ids, off):
    h = torch.arange(pool.shape[0], device=pool.device)[None, None, :]
    return h, page_ids[..., None].long(), (off // 2)[..., None].long()


def _contig_index(pool, b_ix, rows):
    h = torch.arange(pool.shape[1], device=pool.device)[None, None, :]
    return b_ix.long()[:, None, None], h, (rows // 2)[..., None].long()


def _int4_rmw_paged(pool, vals, page_ids, off, keep=None) -> None:
    """int4 values (B, T, Hk, D) into the packed paged pool (Hk, P,
    page_size / 2, D) at page page_ids[b, t], token offset off[b, t]; with
    `keep` (B, T, 1) only the tokens it marks."""
    _int4_rmw(pool, _paged_index(pool, page_ids, off), vals, off % 2, keep)


def _int4_append_paged(pool, vals, page_ids, off, keep=None) -> None:
    _int4_append(pool, _paged_index(pool, page_ids, off), vals, off % 2,
                 keep)


def _int4_rmw_contig(pool, vals, b_ix, rows, keep=None) -> None:
    """Contiguous analog: pool (Bc, Hk, N / 2, D), vals (B, Hk, T, D),
    rows (B, T) absolute token indices, b_ix (B,) cache rows."""
    _int4_rmw(pool, _contig_index(pool, b_ix, rows), vals.transpose(1, 2),
              rows % 2, keep)


def _int4_append_contig(pool, vals, b_ix, rows, keep=None) -> None:
    _int4_append(pool, _contig_index(pool, b_ix, rows), vals.transpose(1, 2),
                 rows % 2, keep)


def uses_varlen_route(paged: bool, group: int, t_new: int, page_size: int,
                      q_position_lens=None, append_window=None) -> bool:
    """Whether a call of this shape runs K8 (else K4); the sequence-sharded
    form (either kwarg given) always runs K4."""
    return (paged and group * t_new >= VARLEN_PREFILL_MIN_ROWS
            and page_size % 128 == 0 and q_position_lens is None
            and append_window is None)


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
    B, T_new, Hq, D_og = q.shape
    dev = q.device
    paged = block_table is not None
    if paged and cache_batch_idx is not None:
        raise ValueError("cache_batch_idx is not supported with paged KV cache")
    if paged and cache_leftpad is not None:
        raise ValueError("cache_leftpad is not supported with paged KV cache")
    if (k is None) != (v is None):
        raise ValueError("k and v must be given together")
    quantized = k_scales is not None
    if quantized != (v_scales is not None):
        raise ValueError("k_scales and v_scales must be given together")
    if quantized and (k_cache.dtype not in (torch.int8, FP8)
                      or v_cache.dtype != k_cache.dtype):
        raise ValueError("scales given but the cache dtype is not int8/fp8")
    if not quantized and (k_cache.dtype != q.dtype
                          or v_cache.dtype != q.dtype):
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
    ksc = vsc = None
    if quantized:
        if kv_cache_layout == "HND":
            ksc, vsc = k_scales, v_scales
        elif paged:
            ksc, vsc = (x.permute(2, 0, 1, 3) for x in (k_scales, v_scales))
        else:
            ksc, vsc = k_scales.transpose(1, 2), v_scales.transpose(1, 2)
    # an int8 cache with half its scales' token rows is int4-packed
    int4 = (quantized and kc.dtype == torch.int8
            and ksc.shape[-2] == 2 * kc.shape[-2])

    if paged:
        Hk, P, kv_rows, D = kc.shape
        page_size = 2 * kv_rows if int4 else kv_rows
        N_capacity = block_table.shape[1] * page_size
    else:
        Bc, Hk, kv_rows, D = kc.shape
        N = 2 * kv_rows if int4 else kv_rows
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
    # the new tokens' positions start at qlens: the live length, or in the
    # sequence-sharded form the global one, shard-local origin
    qlens = cache_seqlens if q_position_lens is None else torch.as_tensor(
        q_position_lens).to(device=dev, dtype=torch.int32)
    leftpad = (None if cache_leftpad is None
               else torch.as_tensor(cache_leftpad).to(device=dev,
                                                      dtype=torch.int32))
    appended = k is not None
    # positions of the new tokens (B, T): rotary and the append share them
    if appended or rotary_cos is not None:
        pos = qlens[:, None] + torch.arange(T_new, dtype=torch.int32,
                                            device=dev)

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
    keep = None
    if appended:
        if append_window is not None:
            # the window's tokens only, at shard-local positions; the others
            # are dropped (their writes repeat a kept one, see _put)
            start, length = append_window
            pos = pos - start
            keep = ((pos >= 0) & (pos < length))[..., None]      # (B, T, 1)
        if quantized:
            # quantized after rotary, per (token, head); int4 stays
            # unpacked here and merges into its nibble below
            quant = quantize_int4_values if int4 else (
                lambda x: quantize_kv(x, kc.dtype))
            (k, k_s), (v, v_s) = quant(k), quant(v)
        if paged:
            col = (pos // page_size).clamp(0, block_table.shape[1] - 1)
            page_ids = torch.gather(block_table.to(dev), 1, col.long())
            off = pos % page_size
            idx = (torch.arange(Hk, device=dev)[None, None, :],
                   page_ids[..., None], off[..., None])
            if int4:
                _int4_append_paged(kc, k, page_ids, off, keep)
                _int4_append_paged(vc, v, page_ids, off, keep)
            else:
                _put(kc, idx, k, keep)
                _put(vc, idx, v, keep)
            if quantized:
                _put(ksc, idx, k_s, keep)
                _put(vsc, idx, v_s, keep)
        else:
            rows = pos if leftpad is None else pos + leftpad[:, None]
            if keep is not None:
                # dropped tokens still need rows that index the cache
                rows = rows.clamp(0, N - 1)
            b_ix = (torch.arange(B, device=dev) if cache_batch_idx is None
                    else torch.as_tensor(cache_batch_idx).to(dev))
            idx = (b_ix[:, None, None],
                   torch.arange(Hk, device=dev)[None, :, None],
                   rows[:, None, :])
            if int4:
                _int4_append_contig(kc, k.transpose(1, 2), b_ix, rows, keep)
                _int4_append_contig(vc, v.transpose(1, 2), b_ix, rows, keep)
            keep_t = None if keep is None else keep.transpose(1, 2)
            if not int4:
                _put(kc, idx, k.transpose(1, 2), keep_t)
                _put(vc, idx, v.transpose(1, 2), keep_t)
            if quantized:
                _put(ksc, idx, k_s.transpose(1, 2), keep_t)
                _put(vsc, idx, v_s.transpose(1, 2), keep_t)

    lens_total = cache_seqlens + T_new if appended else cache_seqlens

    # ---- page pool view + table ----
    pool_ks = pool_vs = None
    if paged:
        pool_k, pool_v = kc[None], vc[None]            # (1, Hk, P, ps, D)
        if quantized:
            pool_ks, pool_vs = ksc[None], vsc[None]
        tbl = block_table.to(device=dev, dtype=torch.int32)
    else:
        nb = N // page_size
        rows_pp = page_size // 2 if int4 else page_size   # payload rows a page
        pool_k = kc.reshape(Bc, Hk, nb, rows_pp, D)
        pool_v = vc.reshape(Bc, Hk, nb, rows_pp, D)
        if quantized:
            pool_ks = ksc.reshape(Bc, Hk, nb, page_size, 1)
            pool_vs = vsc.reshape(Bc, Hk, nb, page_size, 1)
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
    if dev.type == "cuda" and D not in KERNEL_HEAD_DIMS:
        # the kernels' head dims: q and the pool views padded with zeros
        D = kernel_head_dim(D)
        q = torch.nn.functional.pad(q, (0, D - D_og))
        pool_k, pool_v = (pad_pool_head_dim(x, D, int4)
                          for x in (pool_k, pool_v))
    if uses_varlen_route(paged, group, T_new, page_size, q_position_lens,
                         append_window):
        # uniform cu_q = b * T_new and seqlens_k = lens_total reproduce the
        # decode alignment (first new token at lens_total - T_new)
        qp = q.reshape(B * T_new, Hq, D)
        cu_q = torch.arange(B + 1, dtype=torch.int32, device=dev) * T_new
        out, lse_v = flash_attn_varlen_fwd_paged(
            qp, pool_k[0], pool_v[0], tbl, cu_q, lens_total, T_new,
            int(tbl.shape[1]) * page_size, float(softmax_scale), params,
            alibi_slopes=slopes,
            k_scales=None if pool_ks is None else pool_ks[0],
            v_scales=None if pool_vs is None else pool_vs[0])
        out = out.reshape(B, T_new, Hq, D)[..., :D_og].to(dtype_og)
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
        # first new token's position: qlens when appending, else
        # qlens - T_new (None: the kernel's default lens_total - T_new, the
        # same without q_position_lens); one launch, the splits merged in
        # it, o in q's dtype
        qpos = qlens if appended else (
            None if q_position_lens is None else qlens - T_new)
        o, lse = paged_decode_attention_merged(
            q_rows, pool_k, pool_v, tbl, lens_total, leftpad,
            qpos_vec=qpos,
            softmax_scale=float(softmax_scale), params=params, t_new=T_new,
            group=group, num_splits=num_splits,
            alibi_slopes_rows=slopes_rows, k_scales=pool_ks,
            v_scales=pool_vs, int4=int4)
        o = o[:, :, :n_rows, :D_og].reshape(B, Hk, group, T_new, D_og)
        out = o.permute(0, 3, 1, 2, 4).reshape(B, T_new, Hq, D_og)
        if return_softmax_lse:
            lse = lse[:, :, :n_rows, 0].reshape(B, Hq, T_new)

    results = [out]
    if return_softmax_lse:
        results.append(lse)
    if appended:
        results.append((k_cache, v_cache, k_scales, v_scales) if quantized
                       else (k_cache, v_cache))
    return results[0] if len(results) == 1 else tuple(results)
