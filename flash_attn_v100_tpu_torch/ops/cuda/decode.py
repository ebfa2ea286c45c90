"""K4: split-KV paged decode attention (`csrc/decode.cu`) and its plain twin.

`paged_decode_attention` has the signature and return shapes of
flash_attn_v100_tpu/ops/pallas/decode.py::paged_decode_attention: GQA-folded
q rows (B, Hk, Rq, D), a page pool view (C1, Hk, C2, ps, D) in which page id
p lives at [p // C2, :, p % C2] (any strides with a contiguous last axis),
a block table (B, max_pages) int32; it returns fp32 normalized partials
o_part (B, Hk, S, Rq, D) and lse_part (B, Hk, S, Rq, 1), one per KV split,
combined by `merge_partials`.  `paged_decode_attention_merged` takes the
same arguments and returns what `merge_partials` of those partials gives,
o (B, Hk, Rq, D) in q's dtype and lse (B, Hk, Rq, 1), from one launch: the
kernel's last block of each (batch row, kv head, q-row tile) merges its
splits (the route of `flash_attn_with_kvcache`).

With `k_scales` / `v_scales` ((C1, Hk, C2, page_size, 1) fp32) the pools
are quantized (ops/quant.py): int8, fp8 (e4m3), or with `int4=True`
int4-packed int8 whose pool view holds page_size / 2 rows.  That is K4q
(`csrc/decode_quant.cu`), the TPU kernel's quantized branches: q rows and P
quantized to int8 on the fly for int8/int4 pools, P rounded to bf16 for
fp8 (see the kernel's note).  P's int8 scale is taken per group of `p_tile`
consecutive cache rows counted from each split's first row: P_TILE (the
kernel's 32-key group) in the kernel and on the CPU path; the TPU kernel's
grouping is one page (`p_tile=None` in the plain version).

For CUDA tensors it launches the kernel (q in bf16, fp16 or fp32: fp32
over 32-bit pools on the body's fp32 instantiation `csrc/decode_f32.cu`,
3 x TF32 split products on the tensor cores, over quantized pools on
K4q's fp32 instantiations; the merged o is in q's dtype; anything else
raises); for CPU tensors it computes `paged_decode_attention_ref`, the
plain PyTorch version of the same function.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from flash_attn_v100_tpu_torch.config import EXP_CLAMP
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import build
from flash_attn_v100_tpu_torch.ops.quant import (
    INT8_MAX, ieee_div, payload_bytes, quant_kind, unpack_int4_tokens)

ROW_TILE = 8         # q rows come padded to a multiple of this (Rq)
KEY_SPLIT_ROWS = 16  # up to this Rq a block's warps split the keys
KEY_WARPS = 4        # warps a block: the key streams at Rq <= KEY_SPLIT_ROWS
SM_COUNT_H100 = 132  # the split rule's target when no device is at hand
BLOCKS_PER_SM = 2    # auto splits fill one wave of this many blocks an SM
P_TILE = 32          # K4q's key group: P's int8 group (kGroup)

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
KIND_CODE = {"int8": 0, "fp8": 1, "int4": 2}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_rows(Rq: int) -> int:
    """q rows a kernel block takes: 16 (an m16 tile whose warps split the
    keys) up to Rq 16, else 64 (16 rows a warp)."""
    return KEY_SPLIT_ROWS if Rq <= KEY_SPLIT_ROWS else 64


@functools.lru_cache(maxsize=None)
def _cuda_sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device: torch.device) -> int:
    if device.type == "cuda":
        return _cuda_sm_count(device.index if device.index is not None
                              else torch.cuda.current_device())
    return SM_COUNT_H100


def resolve_num_splits(num_splits: int, B: int, Hk: int, Rq: int,
                       max_pages: int, device: torch.device) -> int:
    """num_splits <= 0 means auto: as many KV splits as B * Hk * S blocks
    (times the q-row tiles) fit in one wave of BLOCKS_PER_SM blocks on
    every SM (the kernel's residency at D 64 / 128), at least one: every
    SM streams its share of the keys, and no second wave waits on the
    first.  Never more splits than table slots."""
    S = num_splits
    if S <= 0:
        blocks = B * Hk * _cdiv(Rq, block_rows(Rq))
        S = BLOCKS_PER_SM * _sm_count(device) // max(blocks, 1)
    return max(1, min(S, max_pages))


def _key_streams(Rq: int, p_tile: Optional[int]) -> int:
    """How many running maxima P's rounding is taken against: the kernel's
    warps at Rq <= KEY_SPLIT_ROWS each keep their own over the groups
    g % KEY_WARPS == w of a split; one where P is grouped per page (the
    TPU kernel's order, p_tile None)."""
    return KEY_WARPS if p_tile is not None and Rq <= KEY_SPLIT_ROWS else 1


def _i32(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if x is None or (x.dtype == torch.int32 and x.is_contiguous()):
        return x
    return x.to(torch.int32).contiguous()


# per device: the merge's arrival counters, one per (batch row, kv head, q
# row tile), zero between launches (the last block of each resets its
# own), so calls and CUDA-graph replays reuse one buffer; launches on one
# stream (the engine's) may share it, launches on concurrent streams may
# not
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    c = _COUNTERS.get(dev)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = c
    return c


def _launch(q_rows, k_pages, v_pages, block_table, cache_seqlens, leftpad,
            qpos_vec, softmax_scale, params, t_new, group, num_splits,
            alibi_slopes_rows, k_scales, v_scales, int4, merged):
    """K4 or K4q on CUDA tensors: the partials (o_part, lse_part), or with
    `merged` the merged (o in q's dtype, lse).  A None `qpos_vec` is
    cache_seqlens - t_new, computed in the kernel."""
    if q_rows.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode kernel takes bf16/fp16/fp32 q, got "
                        f"{q_rows.dtype}")
    if k_scales is None:
        kind = None
        if k_pages.dtype != q_rows.dtype or v_pages.dtype != q_rows.dtype:
            raise TypeError("q rows and the page pools must share one dtype")
    else:
        kind = _check_quant(k_pages, v_pages, k_scales, v_scales, int4)
    B, Hk, Rq, D = q_rows.shape
    C1, Hk2, C2, rows, Dk = k_pages.shape
    ps = rows if kind is None else k_scales.shape[-2]
    dev = q_rows.device
    if Hk2 != Hk or Dk != D or v_pages.shape != k_pages.shape or (
            kind is not None and k_scales.shape != (C1, Hk, C2, ps, 1)):
        raise ValueError(f"pool view {tuple(k_pages.shape)} does not match "
                         f"q rows {tuple(q_rows.shape)} (or its scales)")
    if D not in (32, 64, 128, 256) or Rq % ROW_TILE:
        raise ValueError(f"decode kernel takes head_dim 32/64/128/256 and Rq "
                         f"a multiple of {ROW_TILE}, got {D}, {Rq}")
    esz = k_pages.element_size()
    if k_pages.stride() != v_pages.stride() or k_pages.stride(-1) != 1 or \
            any(s * esz % 16 for s in k_pages.stride()[:-1]) or \
            (k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError("k/v pool views need equal strides, a contiguous "
                         "last axis, 16-byte strides and 16-byte alignment")
    if any(t is not None and t.device != dev
           for t in (k_pages, v_pages, k_scales, v_scales, block_table,
                     cache_seqlens, leftpad, qpos_vec)):
        raise ValueError("all decode inputs must be on one device")
    max_pages = block_table.shape[1]
    S = resolve_num_splits(num_splits, B, Hk, Rq, max_pages, dev)
    q_rows = q_rows.contiguous()
    tbl, lens, lp, qpos = (_i32(x) for x in (block_table, cache_seqlens,
                                             leftpad, qpos_vec))
    slopes = None
    if params.has_alibi:
        slopes = alibi_slopes_rows.to(torch.float32).reshape(
            B, Hk, Rq).contiguous()
    o_part = lse_part = o = lse = counters = None
    if not merged or S > 1:
        o_part = torch.empty((B, Hk, S, Rq, D), dtype=torch.float32,
                             device=dev)
        lse_part = torch.empty((B, Hk, S, Rq, 1), dtype=torch.float32,
                               device=dev)
    if merged:
        o = torch.empty((B, Hk, Rq, D), dtype=q_rows.dtype, device=dev)
        lse = torch.empty((B, Hk, Rq, 1), dtype=torch.float32, device=dev)
        counters = _counters(dev, B * Hk * _cdiv(Rq, block_rows(Rq)))

    def ptr(t):
        return None if t is None else t.data_ptr()
    ptrs = (q_rows.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    tail = tuple(ptr(t) for t in (tbl, lens, lp, qpos, slopes, o_part,
                                  lse_part, o, lse, counters))
    dims = (C2, B, Hk, Rq, D, S, max_pages, ps, _cdiv(max_pages, S), t_new,
            group, float(softmax_scale), int(params.causal),
            int(params.window_left), int(params.window_right),
            float(params.softcap), int(params.has_alibi),
            torch.cuda.current_stream(dev).cuda_stream)
    code = _DTYPE_CODE[q_rows.dtype]
    if kind is None:
        launch = (build.load("decode_f32").fa_decode_f32_launch
                  if q_rows.dtype == torch.float32
                  else build.load("decode").fa_decode_launch)
        rc = launch(code, *ptrs, *tail, *k_pages.stride()[:4], *dims)
        build.check(rc, "paged_decode_attention")
        paged_decode_attention.launches += 1
    else:
        rc = build.load("decode_quant").fa_decode_quant_launch(
            KIND_CODE[kind], code, *ptrs, k_scales.data_ptr(),
            v_scales.data_ptr(), *tail, *k_pages.stride()[:4],
            *k_scales.stride()[:4], *dims)
        build.check(rc, "paged_decode_attention (quantized)")
        paged_decode_attention.quant_launches[kind] += 1
    return (o, lse) if merged else (o_part, lse_part)


def paged_decode_attention(
    q_rows: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    cache_seqlens: torch.Tensor,
    leftpad: Optional[torch.Tensor],
    *,
    qpos_vec: Optional[torch.Tensor] = None,
    softmax_scale: float,
    params: masklib.MaskParams,
    t_new: int,
    group: int,
    num_splits: int = 0,
    alibi_slopes_rows: Optional[torch.Tensor] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    int4: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-KV paged attention core; see the module docstring.
    `qpos_vec` (B,) is the position of the first new token in the live
    frame (default cache_seqlens - t_new); `leftpad` (B,) or None for
    none; `alibi_slopes_rows` is (B, Hk, Rq[, 1]) fp32 per folded row;
    `k_scales` / `v_scales` mark quantized pools (K4q)."""
    if q_rows.device.type == "cpu":
        return paged_decode_attention_ref(
            q_rows, k_pages, v_pages, block_table, cache_seqlens, leftpad,
            qpos_vec=qpos_vec, softmax_scale=softmax_scale, params=params,
            t_new=t_new, group=group, num_splits=num_splits,
            alibi_slopes_rows=alibi_slopes_rows, k_scales=k_scales,
            v_scales=v_scales, int4=int4, p_tile=P_TILE)
    return _launch(q_rows, k_pages, v_pages, block_table, cache_seqlens,
                   leftpad, qpos_vec, softmax_scale, params, t_new, group,
                   num_splits, alibi_slopes_rows, k_scales, v_scales, int4,
                   merged=False)


# the kernel's launches (either entry), K4 and K4q per payload kind
paged_decode_attention.launches = 0
paged_decode_attention.quant_launches = {k: 0 for k in KIND_CODE}


def paged_decode_attention_merged(
    q_rows: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    cache_seqlens: torch.Tensor,
    leftpad: Optional[torch.Tensor],
    *,
    qpos_vec: Optional[torch.Tensor] = None,
    softmax_scale: float,
    params: masklib.MaskParams,
    t_new: int,
    group: int,
    num_splits: int = 0,
    alibi_slopes_rows: Optional[torch.Tensor] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    int4: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`paged_decode_attention` (same arguments) with its splits merged in
    the same launch: o (B, Hk, Rq, D) in q's dtype and lse (B, Hk, Rq, 1)
    fp32, as `merge_partials` of the partials gives them.  On CPU tensors,
    merge_partials of the plain version at the kernel's P grouping."""
    if q_rows.device.type == "cpu":
        o, lse = merge_partials(*paged_decode_attention(
            q_rows, k_pages, v_pages, block_table, cache_seqlens, leftpad,
            qpos_vec=qpos_vec, softmax_scale=softmax_scale, params=params,
            t_new=t_new, group=group, num_splits=num_splits,
            alibi_slopes_rows=alibi_slopes_rows, k_scales=k_scales,
            v_scales=v_scales, int4=int4))
        return o.to(q_rows.dtype), lse
    return _launch(q_rows, k_pages, v_pages, block_table, cache_seqlens,
                   leftpad, qpos_vec, softmax_scale, params, t_new, group,
                   num_splits, alibi_slopes_rows, k_scales, v_scales, int4,
                   merged=True)


def _quant_kind(k_pages, k_scales, int4: bool) -> str:
    kind = "int4" if int4 else quant_kind(k_pages.dtype)
    rows, ps = k_pages.shape[-2], k_scales.shape[-2]
    if kind == "int4" and (k_pages.dtype != torch.int8 or ps != 2 * rows):
        raise ValueError("int4 pools are int8 bytes with page_size / 2 rows "
                         f"(pool rows {rows}, scale rows {ps})")
    if kind != "int4" and ps != rows:
        raise ValueError(f"scales hold {ps} rows a page, the pool {rows}")
    return kind


def _check_quant(k_pages, v_pages, k_scales, v_scales, int4: bool) -> str:
    """The payload kind of quantized pools given to the kernel, checked."""
    if v_scales is None or v_pages.dtype != k_pages.dtype:
        raise TypeError("k/v pools must share one quantized dtype and both "
                        "scales be given")
    kind = _quant_kind(k_pages, k_scales, int4)
    if (k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32
            or k_scales.shape != v_scales.shape
            or k_scales.stride() != v_scales.stride()):
        raise ValueError("k/v scales must be fp32 views of one shape and "
                         "equal strides")
    return kind


def _pad_dim(x: torch.Tensor, dim: int, n: int,
             value: float = 0.0) -> torch.Tensor:
    """x with `value` appended along `dim` up to length n."""
    extra = n - x.shape[dim]
    if extra <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_full(shape, value)], dim=dim)


def _quantize_rows(x: torch.Tensor):
    """Per-row int8 quantization over the last axis, as the kernels quantize
    q and P: (values as float, scale) with scale = amax / 127 (1 where the
    row is all zero) and values round(x / scale), half to even."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax),
                        ieee_div(amax, INT8_MAX))
    return torch.round(x / scale), scale


def _int_matmul(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """einsum of integer-valued tensors, exact: float64 holds every int32
    sum of int8 products (torch has no integer matmul on CUDA)."""
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(
        torch.float32)


def quant_payload_values(pages: torch.Tensor, kind: str) -> torch.Tensor:
    """Payload rows (..., rows, D) -> their quantized values (..., ps, D):
    int8 values (int8, int4 unpacked in token order) or e4m3 values as
    fp32, exactly."""
    if kind == "int4":
        return unpack_int4_tokens(pages, axis=-2)
    if kind == "fp8":
        return pages.to(torch.float32)
    return pages


def _gather_pages(pool: torch.Tensor, tbl: torch.Tensor, C2: int):
    """(C1, Hk, C2, rows, W) pool, (B, max_pages) ids -> (B, Hk, max_pages,
    rows, W), through the payload's bytes (fp8 is not indexable
    everywhere)."""
    g = payload_bytes(pool)[tbl // C2, :, tbl % C2]
    return g.view(pool.dtype).permute(0, 2, 1, 3, 4)


def _decode_quant_ref(q_rows, k_pages, v_pages, k_scales, v_scales, int4,
                      block_table, cache_seqlens, leftpad, qpos_vec,
                      softmax_scale, params, t_new, group, num_splits,
                      alibi_slopes_rows, p_tile, round_p):
    """The K4q arithmetic (module docstring), split by split, with P's
    int8 scale per group of p_tile rows from each split's first row and
    the online softmax's running max taken per group, as the kernel takes
    it: where its warps split the keys (Rq <= KEY_SPLIT_ROWS), group g is
    warp g % KEY_WARPS's and P is taken relative to the running max of
    that warp's groups so far (`_key_streams`)."""
    B, Hk, Rq, D = q_rows.shape
    kind = _quant_kind(k_pages, k_scales, int4)
    C2, ps = k_pages.shape[2], k_scales.shape[-2]
    dev = q_rows.device
    max_pages = block_table.shape[1]
    S = resolve_num_splits(num_splits, B, Hk, Rq, max_pages, dev)
    nb = _cdiv(max_pages, S)
    span = nb * ps
    G = p_tile or ps
    ng = _cdiv(span, G)
    tbl = block_table.to(device=dev, dtype=torch.long)

    def split_cols(x):
        # (B, Hk, max_pages * ps, ...) -> (B, Hk, S, ng * G, ...): each
        # split padded with zeros to whole groups
        x = _pad_dim(x, 2, S * span)
        x = x.reshape(B, Hk, S, span, *x.shape[3:])
        return _pad_dim(x, 3, ng * G)

    def payload(pool):
        vals = quant_payload_values(_gather_pages(pool, tbl, C2), kind)
        return split_cols(vals.reshape(B, Hk, max_pages * ps, D))

    def scales(pool):
        g = _gather_pages(pool, tbl, C2).reshape(B, Hk, max_pages * ps)
        return split_cols(g)[:, :, None]                  # (B, Hk, 1, S, n)

    k, v = payload(k_pages), payload(v_pages)             # (B, Hk, S, n, D)
    ks, vs = scales(k_scales), scales(v_scales)
    q32 = q_rows.to(torch.float32)
    if kind == "fp8":
        s = torch.einsum("bhrd,bhsnd->bhrsn", q32, k) * ks
    else:
        q8, q_scale = _quantize_rows(q32)
        s = _int_matmul(q8, k, "bhrd,bhsnd->bhrsn") * q_scale[..., None] * ks

    # positions: column i of split s is cache row s * span + i
    i = torch.arange(ng * G, device=dev)
    j = (torch.arange(S, device=dev)[:, None] * span + i).view(1, 1, 1, S, -1)
    lens = cache_seqlens.to(device=dev, dtype=torch.long).view(B, 1, 1, 1, 1)
    lp = (0 if leftpad is None
          else leftpad.to(device=dev, dtype=torch.long).view(B, 1, 1, 1, 1))
    jl = j - lp
    r = torch.arange(Rq, device=dev).view(1, 1, Rq, 1, 1)
    qpos = qpos_vec.to(device=dev, dtype=torch.long).view(B, 1, 1, 1, 1) + (
        r % t_new if t_new > 1 else 0)
    valid = ((i < span) & (jl >= 0) & (jl < lens) & (r < group * t_new)
             & masklib.position_mask(qpos, jl, offset=0, params=params))
    slope = None
    if params.has_alibi:
        slope = alibi_slopes_rows.to(device=dev, dtype=torch.float32).reshape(
            B, Hk, Rq, 1, 1)
    s = masklib.apply_score_pipeline(s, qpos, jl, softmax_scale=softmax_scale,
                                     offset=0, params=params, valid=valid,
                                     alibi_slope=slope)

    # online softmax over the groups of each split: m runs per group, over
    # each key stream's groups (g % W) where the kernel's warps split them
    shape = (B, Hk, Rq, S, ng, G)
    s, valid = s.reshape(shape), valid.expand(B, Hk, Rq, S, ng * G).reshape(shape)
    W = _key_streams(Rq, p_tile)
    gmax = _pad_dim(s.amax(dim=-1), 4, _cdiv(ng, W) * W, float("-inf"))
    m_run = torch.cummax(gmax.unflatten(4, (-1, W)), dim=4).values.flatten(
        4)[..., :ng]                                      # (B, Hk, Rq, S, ng)
    p = torch.exp(torch.clamp(s - m_run[..., None], min=EXP_CLAMP))
    p = torch.where(valid, p, torch.zeros_like(p))
    m = m_run.amax(dim=-1, keepdim=True)
    w = torch.exp(m_run - m)                              # rescale to the end
    l = (p.sum(dim=-1) * w).sum(dim=-1)                   # (B, Hk, Rq, S)
    pv = p * vs.reshape(B, Hk, 1, S, ng, G)
    v = v.reshape(B, Hk, S, ng, G, D)
    if kind == "fp8":
        if round_p:
            pv = pv.to(torch.bfloat16).to(torch.float32)
        o = torch.einsum("bhrsgn,bhsgnd->bhrsgd", pv, v)
    elif round_p:
        p8, p_scale = _quantize_rows(pv)
        o = _int_matmul(p8, v, "bhrsgn,bhsgnd->bhrsgd") * p_scale
    else:
        o = _int_matmul(pv, v, "bhrsgn,bhsgnd->bhrsgd")
    o = (o * w[..., None]).sum(dim=-2)                    # (B, Hk, Rq, S, D)
    l_t = l.permute(0, 1, 3, 2)[..., None]                # (B, Hk, S, Rq, 1)
    o = o.permute(0, 1, 3, 2, 4) * torch.where(
        l_t == 0, torch.zeros_like(l_t), 1.0 / l_t)
    m_t = m[..., 0].permute(0, 1, 3, 2)[..., None]
    lse = torch.where(l_t == 0, torch.full_like(l_t, float("-inf")),
                      m_t + torch.log(torch.where(l_t == 0,
                                                  torch.ones_like(l_t), l_t)))
    return o, lse


@build.counted
def paged_decode_attention_ref(
    q_rows, k_pages, v_pages, block_table, cache_seqlens, leftpad, *,
    qpos_vec: Optional[torch.Tensor] = None, softmax_scale: float,
    params: masklib.MaskParams, t_new: int, group: int, num_splits: int = 0,
    alibi_slopes_rows: Optional[torch.Tensor] = None, upcast: bool = True,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None, int4: bool = False,
    p_tile: Optional[int] = P_TILE, round_p: bool = True,
    einsum=torch.einsum,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same inputs, same partials.
    `upcast=False` keeps both products in the input dtype (the
    same-bit-width yardstick of the tolerance model).  With `k_scales` the
    quantized arithmetic of K4q, P's int8 scale per `p_tile` rows (None:
    per page, the TPU kernel's grouping); `round_p=False` skips P's int8
    (fp8: bf16) rounding, the yardstick for the kernel's rounding of P.
    `upcast` does not apply to quantized pools.  `einsum` computes S and
    P V over 16- and 32-bit pools (ops/cuda/tf32.py passes its split
    products: the fp32 kernel's model)."""
    if qpos_vec is None:
        qpos_vec = cache_seqlens.to(torch.int32) - t_new
    if k_scales is not None:
        return _decode_quant_ref(
            q_rows, k_pages, v_pages, k_scales, v_scales, int4, block_table,
            cache_seqlens, leftpad, qpos_vec, softmax_scale, params, t_new,
            group, num_splits, alibi_slopes_rows, p_tile, round_p)
    B, Hk, Rq, D = q_rows.shape
    _, _, C2, ps, _ = k_pages.shape
    dev = q_rows.device
    max_pages = block_table.shape[1]
    S = resolve_num_splits(num_splits, B, Hk, Rq, max_pages, dev)
    nb = _cdiv(max_pages, S)
    span = nb * ps
    cd = torch.float32 if upcast else q_rows.dtype

    tbl = block_table.to(torch.long)
    # (B, max_pages, Hk, ps, D) -> (B, Hk, max_pages * ps, D)
    def gather(pool):
        g = pool[tbl // C2, :, tbl % C2]
        g = g.permute(0, 2, 1, 3, 4).reshape(B, Hk, max_pages * ps, D)
        pad = S * span - max_pages * ps
        if pad:
            g = torch.cat([g, g.new_zeros(B, Hk, pad, D)], dim=2)
        return g.to(cd)
    k, v = gather(k_pages), gather(v_pages)

    s = einsum("bhrd,bhnd->bhrn", q_rows.to(cd), k).to(torch.float32)
    lens = cache_seqlens.to(device=dev, dtype=torch.long).view(B, 1, 1, 1)
    lp = (0 if leftpad is None
          else leftpad.to(device=dev, dtype=torch.long).view(B, 1, 1, 1))
    jl = torch.arange(S * span, device=dev).view(1, 1, 1, -1) - lp
    r = torch.arange(Rq, device=dev).view(1, 1, Rq, 1)
    qpos = qpos_vec.to(device=dev, dtype=torch.long).view(B, 1, 1, 1) + (
        r % t_new if t_new > 1 else 0)
    valid = ((jl >= 0) & (jl < lens) & (r < group * t_new)
             & masklib.position_mask(qpos, jl, offset=0, params=params))
    slope = None
    if params.has_alibi:
        slope = alibi_slopes_rows.to(device=dev, dtype=torch.float32).reshape(
            B, Hk, Rq, 1)
    s = masklib.apply_score_pipeline(s, qpos, jl, softmax_scale=softmax_scale,
                                     offset=0, params=params, valid=valid,
                                     alibi_slope=slope)

    # per split: m, l, normalized O, LSE
    s = s.view(B, Hk, Rq, S, span)
    valid = valid.expand(B, Hk, Rq, S * span).reshape(B, Hk, Rq, S, span)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(torch.clamp(s - m, min=EXP_CLAMP))
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(dim=-1)                                      # (B, Hk, Rq, S)
    vs = v.view(B, Hk, S, span, D)
    o = einsum("bhrsn,bhsnd->bhsrd", p.to(cd), vs).to(torch.float32)
    l_t = l.permute(0, 1, 3, 2)[..., None]                 # (B, Hk, S, Rq, 1)
    o = o * torch.where(l_t == 0, torch.zeros_like(l_t), 1.0 / l_t)
    m_t = m[..., 0].permute(0, 1, 3, 2)[..., None]
    lse = torch.where(l_t == 0, torch.full_like(l_t, float("-inf")),
                      m_t + torch.log(torch.where(l_t == 0,
                                                  torch.ones_like(l_t), l_t)))
    return o, lse


def merge_partials(o_part: torch.Tensor, lse_part: torch.Tensor):
    """Combine split-KV partials: O = sum_s w_s O_s with
    w_s = exp(lse_s - lse*), lse* = logsumexp_s(lse_s).  Empty splits
    (lse -inf) weigh 0; a row whose splits are all empty gives O = 0 and
    lse -inf.

    o_part: (..., S, Rq, D) normalized partials; lse_part: (..., S, Rq, 1).
    Returns (o (..., Rq, D), lse (..., Rq, 1))."""
    lse = torch.logsumexp(lse_part, dim=-3)
    # -inf - -inf = nan for all-empty rows: those weights are 0 as well
    w = torch.exp(lse_part - lse.unsqueeze(-3)).nan_to_num_(0.0)
    return (o_part * w).sum(dim=-3), lse
