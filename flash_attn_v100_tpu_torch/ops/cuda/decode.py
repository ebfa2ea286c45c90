"""K4: split-KV paged decode attention (`csrc/decode.cu`) and its plain twin.

`paged_decode_attention` has the signature and return shapes of
flash_attn_v100_tpu/ops/pallas/decode.py::paged_decode_attention: GQA-folded
q rows (B, Hk, Rq, D), a page pool view (C1, Hk, C2, ps, D) in which page id
p lives at [p // C2, :, p % C2] (any strides with a contiguous last axis),
a block table (B, max_pages) int32; it returns fp32 normalized partials
o_part (B, Hk, S, Rq, D) and lse_part (B, Hk, S, Rq, 1), one per KV split,
combined by `merge_partials`.

For CUDA tensors it launches the kernel (bf16 or fp16; anything else
raises); for CPU tensors it computes `paged_decode_attention_ref`, the plain
PyTorch version of the same function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from flash_attn_v100_tpu_torch.config import EXP_CLAMP
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import build

ROW_TILE = 8         # q rows per block (kRowTile in decode.cu)
SM_COUNT_H100 = 132  # the split rule's target when no device is at hand
BLOCKS_PER_SM = 4    # auto splits aim at this many blocks per SM

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _sm_count(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return SM_COUNT_H100


def resolve_num_splits(num_splits: int, B: int, Hk: int, Rq: int,
                       max_pages: int, device: torch.device) -> int:
    """num_splits <= 0 means auto: enough KV splits that B * Hk * S blocks
    (times the q-row tiles) put BLOCKS_PER_SM blocks on every SM, so that
    each block walks a short key range (the kernel is latency-bound per
    block).  Never more splits than table slots."""
    S = num_splits
    if S <= 0:
        blocks = B * Hk * _cdiv(Rq, ROW_TILE)
        S = _cdiv(BLOCKS_PER_SM * _sm_count(device), max(blocks, 1))
    return max(1, min(S, max_pages))


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-KV paged attention core; see the module docstring.
    `qpos_vec` (B,) is the position of the first new token in the live
    frame (default cache_seqlens - t_new); `leftpad` (B,) or None for
    none; `alibi_slopes_rows` is (B, Hk, Rq[, 1]) fp32 per folded row."""
    if qpos_vec is None:
        qpos_vec = cache_seqlens.to(torch.int32) - t_new
    if q_rows.device.type == "cpu":
        return paged_decode_attention_ref(
            q_rows, k_pages, v_pages, block_table, cache_seqlens, leftpad,
            qpos_vec=qpos_vec, softmax_scale=softmax_scale, params=params,
            t_new=t_new, group=group, num_splits=num_splits,
            alibi_slopes_rows=alibi_slopes_rows)

    B, Hk, Rq, D = q_rows.shape
    C1, Hk2, C2, ps, Dk = k_pages.shape
    dev = q_rows.device
    if q_rows.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode kernel takes bf16/fp16, got {q_rows.dtype}")
    if k_pages.dtype != q_rows.dtype or v_pages.dtype != q_rows.dtype:
        raise TypeError("q rows and the page pools must share one dtype")
    if Hk2 != Hk or Dk != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"pool view {tuple(k_pages.shape)} does not match "
                         f"q rows {tuple(q_rows.shape)}")
    if D not in (32, 64, 128, 256):
        raise ValueError(f"decode kernel takes head_dim 32/64/128/256, got {D}")
    if Rq % ROW_TILE:
        raise ValueError(f"Rq ({Rq}) must be a multiple of {ROW_TILE}")
    if k_pages.stride() != v_pages.stride() or k_pages.stride(-1) != 1:
        raise ValueError("k/v pool views need equal strides and a "
                         "contiguous last axis")
    if any(s % 8 for s in k_pages.stride()[:-1]) or any(
            t.data_ptr() % 16 for t in (k_pages, v_pages)):
        raise ValueError("pool strides must be multiples of 8 elements and "
                         "the pools 16-byte aligned (16-byte loads)")
    for t in (k_pages, v_pages, block_table, cache_seqlens, leftpad, qpos_vec):
        if t is not None and t.device != dev:
            raise ValueError("all decode inputs must be on one device")
    max_pages = block_table.shape[1]
    S = resolve_num_splits(num_splits, B, Hk, Rq, max_pages, dev)
    nb = _cdiv(max_pages, S)

    q_rows = q_rows.contiguous()
    tbl = block_table.to(torch.int32).contiguous()
    lens = cache_seqlens.to(torch.int32).contiguous()
    lp = None if leftpad is None else leftpad.to(torch.int32).contiguous()
    qpos = qpos_vec.to(torch.int32).contiguous()
    slopes = None
    if params.has_alibi:
        slopes = alibi_slopes_rows.to(torch.float32).reshape(B, Hk, Rq).contiguous()
    o_part = torch.empty((B, Hk, S, Rq, D), dtype=torch.float32, device=dev)
    lse_part = torch.empty((B, Hk, S, Rq, 1), dtype=torch.float32, device=dev)

    lib = build.load("decode")
    s_c1, s_h, s_c2, s_tok, _ = k_pages.stride()
    rc = lib.fa_decode_launch(
        _DTYPE_CODE[q_rows.dtype], q_rows.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), tbl.data_ptr(), lens.data_ptr(),
        lp.data_ptr() if lp is not None else None,
        qpos.data_ptr(), slopes.data_ptr() if slopes is not None else None,
        o_part.data_ptr(), lse_part.data_ptr(),
        s_c1, s_h, s_c2, s_tok, C2, B, Hk, Rq, D, S, max_pages, ps, nb,
        t_new, group, float(softmax_scale), int(params.causal),
        int(params.window_left), int(params.window_right),
        float(params.softcap), int(params.has_alibi),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return o_part, lse_part


paged_decode_attention.launches = 0


def paged_decode_attention_ref(
    q_rows, k_pages, v_pages, block_table, cache_seqlens, leftpad, *,
    qpos_vec: Optional[torch.Tensor] = None, softmax_scale: float,
    params: masklib.MaskParams, t_new: int, group: int, num_splits: int = 0,
    alibi_slopes_rows: Optional[torch.Tensor] = None, upcast: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same inputs, same partials.
    `upcast=False` keeps both products in the input dtype (the
    same-bit-width yardstick of the tolerance model)."""
    B, Hk, Rq, D = q_rows.shape
    _, _, C2, ps, _ = k_pages.shape
    dev = q_rows.device
    if qpos_vec is None:
        qpos_vec = cache_seqlens.to(torch.int32) - t_new
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

    s = torch.einsum("bhrd,bhnd->bhrn", q_rows.to(cd), k).to(torch.float32)
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
    o = torch.einsum("bhrsn,bhsnd->bhsrd", p.to(cd), vs).to(torch.float32)
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
