"""K8: paged-KV varlen attention forward (`csrc/varlen_paged.cu`) and its
plain twin.

`flash_attn_varlen_fwd_paged` has the signature and returns of
flash_attn_v100_tpu/ops/pallas/varlen.py::flash_attn_varlen_fwd_paged: packed
q (Tq, Hq, D) split by `cu_seqlens_q`, HND page pools (Hk, P, ps, D) (any
strides with a contiguous last axis), a block table (B, >= mp) with
mp = ceil(max_seqlen_k / ps), per-sequence `seqlens_k`, optional `seqused_k`
and `leftpad_k`; it returns out (Tq, Hq, D) in q's dtype and lse (Hq, Tq)
fp32.  page_size must be a multiple of 128.

The ragged bookkeeping of build_ragged_info (varlen.py:48-151) is, per q
row at within-sequence position qp of sequence b,
    used  = min(seqlens_k[b], seqused_k[b])
    slk   = (min(mp * ps, used) if used > 0 else 0) - leftpad_k[b]
    offs  = slk - seqlen_q[b]
    live keys (leftpad-relative) = [lo, hi] with
        hi = slk - 1, min'ed with qp + offs + window_right_eff
        lo = 0, max'ed with qp + offs - window_left
and the key at leftpad-relative position j is cache row leftpad + j of the
sequence's pages.  The kernel evaluates it as index math; the plain version
with torch ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def flash_attn_varlen_fwd_paged(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    seqlens_k: torch.Tensor,
    max_seqlen_q: int,
    max_seqlen_k: int,
    softmax_scale: float,
    params: masklib.MaskParams,
    alibi_slopes: Optional[torch.Tensor] = None,   # (B, Hq)
    seqused_k: Optional[torch.Tensor] = None,
    leftpad_k: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """See the module docstring.  CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attn_varlen_fwd_paged_ref(
            q, k_pool, v_pool, block_table, cu_seqlens_q, seqlens_k,
            max_seqlen_q, max_seqlen_k, softmax_scale, params,
            alibi_slopes=alibi_slopes, seqused_k=seqused_k,
            leftpad_k=leftpad_k)

    Tq, Hq, D = q.shape
    Hk, P, ps, Dk = k_pool.shape
    dev = q.device
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"varlen kernel takes bf16/fp16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q and the page pools must share one dtype")
    if Dk != D or v_pool.shape != k_pool.shape or Hq % Hk:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if D not in (32, 64, 128, 256):
        raise ValueError(f"varlen kernel takes head_dim 32/64/128/256, got {D}")
    if ps % 128:
        raise ValueError(f"paged varlen needs page_size % 128 == 0 (got {ps})")
    if k_pool.stride() != v_pool.stride() or k_pool.stride(-1) != 1:
        raise ValueError("k/v pools need equal strides and a contiguous "
                         "last axis")
    if any(s % 8 for s in k_pool.stride()[:-1]) or any(
            t.data_ptr() % 16 for t in (k_pool, v_pool)):
        raise ValueError("pool strides must be multiples of 8 elements and "
                         "the pools 16-byte aligned (16-byte loads)")
    B = cu_seqlens_q.shape[0] - 1
    mp = _cdiv(max_seqlen_k, ps)
    if block_table.shape[0] < B or block_table.shape[1] < mp:
        raise ValueError(f"block_table {tuple(block_table.shape)} must cover "
                         f"{B} sequences x {mp} pages")
    for t in (k_pool, v_pool, block_table, cu_seqlens_q, seqlens_k):
        if t.device != dev:
            raise ValueError("all varlen inputs must be on one device")

    q = q.contiguous()
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    tbl = block_table.to(torch.int32).contiguous()
    cu_q = cu_seqlens_q.to(torch.int32).contiguous()
    lens = seqlens_k.to(torch.int32).contiguous()
    used = None if seqused_k is None else seqused_k.to(torch.int32).contiguous()
    lp = None if leftpad_k is None else leftpad_k.to(torch.int32).contiguous()
    slopes = None
    if params.has_alibi:
        slopes = alibi_slopes.to(device=dev, dtype=torch.float32)
        if slopes.dim() == 1:
            slopes = slopes[None].expand(B, Hq)
        slopes = slopes.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((Hq, Tq), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.load("varlen_paged")
    s_h, s_p, s_tok, _ = k_pool.stride()
    rc = lib.fa_varlen_paged_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), tbl.data_ptr(), tbl.shape[1], cu_q.data_ptr(),
        lens.data_ptr(), ptr(used), ptr(lp), ptr(slopes), out.data_ptr(),
        lse.data_ptr(), s_h, s_p, s_tok, B, Tq, Hq, Hk, D, ps, mp,
        int(max_seqlen_q), float(softmax_scale), int(params.causal),
        int(params.window_left), int(params.window_right),
        float(params.softcap), int(params.has_alibi),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "flash_attn_varlen_fwd_paged")
    flash_attn_varlen_fwd_paged.launches += 1
    return out, lse


flash_attn_varlen_fwd_paged.launches = 0


def flash_attn_varlen_fwd_paged_ref(
    q, k_pool, v_pool, block_table, cu_seqlens_q, seqlens_k,
    max_seqlen_q: int, max_seqlen_k: int, softmax_scale: float,
    params: masklib.MaskParams, alibi_slopes=None, seqused_k=None,
    leftpad_k=None, upcast: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, one sequence at a time.
    `upcast=False` keeps both products in q's dtype."""
    Tq, Hq, D = q.shape
    Hk, _, ps, _ = k_pool.shape
    group = Hq // Hk
    dev = q.device
    cd = torch.float32 if upcast else q.dtype
    mp = _cdiv(max_seqlen_k, ps)
    B = cu_seqlens_q.shape[0] - 1
    cu = [int(x) for x in cu_seqlens_q.tolist()]
    used = seqlens_k.to(torch.long).cpu()
    if seqused_k is not None:
        used = torch.minimum(used, seqused_k.to(torch.long).cpu())
    lps = ([0] * B if leftpad_k is None
           else [int(x) for x in leftpad_k.tolist()])
    slopes = None
    if params.has_alibi:
        slopes = alibi_slopes.to(device=dev, dtype=torch.float32)
        if slopes.dim() == 1:
            slopes = slopes[None].expand(B, Hq)
    wr = params.effective_window_right()
    eff = masklib.MaskParams(causal=False, window_left=params.window_left,
                             window_right=wr, softcap=params.softcap,
                             has_alibi=params.has_alibi)

    out = torch.zeros_like(q)
    lse = torch.full((Hq, Tq), float("-inf"), dtype=torch.float32, device=dev)
    tbl = block_table.to(device=dev, dtype=torch.long)
    for b in range(B):
        q0, slq = cu[b], cu[b + 1] - cu[b]
        u = int(used[b])
        lp = lps[b]
        slk = (min(mp * ps, u) if u > 0 else 0) - lp
        if slq <= 0 or slk <= 0:
            continue
        pages = tbl[b, :mp]
        k = k_pool[:, pages].reshape(Hk, mp * ps, D)[:, lp:lp + slk]
        v = v_pool[:, pages].reshape(Hk, mp * ps, D)[:, lp:lp + slk]
        k = k.repeat_interleave(group, dim=0).to(cd)
        v = v.repeat_interleave(group, dim=0).to(cd)
        qb = q[q0:q0 + slq].transpose(0, 1).to(cd)          # (Hq, slq, D)
        s = torch.einsum("hqd,hkd->hqk", qb, k).to(torch.float32)
        qp = torch.arange(slq, device=dev).view(1, slq, 1)
        kp = torch.arange(slk, device=dev).view(1, 1, slk)
        offs = slk - slq
        valid = masklib.position_mask(qp, kp, offset=offs, params=eff)
        slope = None if slopes is None else slopes[b].view(Hq, 1, 1)
        s = masklib.apply_score_pipeline(s, qp, kp, softmax_scale=softmax_scale,
                                         offset=offs, params=eff, valid=valid,
                                         alibi_slope=slope)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True)
        safe = torch.where(l == 0, torch.ones_like(l), l)
        o = torch.einsum("hqk,hkd->hqd", p.to(cd), v).to(torch.float32) / safe
        o = torch.where(l == 0, torch.zeros_like(o), o)
        out[q0:q0 + slq] = o.transpose(0, 1).to(q.dtype)
        lse[:, q0:q0 + slq] = torch.where(
            l[..., 0] == 0, torch.full_like(l[..., 0], float("-inf")),
            m[..., 0] + torch.log(safe[..., 0]))
    return out, lse
