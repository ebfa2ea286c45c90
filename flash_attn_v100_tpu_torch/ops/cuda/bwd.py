"""K2 (dQ) and K3 (dK, dV): dense attention backward (`csrc/bwd.cu`) and
its plain twin.

`flash_attn_dense_bwd` has the signature and returns of
flash_attn_v100_tpu/ops/pallas/bwd.py::flash_attn_dense_bwd without the TPU
tiling knobs: the forward's inputs, its out and lse, dout, and optionally
`dlse`, the cotangent of lse (it folds in as delta - dlse); it returns
(dq, dk, dv) in the inputs' layouts and dtypes.  `offset`, `pos_base` and
`num_heads_total` are those of ops/cuda/fwd.py.  fp32 inputs run on the
fp32 body `csrc/bwd_f32.cu`, 16-bit ones on `csrc/bwd.cu`.

delta = rowsum(O * dO) - dlse is computed here in plain torch, outside the
kernels, as the JAX package leaves it to XLA.  The LSE of a row with no
live key (-inf) is clamped to NEG_INF; the kernels' valid mask, not the
score, zeroes its P.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from flash_attn_v100_tpu_torch.config import NEG_INF
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import build
from flash_attn_v100_tpu_torch.ops.cuda.fwd import (
    DTYPE_CODE, c_dropout_args, c_mask_args, check_dense_inputs,
    dense_keep_mask, kernel_head_dim, pad_head_dim, slopes_bh)


# torch's CUDA sum over the last axis picks its reduction tree by the
# number of rows: under 16 rows of 256 values it spreads a row over 64
# lanes, from 16 rows on over 32 (ATen/native/cuda/Reduce.cuh,
# set_block_dimension), and the two trees round differently.
_SUM_ROWS = 16


def row_dot(out, dout) -> torch.Tensor:
    """rowsum(out * dout) over the last axis in fp32, each row's bits the
    same whatever rows come with it: fewer than _SUM_ROWS rows are summed
    padded with zero rows, so a sequence's delta alone equals its rows of
    a packed batch's."""
    prod = out.to(torch.float32) * dout.to(torch.float32)
    rows = prod.numel() // max(prod.shape[-1], 1)
    if not 0 < rows < _SUM_ROWS:
        return prod.sum(-1)
    flat = torch.nn.functional.pad(prod.reshape(rows, prod.shape[-1]),
                                   (0, 0, 0, _SUM_ROWS - rows))
    return flat.sum(-1)[:rows].reshape(prod.shape[:-1])


def softmax_delta(out, dout, dlse=None) -> torch.Tensor:
    """delta (B, Hq, M) fp32 = rowsum(O * dO) - dlse."""
    delta = row_dot(out, dout).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.to(torch.float32)
    return delta.contiguous()


def _launch(fn_names: Tuple[str, str], q, k, v, dout, lse, delta, slopes,
            dq, dk, dv, softmax_scale, params, dropout_p, dropout_seed,
            offset, pos_base, num_heads_total) -> None:
    """`fn_names`: the 16-bit entry point and its fp32 twin."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn_names[0]} launches on CUDA tensors only; "
                         "flash_attn_dense_bwd takes the plain version for "
                         "CPU tensors")
    B, M, Hq, D = q.shape
    N, Hk = k.shape[1], k.shape[2]
    lib = (build.load("bwd_f32") if q.dtype == torch.float32
           else build.load("bwd"))
    rc = getattr(lib, fn_names[q.dtype == torch.float32])(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if slopes is None else slopes.data_ptr(),
        None if dq is None else dq.data_ptr(),
        None if dk is None else dk.data_ptr(),
        None if dv is None else dv.data_ptr(),
        B, M, N, Hq, Hk, D, offset, float(softmax_scale),
        *c_mask_args(params),
        *c_dropout_args(dropout_p, dropout_seed, pos_base, num_heads_total),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, fn_names[0])


def dq_kernel(q, k, v, dout, lse, delta, slopes, softmax_scale, params,
              dropout_p, dropout_seed, offset, pos_base, num_heads_total):
    """K2 on contiguous CUDA tensors at a kernel head dim -> dq."""
    dq = torch.empty_like(q)
    _launch(("fa_dq_launch", "fa_dq_f32_launch"), q, k, v, dout, lse, delta,
            slopes, dq, None, None, softmax_scale, params, dropout_p,
            dropout_seed, offset, pos_base, num_heads_total)
    dq_kernel.launches += 1
    return dq


dq_kernel.launches = 0


def dkv_kernel(q, k, v, dout, lse, delta, slopes, softmax_scale, params,
               dropout_p, dropout_seed, offset, pos_base, num_heads_total):
    """K3 on contiguous CUDA tensors at a kernel head dim -> (dk, dv)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(("fa_dkv_launch", "fa_dkv_f32_launch"), q, k, v, dout, lse,
            delta, slopes, None, dk, dv, softmax_scale, params, dropout_p,
            dropout_seed, offset, pos_base, num_heads_total)
    dkv_kernel.launches += 1
    return dk, dv


dkv_kernel.launches = 0


def flash_attn_dense_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    softmax_scale: float,
    params: masklib.MaskParams,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
    dlse: Optional[torch.Tensor] = None,
    offset: Optional[int] = None,
    pos_base: Optional[Sequence[int]] = None,
    num_heads_total: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """See the module docstring.  CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attn_dense_bwd_ref(
            q, k, v, out, dout, lse, softmax_scale, params,
            alibi_slopes=alibi_slopes, dropout_p=dropout_p,
            dropout_seed=dropout_seed, dlse=dlse, offset=offset,
            pos_base=pos_base, num_heads_total=num_heads_total)

    check_dense_inputs(q, k, v, "flash_attn_dense_bwd")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dout must match q in shape and dtype")
    B, M, Hq, D = q.shape
    N = k.shape[1]
    delta = softmax_delta(out, dout, dlse)
    lse = lse.to(torch.float32).clamp_min(NEG_INF).contiguous()
    Dk = kernel_head_dim(D)
    q, k, v, dout = (pad_head_dim(t, Dk).contiguous()
                     for t in (q, k, v, dout))
    slopes = (slopes_bh(alibi_slopes, B, Hq, q.device) if params.has_alibi
              else None)
    args = (q, k, v, dout, lse, delta, slopes, softmax_scale, params,
            dropout_p, dropout_seed, N - M if offset is None else int(offset),
            pos_base, Hq if num_heads_total is None else int(num_heads_total))
    dq = dq_kernel(*args)
    dk, dv = dkv_kernel(*args)
    if Dk != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def flash_attn_dense_bwd_ref(
    q, k, v, out, dout, lse, softmax_scale: float,
    params: masklib.MaskParams, alibi_slopes=None, dropout_p: float = 0.0,
    dropout_seed=None, dlse=None, offset: Optional[int] = None,
    pos_base=None, num_heads_total: Optional[int] = None,
    upcast: bool = True,
    einsum=torch.einsum,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 and K3, one batch row at a time, with the
    kernels' rounding points (dS and P_drop rounded to the compute type
    before their products).  `upcast=False` keeps the products in q's
    dtype; `einsum` computes all five (ops/cuda/tf32.py passes its split
    products)."""
    flash_attn_dense_bwd_ref.calls += 1
    B, M, Hq, D = q.shape
    N, Hk = k.shape[1], k.shape[2]
    group = Hq // Hk
    dev = q.device
    cd = torch.float32 if upcast else q.dtype
    offset = N - M if offset is None else int(offset)
    delta = softmax_delta(out, dout, dlse)
    lse = lse.to(torch.float32).clamp_min(NEG_INF)
    rows = torch.arange(M, device=dev)[:, None]
    cols = torch.arange(N, device=dev)[None, :]
    valid = masklib.position_mask(rows, cols, offset=offset, params=params)
    slopes = (slopes_bh(alibi_slopes, B, Hq, dev) if params.has_alibi
              else None)

    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for b in range(B):
        qb = q[b].transpose(0, 1).to(cd)
        dob = dout[b].transpose(0, 1).to(cd)
        kb = k[b].transpose(0, 1).repeat_interleave(group, dim=0).to(cd)
        vb = v[b].transpose(0, 1).repeat_interleave(group, dim=0).to(cd)
        s = einsum("hmd,hnd->hmn", qb, kb).to(torch.float32)
        s = masklib.apply_score_bias(
            s, rows, cols, softmax_scale=softmax_scale, offset=offset,
            params=params,
            alibi_slope=None if slopes is None else slopes[b].view(Hq, 1, 1))
        p = torch.exp(torch.clamp_max(s - lse[b][..., None], 0.0))
        p = torch.where(valid, p, torch.zeros_like(p))
        p_drop = p
        if dropout_p > 0.0:
            keep = dense_keep_mask(b, Hq, M, N, dropout_p, dropout_seed,
                                   pos_base, num_heads_total, dev)
            p_drop = torch.where(keep, p * (1.0 / (1.0 - dropout_p)),
                                 torch.zeros_like(p))
        dp = einsum("hmd,hnd->hmn", dob, vb).to(torch.float32)
        ds = (p_drop * dp - p * delta[b][..., None]) * softmax_scale
        if params.softcap > 0.0:
            sn = s * (1.0 / params.softcap)
            ds = ds * (1.0 - sn * sn)
        ds_c = ds.to(cd)
        dq_b = einsum("hmn,hnd->hmd", ds_c, kb).to(torch.float32)
        dk_b = einsum("hmn,hmd->hnd", ds_c, qb).to(torch.float32)
        dv_b = einsum("hmn,hmd->hnd", p_drop.to(cd),
                            dob).to(torch.float32)
        dq[b] = dq_b.transpose(0, 1).to(q.dtype)
        dk[b] = dk_b.view(Hk, group, N, D).sum(1).transpose(0, 1).to(k.dtype)
        dv[b] = dv_b.view(Hk, group, N, D).sum(1).transpose(0, 1).to(v.dtype)
    return dq, dk, dv


flash_attn_dense_bwd_ref.calls = 0
