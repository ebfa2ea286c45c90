"""K1: dense attention forward (`csrc/fwd.cu`) and its plain twin.

`flash_attn_dense_fwd` has the signature and returns of
flash_attn_v100_tpu/ops/pallas/fwd.py::flash_attn_dense_fwd without the TPU
tiling knobs: q (B, M, Hq, D), k/v (B, N, Hk, D), mask params, optional
ALiBi slopes (B, Hq), Philox dropout with a (lo, hi) seed; it returns out
(B, M, Hq, D) in q's dtype and lse (B, Hq, M) fp32.

The ring-attention extras are plain integers: `offset` overrides the
bottom-right alignment N - M of the causal/window masks and the ALiBi
distance; `pos_base = (q0, k0, b0, h0)` shifts the dropout keying to
global (row, col, batch, head) coordinates and `num_heads_total` is the
global head count in bh = (b + b0) * num_heads_total + (h + h0).

The kernel takes head_dim 32/64/128/256; other head dims up to 256 are
zero-padded to the next of those (the scores and the real output columns
do not change) and sliced back, except that 16-bit rows of 8, 16 or 24
columns go to the D 32 kernel as they are (`fwd_head_dims`): it reads
them into zero-filled tiles and writes only their columns of out.

bf16 and fp16 inputs run on `csrc/fwd.cu`, fp32 inputs on the fp32 body
`csrc/fwd_f32.cu` (the same entry arguments, dtype code 2); other dtypes
raise TypeError.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops import philox
from flash_attn_v100_tpu_torch.ops.cuda import build

DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
KERNEL_HEAD_DIMS = (32, 64, 128, 256)


def kernel_head_dim(D: int) -> int:
    """The kernel head dim that holds D.  Head dims over 256 raise: the
    port's CUDA entry points cap the head dim at 256, as the reference
    CUDA code and upstream FlashAttention do (the JAX package pads any)."""
    for kd in KERNEL_HEAD_DIMS:
        if D <= kd:
            return kd
    raise ValueError(f"the kernels take head_dim <= 256, got {D}")


def fwd_head_dims(D: int, dtype) -> Tuple[int, int]:
    """(kernel head dim, columns of the rows the forward kernel reads) for
    head dim D: K1 and K5 at kernel head dim 32 take 16-bit rows of any
    multiple of 8 columns themselves, so D 8-24 need no padded copies;
    every other head dim is padded to the kernel's."""
    Dk = kernel_head_dim(D)
    narrow = Dk == 32 and D % 8 == 0 and dtype != torch.float32
    return Dk, D if narrow else Dk


def pad_head_dim(x: torch.Tensor, Dk: int) -> torch.Tensor:
    D = x.shape[-1]
    return x if D == Dk else F.pad(x, (0, Dk - D))


def seed_words(dropout_seed) -> Tuple[int, int]:
    """A (2,) (lo, hi) seed as given to the kernels -> two Python ints."""
    lo, hi = (dropout_seed.tolist() if isinstance(dropout_seed, torch.Tensor)
              else dropout_seed)
    return int(lo) & 0xFFFFFFFF, int(hi) & 0xFFFFFFFF


def c_mask_args(params: masklib.MaskParams) -> tuple:
    return (int(params.causal), int(params.window_left),
            int(params.window_right), float(params.softcap),
            int(params.has_alibi))


def c_dropout_args(dropout_p: float, dropout_seed, pos_base,
                   num_heads: int) -> tuple:
    """(enabled, seed_lo, seed_hi, threshold, scale, q0, k0, b0, h0,
    num_heads) as the kernels' C entry points take them."""
    q0, k0, b0, h0 = (int(x) for x in (pos_base or (0, 0, 0, 0)))
    if dropout_p <= 0.0:
        return (0, 0, 0, 0, 1.0, q0, k0, b0, h0, num_heads)
    if dropout_seed is None:
        raise ValueError("dropout needs a (lo, hi) dropout_seed")
    lo, hi = seed_words(dropout_seed)
    return (1, lo, hi, philox.keep_threshold(dropout_p),
            1.0 / (1.0 - dropout_p), q0, k0, b0, h0, num_heads)


def dense_keep_mask(b: int, Hq: int, M: int, N: int, dropout_p: float,
                    dropout_seed, pos_base: Optional[Sequence[int]] = None,
                    num_heads_total: Optional[int] = None,
                    device=None) -> torch.Tensor:
    """The dropout keep mask (Hq, M, N) of batch row `b`, as the kernels
    key it."""
    q0, k0, b0, h0 = (int(x) for x in (pos_base or (0, 0, 0, 0)))
    nh = Hq if num_heads_total is None else num_heads_total
    lo, hi = seed_words(dropout_seed)
    rows = torch.arange(M, device=device)[:, None] + q0
    cols = torch.arange(N, device=device)[None, :] + k0
    bh = ((b + b0) * nh + h0 + torch.arange(Hq, device=device)).view(Hq, 1, 1)
    return philox.dropout_keep_mask(rows, cols, bh, lo, hi, dropout_p)


def slopes_bh(alibi_slopes, B: int, Hq: int, dev) -> torch.Tensor:
    s = torch.as_tensor(alibi_slopes).to(device=dev, dtype=torch.float32)
    if s.dim() == 1:
        s = s[None].expand(B, Hq)
    if tuple(s.shape) != (B, Hq):
        raise ValueError(f"alibi_slopes must be (Hq,) or (B, Hq), got "
                         f"{tuple(s.shape)}")
    return s.contiguous()


def check_dense_inputs(q, k, v, what: str) -> None:
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes bf16/fp16/fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k and v must share one dtype")
    B, M, Hq, D = q.shape
    if (k.dim() != 4 or k.shape[0] != B or k.shape[3] != D
            or v.shape != k.shape or Hq % k.shape[2]):
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"{what}: all inputs must be on one device")


def flash_attn_dense_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    softmax_scale: float,
    params: masklib.MaskParams,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
    offset: Optional[int] = None,
    pos_base: Optional[Sequence[int]] = None,
    num_heads_total: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """See the module docstring.  CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attn_dense_fwd_ref(
            q, k, v, softmax_scale, params, alibi_slopes=alibi_slopes,
            dropout_p=dropout_p, dropout_seed=dropout_seed, offset=offset,
            pos_base=pos_base, num_heads_total=num_heads_total)

    check_dense_inputs(q, k, v, "flash_attn_dense_fwd")
    B, M, Hq, D = q.shape
    N, Hk = k.shape[1], k.shape[2]
    dev = q.device
    Dk, Din = fwd_head_dims(D, q.dtype)
    q, k, v = (pad_head_dim(t, Din).contiguous() for t in (q, k, v))
    slopes = slopes_bh(alibi_slopes, B, Hq, dev) if params.has_alibi else None
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, M), dtype=torch.float32, device=dev)
    offset = N - M if offset is None else int(offset)
    nh = Hq if num_heads_total is None else int(num_heads_total)

    launch = (build.load("fwd_f32").fa_fwd_f32_launch
              if q.dtype == torch.float32 else build.load("fwd").fa_fwd_launch)
    rc = launch(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, M, N, Hq, Hk, Dk, Din, offset,
        float(softmax_scale),
        *c_mask_args(params),
        *c_dropout_args(dropout_p, dropout_seed, pos_base, nh),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "flash_attn_dense_fwd")
    flash_attn_dense_fwd.launches += 1
    return (out if Din == D else out[..., :D].contiguous()), lse


flash_attn_dense_fwd.launches = 0


def flash_attn_dense_fwd_ref(
    q, k, v, softmax_scale: float, params: masklib.MaskParams,
    alibi_slopes=None, dropout_p: float = 0.0, dropout_seed=None,
    offset: Optional[int] = None, pos_base=None,
    num_heads_total: Optional[int] = None, upcast: bool = True,
    einsum=torch.einsum,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, one batch row at a time: P is
    taken unnormalized against the row max and rounded to the compute type
    before P V, as the kernel does.  `upcast=False` keeps both products in
    q's dtype; `einsum` computes both (ops/cuda/tf32.py passes its split
    products)."""
    flash_attn_dense_fwd_ref.calls += 1
    B, M, Hq, D = q.shape
    N, Hk = k.shape[1], k.shape[2]
    group = Hq // Hk
    dev = q.device
    cd = torch.float32 if upcast else q.dtype
    offset = N - M if offset is None else int(offset)
    rows = torch.arange(M, device=dev)[:, None]
    cols = torch.arange(N, device=dev)[None, :]
    valid = masklib.position_mask(rows, cols, offset=offset, params=params)
    slopes = (slopes_bh(alibi_slopes, B, Hq, dev) if params.has_alibi
              else None)

    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, M), dtype=torch.float32, device=dev)
    for b in range(B):
        qb = q[b].transpose(0, 1).to(cd)
        kb = k[b].transpose(0, 1).repeat_interleave(group, dim=0).to(cd)
        vb = v[b].transpose(0, 1).repeat_interleave(group, dim=0).to(cd)
        s = einsum("hmd,hnd->hmn", qb, kb).to(torch.float32)
        s = masklib.apply_score_pipeline(
            s, rows, cols, softmax_scale=softmax_scale, offset=offset,
            params=params, valid=valid,
            alibi_slope=None if slopes is None else slopes[b].view(Hq, 1, 1))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True)
        if dropout_p > 0.0:
            keep = dense_keep_mask(b, Hq, M, N, dropout_p, dropout_seed,
                                   pos_base, num_heads_total, dev)
            p = torch.where(keep, p * (1.0 / (1.0 - dropout_p)),
                            torch.zeros_like(p))
        safe = torch.where(l == 0, torch.ones_like(l), l)
        o = einsum("hmn,hnd->hmd", p.to(cd), vb).to(torch.float32) / safe
        o = torch.where(l == 0, torch.zeros_like(o), o)
        out[b] = o.transpose(0, 1).to(q.dtype)
        lse[b] = torch.where(l[..., 0] == 0,
                             torch.full_like(l[..., 0], float("-inf")),
                             m[..., 0] + torch.log(safe[..., 0]))
    return out, lse


flash_attn_dense_fwd_ref.calls = 0
