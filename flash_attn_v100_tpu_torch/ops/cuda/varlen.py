"""Packed varlen attention kernels and their plain twins: K5 forward (the
dense forward's body instantiated for varlen, `csrc/fwd.cu`), K6 dQ and K7
dK/dV (the dense backward's bodies instantiated for varlen, `csrc/bwd.cu`)
on contiguous packed K/V, and K8 forward with K/V read through a block
table from a page pool (the same forward body instantiated for pages,
`csrc/varlen_paged.cu`).

`flash_attn_varlen_fwd` / `flash_attn_varlen_bwd` have the signatures and
returns of flash_attn_v100_tpu/ops/pallas/varlen.py's (without the TPU
tiling knobs): q (Tq, Hq, D) split by `cu_seqlens_q`, k/v (Tk, Hk, D) split
by `cu_seqlens_k`, optional `seqused_k` and `leftpad_k` (B,), ALiBi slopes
(Hq,) or (B, Hq), Philox dropout with a (lo, hi) seed keyed on
(within-sequence q position, leftpad-relative key position,
bh = b * Hq + h); the forward returns out (Tq, Hq, D) in q's dtype and lse
(Hq, Tq) fp32, the backward (dq, dk, dv) in the packed layouts, folding
`dlse` in as delta - dlse.  Packed rows past cu_q[B] and keys that no
sequence uses come out as O = 0, LSE = -inf and zero gradients.  The
kernels take head_dim 32/64/128/256; other head dims up to 256 are
zero-padded to the next of those and sliced back (K5 reads 16-bit rows of
8-24 columns as they are: fwd.py's `fwd_head_dims`).  `max_seqlen_q` and
`max_seqlen_k` are host ints that must bound every sequence's lengths: they
size the grids.  The CUDA path reads cu_seqlens, seqused_k and leftpad_k on
the device and never syncs with the host; the plain versions do.

`flash_attn_varlen_fwd_paged` has the signature and returns of
flash_attn_v100_tpu/ops/pallas/varlen.py::flash_attn_varlen_fwd_paged: packed
q (Tq, Hq, D) split by `cu_seqlens_q`, HND page pools (Hk, P, ps, D) (any
strides with a contiguous last axis), a block table (B, >= mp) with
mp = ceil(max_seqlen_k / ps), per-sequence `seqlens_k`, optional `seqused_k`
and `leftpad_k`; it returns out (Tq, Hq, D) in q's dtype and lse (Hq, Tq)
fp32.  page_size must be a multiple of 128.  With `k_scales` / `v_scales`
((Hk, P, page_size, 1) fp32) the pools are quantized (ops/quant.py), as
JAX detects them: fp8 by dtype, int4 by a pool of page_size / 2 rows,
else int8.  That is K8q (`csrc/varlen_paged_quant.cu`, the TPU kernel's
kv_quant branches; see its note), whose P is quantized per row over each
P_TILE = 64-row tile of the sequence's cache rows (`p_tile=None` in the
plain version: per page, the TPU kernel's grouping at kv_unroll 1).

The ragged bookkeeping of build_ragged_info (varlen.py:48-151) is, per q
row at within-sequence position qp of sequence b,
    used  = min(len_k[b], seqused_k[b]) if seqused_k[b] > 0 else 0
            (K8: len_k = seqlens_k, and used is further capped at mp * ps)
    slk   = used - leftpad_k[b]
    offs  = slk - len_q[b]
    live keys (leftpad-relative) = [lo, hi] with
        hi = slk - 1, min'ed with qp + offs + window_right_eff
        lo = 0, max'ed with qp + offs - window_left
and the key at leftpad-relative position j is packed row
cu_k[b] + leftpad_k[b] + j (K8: cache row leftpad + j of the sequence's
pages).  The kernels evaluate it as index math (`csrc/seq.cuh`); the plain
versions with `seq_bounds` and torch ops.

fp32 inputs run on the fp32 bodies: K5 and K8 on `csrc/fwd_f32.cu`, K6/K7
on `csrc/bwd_f32.cu`; fp32 q over a quantized pool on K8q's fp32
instantiations (out in fp32).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from flash_attn_v100_tpu_torch.config import NEG_INF
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import build
from flash_attn_v100_tpu_torch.ops.cuda.bwd import (
    flash_attn_dense_bwd_ref, row_dot)
from flash_attn_v100_tpu_torch.ops.cuda.decode import (
    KIND_CODE, _check_quant, _int_matmul, _quantize_rows,
    quant_payload_values)
from flash_attn_v100_tpu_torch.ops.cuda.fwd import (
    DTYPE_CODE, c_dropout_args, c_mask_args, flash_attn_dense_fwd_ref,
    fwd_head_dims, kernel_head_dim, pad_head_dim, slopes_bh)
from flash_attn_v100_tpu_torch.ops.quant import FP8, payload_bytes

P_TILE = 64       # K8q's key step: P's int8 group (BK in the kernels)
LOG2E = math.log2(math.e)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ------------------------------------------------------ ragged bookkeeping

def seq_bounds(cu_seqlens_q, cu_seqlens_k, seqused_k=None,
               leftpad_k=None) -> List[Tuple[int, int, int, int, int]]:
    """Per sequence (q0, slq, k0, slk, offs) as host ints: its first packed
    q row and q length, the packed row of its leftpad-relative key 0, its
    live key count and its mask offset (module docstring).  Syncs with the
    host: the plain versions and the dropout mask use it, never the CUDA
    path."""
    cu_q = [int(x) for x in cu_seqlens_q.tolist()]
    cu_k = [int(x) for x in cu_seqlens_k.tolist()]
    B = len(cu_q) - 1
    used = None if seqused_k is None else [int(x) for x in seqused_k.tolist()]
    lps = [0] * B if leftpad_k is None else [int(x)
                                             for x in leftpad_k.tolist()]
    out = []
    for b in range(B):
        slq = cu_q[b + 1] - cu_q[b]
        n = cu_k[b + 1] - cu_k[b]
        if used is not None:
            n = min(n, used[b]) if used[b] > 0 else 0
        slk = n - lps[b]
        out.append((cu_q[b], slq, cu_k[b] + lps[b], slk, slk - slq))
    return out


def _ragged_device_args(cu_seqlens_q, cu_seqlens_k, seqused_k, leftpad_k,
                        B: int, dev) -> tuple:
    """The int32 bookkeeping the kernels read, contiguous on `dev`."""
    out = []
    for name, t, n in (("cu_seqlens_q", cu_seqlens_q, B + 1),
                       ("cu_seqlens_k", cu_seqlens_k, B + 1),
                       ("seqused_k", seqused_k, B),
                       ("leftpad_k", leftpad_k, B)):
        if t is None:
            out.append(None)
            continue
        if t.device != dev or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be a ({n},) tensor on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        out.append(t.to(torch.int32).contiguous())
    return tuple(out)


def _check_packed_inputs(q, k, v, what: str) -> None:
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes bf16/fp16/fp32, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k and v must share one dtype")
    if (q.dim() != 3 or k.dim() != 3 or k.shape[2] != q.shape[2]
            or v.shape != k.shape or q.shape[1] % k.shape[1]):
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"{what}: all inputs must be on one device")


# ------------------------------------------------------------ K5 forward

def flash_attn_varlen_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_k: torch.Tensor,
    max_seqlen_q: int,
    max_seqlen_k: int,
    softmax_scale: float,
    params: masklib.MaskParams,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
    seqused_k: Optional[torch.Tensor] = None,
    leftpad_k: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5; see the module docstring.  CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attn_varlen_fwd_ref(
            q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
            softmax_scale, params, alibi_slopes=alibi_slopes,
            dropout_p=dropout_p, dropout_seed=dropout_seed,
            seqused_k=seqused_k, leftpad_k=leftpad_k)

    _check_packed_inputs(q, k, v, "flash_attn_varlen_fwd")
    Tq, Hq, D = q.shape
    Hk = k.shape[1]
    B = cu_seqlens_q.shape[0] - 1
    dev = q.device
    cu_q, cu_k, used, lp = _ragged_device_args(
        cu_seqlens_q, cu_seqlens_k, seqused_k, leftpad_k, B, dev)
    Dk, Din = fwd_head_dims(D, q.dtype)
    q, k, v = (pad_head_dim(t, Din).contiguous() for t in (q, k, v))
    slopes = slopes_bh(alibi_slopes, B, Hq, dev) if params.has_alibi else None
    # packed rows past cu_q[B] belong to no block: O = 0, LSE = -inf
    out = torch.zeros_like(q)
    lse = torch.full((Hq, Tq), float("-inf"), dtype=torch.float32,
                     device=dev)
    launch = (build.load("fwd_f32").fa_varlen_fwd_f32_launch
              if q.dtype == torch.float32
              else build.load("fwd").fa_varlen_fwd_launch)
    rc = launch(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cu_q.data_ptr(), cu_k.data_ptr(), _ptr(used), _ptr(lp),
        _ptr(slopes), out.data_ptr(), lse.data_ptr(), B, Tq,
        int(max_seqlen_q), Hq, Hk, Dk, Din, float(softmax_scale),
        *c_mask_args(params),
        *c_dropout_args(dropout_p, dropout_seed, None, Hq),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "flash_attn_varlen_fwd")
    flash_attn_varlen_fwd.launches += 1
    return (out if Din == D else out[..., :D].contiguous()), lse


flash_attn_varlen_fwd.launches = 0


def flash_attn_varlen_fwd_ref(
    q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q: int,
    max_seqlen_k: int, softmax_scale: float, params: masklib.MaskParams,
    alibi_slopes=None, dropout_p: float = 0.0, dropout_seed=None,
    seqused_k=None, leftpad_k=None, upcast: bool = True,
    einsum=torch.einsum,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5, one sequence at a time through the
    dense plain version (the kernels' rounding points) with the sequence's
    offset and dropout keyed on bh = b * Hq + h.  `upcast=False` keeps both
    products in q's dtype; `einsum` computes them (ops/cuda/tf32.py passes
    its split products)."""
    flash_attn_varlen_fwd_ref.calls += 1
    Tq, Hq, _ = q.shape
    B = cu_seqlens_q.shape[0] - 1
    slopes = (slopes_bh(alibi_slopes, B, Hq, q.device) if params.has_alibi
              else None)
    out = torch.zeros_like(q)
    lse = torch.full((Hq, Tq), float("-inf"), dtype=torch.float32,
                     device=q.device)
    for b, (q0, slq, k0, slk, offs) in enumerate(seq_bounds(
            cu_seqlens_q, cu_seqlens_k, seqused_k, leftpad_k)):
        if slq <= 0 or slk <= 0:
            continue
        o, l = flash_attn_dense_fwd_ref(
            q[None, q0:q0 + slq], k[None, k0:k0 + slk],
            v[None, k0:k0 + slk], softmax_scale, params,
            alibi_slopes=None if slopes is None else slopes[b:b + 1],
            dropout_p=dropout_p, dropout_seed=dropout_seed, offset=offs,
            pos_base=(0, 0, b, 0), num_heads_total=Hq, upcast=upcast,
            einsum=einsum)
        out[q0:q0 + slq] = o[0]
        lse[:, q0:q0 + slq] = l[0]
    return out, lse


flash_attn_varlen_fwd_ref.calls = 0


# ------------------------------------------------------ K6, K7 backward

def varlen_delta(out, dout, dlse=None) -> torch.Tensor:
    """delta (Hq, Tq) fp32 = rowsum(O * dO) - dlse."""
    delta = row_dot(out, dout).t()
    if dlse is not None:
        delta = delta - dlse.to(torch.float32)
    return delta.contiguous()


def _launch_bwd(fn_names: Tuple[str, str], q, k, v, dout, lse, delta,
                slopes, dq, dk, dv, cu_q, cu_k, used, lp, max_seqlen_q,
                max_seqlen_k, softmax_scale, params, dropout_p,
                dropout_seed) -> None:
    """`fn_names`: the 16-bit entry point and its fp32 twin."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn_names[0]} launches on CUDA tensors only; "
                         "flash_attn_varlen_bwd takes the plain version for "
                         "CPU tensors")
    Tq, Hq, D = q.shape
    f32 = q.dtype == torch.float32
    lib = build.load("bwd_f32") if f32 else build.load("bwd")
    rc = getattr(lib, fn_names[f32])(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(slopes),
        _ptr(dq), _ptr(dk), _ptr(dv), cu_q.data_ptr(), cu_k.data_ptr(),
        _ptr(used), _ptr(lp), cu_q.shape[0] - 1, Tq, int(max_seqlen_q),
        int(max_seqlen_k), Hq, k.shape[1], D, float(softmax_scale),
        *c_mask_args(params),
        *c_dropout_args(dropout_p, dropout_seed, None, Hq)[:5],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, fn_names[0])


def varlen_dq_kernel(q, k, v, dout, lse, delta, slopes, cu_q, cu_k, used,
                     lp, max_seqlen_q, max_seqlen_k, softmax_scale, params,
                     dropout_p, dropout_seed):
    """K6 on contiguous CUDA tensors at a kernel head dim and int32
    bookkeeping on the device -> dq (rows past cu_q[B] are 0)."""
    dq = torch.zeros_like(q)
    _launch_bwd(("fa_varlen_dq_launch", "fa_varlen_dq_f32_launch"), q, k, v,
                dout, lse, delta, slopes, dq, None, None, cu_q, cu_k, used, lp, max_seqlen_q, max_seqlen_k,
                softmax_scale, params, dropout_p, dropout_seed)
    varlen_dq_kernel.launches += 1
    return dq


varlen_dq_kernel.launches = 0


def varlen_dkv_kernel(q, k, v, dout, lse, delta, slopes, cu_q, cu_k, used,
                      lp, max_seqlen_q, max_seqlen_k, softmax_scale, params,
                      dropout_p, dropout_seed):
    """K7 on contiguous CUDA tensors at a kernel head dim and int32
    bookkeeping on the device -> (dk, dv) (keys no sequence uses are 0)."""
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    _launch_bwd(("fa_varlen_dkv_launch", "fa_varlen_dkv_f32_launch"), q, k,
                v, dout, lse, delta, slopes, None, dk, dv, cu_q, cu_k, used, lp, max_seqlen_q,
                max_seqlen_k, softmax_scale, params, dropout_p, dropout_seed)
    varlen_dkv_kernel.launches += 1
    return dk, dv


varlen_dkv_kernel.launches = 0


def flash_attn_varlen_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_k: torch.Tensor,
    max_seqlen_q: int,
    max_seqlen_k: int,
    softmax_scale: float,
    params: masklib.MaskParams,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
    seqused_k: Optional[torch.Tensor] = None,
    leftpad_k: Optional[torch.Tensor] = None,
    dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 and K7; see the module docstring.  delta = rowsum(O dO) - dlse
    (Hq, Tq) is computed here in plain torch and the LSE clamped to
    NEG_INF, as flash_attn_dense_bwd does.  CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return flash_attn_varlen_bwd_ref(
            q, k, v, out, dout, lse, cu_seqlens_q, cu_seqlens_k,
            max_seqlen_q, max_seqlen_k, softmax_scale, params,
            alibi_slopes=alibi_slopes, dropout_p=dropout_p,
            dropout_seed=dropout_seed, seqused_k=seqused_k,
            leftpad_k=leftpad_k, dlse=dlse)

    _check_packed_inputs(q, k, v, "flash_attn_varlen_bwd")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dout must match q in shape and dtype")
    Tq, Hq, D = q.shape
    B = cu_seqlens_q.shape[0] - 1
    ragged = _ragged_device_args(cu_seqlens_q, cu_seqlens_k, seqused_k,
                                 leftpad_k, B, q.device)
    delta = varlen_delta(out, dout, dlse)
    lse = lse.to(torch.float32).clamp_min(NEG_INF).contiguous()
    Dk = kernel_head_dim(D)
    q, k, v, dout = (pad_head_dim(t, Dk).contiguous()
                     for t in (q, k, v, dout))
    slopes = (slopes_bh(alibi_slopes, B, Hq, q.device) if params.has_alibi
              else None)
    args = (q, k, v, dout, lse, delta, slopes, *ragged, max_seqlen_q,
            max_seqlen_k, softmax_scale, params, dropout_p, dropout_seed)
    dq = varlen_dq_kernel(*args)
    dk, dv = varlen_dkv_kernel(*args)
    if Dk != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def flash_attn_varlen_bwd_ref(
    q, k, v, out, dout, lse, cu_seqlens_q, cu_seqlens_k, max_seqlen_q: int,
    max_seqlen_k: int, softmax_scale: float, params: masklib.MaskParams,
    alibi_slopes=None, dropout_p: float = 0.0, dropout_seed=None,
    seqused_k=None, leftpad_k=None, dlse=None, upcast: bool = True,
    einsum=torch.einsum,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6 and K7, one sequence at a time through
    the dense plain version (the kernels' rounding points).
    `upcast=False` keeps the products in q's dtype; `einsum` computes all
    five (ops/cuda/tf32.py passes its split products)."""
    flash_attn_varlen_bwd_ref.calls += 1
    Hq = q.shape[1]
    B = cu_seqlens_q.shape[0] - 1
    slopes = (slopes_bh(alibi_slopes, B, Hq, q.device) if params.has_alibi
              else None)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for b, (q0, slq, k0, slk, offs) in enumerate(seq_bounds(
            cu_seqlens_q, cu_seqlens_k, seqused_k, leftpad_k)):
        if slq <= 0 or slk <= 0:
            continue
        sq, sk = slice(q0, q0 + slq), slice(k0, k0 + slk)
        g = flash_attn_dense_bwd_ref(
            q[None, sq], k[None, sk], v[None, sk], out[None, sq],
            dout[None, sq], lse[None, :, sq], softmax_scale, params,
            alibi_slopes=None if slopes is None else slopes[b:b + 1],
            dropout_p=dropout_p, dropout_seed=dropout_seed,
            dlse=None if dlse is None else dlse[None, :, sq], offset=offs,
            pos_base=(0, 0, b, 0), num_heads_total=Hq, upcast=upcast,
            einsum=einsum)
        dq[sq], dk[sk], dv[sk] = g[0][0], g[1][0], g[2][0]
    return dq, dk, dv


flash_attn_varlen_bwd_ref.calls = 0


# ------------------------------------------------------- K8 paged forward


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
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """See the module docstring.  CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attn_varlen_fwd_paged_ref(
            q, k_pool, v_pool, block_table, cu_seqlens_q, seqlens_k,
            max_seqlen_q, max_seqlen_k, softmax_scale, params,
            alibi_slopes=alibi_slopes, seqused_k=seqused_k,
            leftpad_k=leftpad_k, k_scales=k_scales, v_scales=v_scales,
            p_tile=P_TILE)
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"varlen kernel takes bf16/fp16/fp32 q, got {q.dtype}")
    kind = None
    if k_scales is None:
        if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise TypeError("q and the page pools must share one dtype")
    else:
        kind = _check_quant(k_pool, v_pool, k_scales, v_scales,
                            paged_quant_kind(k_pool, k_scales) == "int4")
        if k_scales.shape != (*k_pool.shape[:2], k_scales.shape[2], 1):
            raise ValueError(f"scales {tuple(k_scales.shape)} do not match "
                             f"the pools {tuple(k_pool.shape)}")
    Tq, Hq, D = q.shape
    Hk, P, rows, Dk = k_pool.shape
    ps = rows if kind is None else k_scales.shape[2]
    dev = q.device
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
    if any(s * k_pool.element_size() % 16 for s in k_pool.stride()[:-1]) or \
            any(t.data_ptr() % 16 for t in (k_pool, v_pool)):
        raise ValueError("pool strides must be multiples of 16 bytes and "
                         "the pools 16-byte aligned (16-byte loads)")
    B = cu_seqlens_q.shape[0] - 1
    mp = _cdiv(max_seqlen_k, ps)
    if block_table.shape[0] < B or block_table.shape[1] < mp:
        raise ValueError(f"block_table {tuple(block_table.shape)} must cover "
                         f"{B} sequences x {mp} pages")
    for t in (k_pool, v_pool, k_scales, v_scales, block_table, cu_seqlens_q,
              seqlens_k):
        if t is not None and t.device != dev:
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
    # packed rows past cu_q[B] belong to no block: O = 0, LSE = -inf
    out = torch.zeros_like(q)
    lse = torch.full((Hq, Tq), float("-inf"), dtype=torch.float32,
                     device=dev)
    head = (tbl.data_ptr(), tbl.shape[1], cu_q.data_ptr(), lens.data_ptr(),
            _ptr(used), _ptr(lp), _ptr(slopes), out.data_ptr(),
            lse.data_ptr(), *k_pool.stride()[:3])
    mask = (int(params.causal), int(params.window_left),
            int(params.window_right), float(params.softcap),
            int(params.has_alibi), torch.cuda.current_stream(dev).cuda_stream)
    dims = (B, Tq, Hq, Hk, D, ps, mp, int(max_seqlen_q))
    if kind is None:
        launch = (build.load("fwd_f32").fa_varlen_paged_f32_launch
                  if q.dtype == torch.float32
                  else build.load("varlen_paged").fa_varlen_paged_launch)
        rc = launch(
            DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), *head, *dims, float(softmax_scale), *mask)
        build.check(rc, "flash_attn_varlen_fwd_paged")
        flash_attn_varlen_fwd_paged.launches += 1
    else:
        exp2, _, slope_mult = _exp2_domain(softmax_scale, params)
        rc = build.load("varlen_paged_quant").fa_varlen_paged_quant_launch(
            KIND_CODE[kind], DTYPE_CODE[q.dtype], q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), *head, *k_scales.stride()[:3], *dims,
            float(softmax_scale), float(slope_mult), int(exp2), *mask)
        build.check(rc, "flash_attn_varlen_fwd_paged (quantized)")
        flash_attn_varlen_fwd_paged.quant_launches[kind] += 1
    return out, lse


flash_attn_varlen_fwd_paged.launches = 0
# K8q launches, per payload kind
flash_attn_varlen_fwd_paged.quant_launches = {k: 0 for k in KIND_CODE}


def paged_quant_kind(k_pool, k_scales) -> str:
    """int8 / fp8 / int4 of a quantized pool, detected as JAX detects it:
    fp8 by dtype, int4 by scales holding twice the pool's rows a page."""
    rows, ps = k_pool.shape[2], k_scales.shape[2]
    if k_pool.dtype == FP8:
        kind = "fp8"
    elif k_pool.dtype == torch.int8:
        kind = "int4" if ps == 2 * rows else "int8"
    else:
        raise ValueError("quantized paged varlen supports int8/int4/fp8 "
                         f"pools (got {k_pool.dtype})")
    if ps != (2 * rows if kind == "int4" else rows):
        raise ValueError(f"scales hold {ps} rows a page, the pool {rows}")
    return kind


def _exp2_domain(softmax_scale: float, params: masklib.MaskParams):
    """K8q's softmax domain, the TPU kernel's: base 2 (scores times
    log2(e), exp2) unless softcap's tanh needs the natural scale.  Returns
    (use exp2, score scale, ALiBi slope multiplier)."""
    if params.softcap == 0.0:
        return True, softmax_scale * LOG2E, LOG2E
    return False, softmax_scale, 1.0


def _paged_quant_ref(q, k_pool, v_pool, k_scales, v_scales, tbl, b, mp,
                     lp, slk, slq, q0, eff, softmax_scale, slopes, p_tile,
                     round_p):
    """One sequence of K8q's arithmetic (module docstring) over the
    sequence's mp * ps cache rows: P's int8 scale per p_tile rows of them
    and the online softmax's running max per group, as the kernels take
    it.  Returns (out (slq, Hq, D) fp32, lse (Hq, slq))."""
    Hq, D = q.shape[1], q.shape[2]
    Hk = k_pool.shape[0]
    ps = k_scales.shape[2]
    kind = paged_quant_kind(k_pool, k_scales)
    group = Hq // Hk
    dev = q.device
    N = mp * ps
    G = p_tile or ps
    pages = tbl[b, :mp]

    def gather(pool):                      # (Hk, P, rows, W) -> (Hk, mp, rows, W)
        return payload_bytes(pool)[:, pages].view(pool.dtype)

    def kv(pool):
        vals = quant_payload_values(gather(pool), kind).reshape(Hk, N, D)
        return vals.repeat_interleave(group, dim=0)           # (Hq, N, D)

    k, v = kv(k_pool), kv(v_pool)
    ks = gather(k_scales).reshape(Hk, N).repeat_interleave(group, dim=0)
    vs = gather(v_scales).reshape(Hk, N).repeat_interleave(group, dim=0)
    q32 = q[q0:q0 + slq].transpose(0, 1).to(torch.float32)    # (Hq, slq, D)
    if kind == "fp8":
        s = torch.einsum("hqd,hkd->hqk", q32, k) * ks[:, None]
    else:
        q8, q_scale = _quantize_rows(q32)
        s = _int_matmul(q8, k, "hqd,hkd->hqk") * q_scale * ks[:, None]
    exp2, scale, slope_mult = _exp2_domain(softmax_scale, eff)
    qp = torch.arange(slq, device=dev).view(1, slq, 1)
    raw = torch.arange(N, device=dev).view(1, 1, N)
    rel = raw - lp                         # leftpad-relative key position
    offs = slk - slq
    valid = ((rel >= 0) & (rel < slk)
             & masklib.position_mask(qp, rel, offset=offs, params=eff))
    slope = None if slopes is None else (
        slopes[b].view(Hq, 1, 1) * torch.tensor(slope_mult,
                                                dtype=torch.float32))
    s = masklib.apply_score_pipeline(s, qp, rel, softmax_scale=scale,
                                     offset=offs, params=eff, valid=valid,
                                     alibi_slope=slope)
    ex = torch.exp2 if exp2 else torch.exp
    shape = (Hq, slq, N // G, G)
    s = s.reshape(shape)
    valid = valid.expand(Hq, slq, N).reshape(shape)
    m_run = torch.cummax(s.amax(dim=-1), dim=-1).values     # (Hq, slq, ng)
    p = torch.where(valid, ex(s - m_run[..., None]), torch.zeros_like(s))
    m = m_run[..., -1:]
    w = ex(m_run - m)
    l = (p.sum(dim=-1) * w).sum(dim=-1)                     # (Hq, slq)
    pv = p * vs.reshape(Hq, 1, N // G, G)
    vg = v.reshape(Hq, N // G, G, D)
    if kind == "fp8":
        if round_p:
            pv = pv.to(torch.bfloat16).to(torch.float32)
        o = torch.einsum("hqgn,hgnd->hqgd", pv, vg)
    elif round_p:
        p8, p_scale = _quantize_rows(pv)
        o = _int_matmul(p8, vg, "hqgn,hgnd->hqgd") * p_scale
    else:
        o = _int_matmul(pv, vg, "hqgn,hgnd->hqgd")
    o = (o * w[..., None]).sum(dim=-2)                      # (Hq, slq, D)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.where(l[..., None] == 0, torch.zeros_like(o), o / safe[..., None])
    m_nat = m[..., 0] * (math.log(2.0) if exp2 else 1.0)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m_nat + torch.log(safe))
    return o.transpose(0, 1), lse


@build.counted
def flash_attn_varlen_fwd_paged_ref(
    q, k_pool, v_pool, block_table, cu_seqlens_q, seqlens_k,
    max_seqlen_q: int, max_seqlen_k: int, softmax_scale: float,
    params: masklib.MaskParams, alibi_slopes=None, seqused_k=None,
    leftpad_k=None, upcast: bool = True, k_scales=None, v_scales=None,
    p_tile: Optional[int] = P_TILE, round_p: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, one sequence at a time.
    `upcast=False` keeps both products in q's dtype.  With `k_scales` the
    quantized arithmetic of K8q, P's int8 scale per `p_tile` cache rows
    (None: per page, the TPU kernel's grouping at kv_unroll 1);
    `round_p=False` skips P's int8 (fp8: bf16) rounding, the yardstick for
    the kernel's rounding of P.  `upcast` does not apply to quantized
    pools."""
    Tq, Hq, D = q.shape
    Hk = k_pool.shape[0]
    ps = (k_pool if k_scales is None else k_scales).shape[2]
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
        if k_scales is not None:
            o, l = _paged_quant_ref(q, k_pool, v_pool, k_scales, v_scales,
                                    tbl, b, mp, lp, slk, slq, q0, eff,
                                    softmax_scale, slopes, p_tile, round_p)
            out[q0:q0 + slq] = o.to(q.dtype)
            lse[:, q0:q0 + slq] = l
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
