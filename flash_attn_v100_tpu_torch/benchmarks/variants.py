"""The kernel variants of the tile and unroll sweeps, on the card.

Each is a build variant of a shipped kernel (K1, K5, K8, K2, K3, K4q, K4),
compiled into its source's sweep library (`ops/cuda/build.py` VARIANTS,
`-DFA_SWEEP=1`) at bf16, head_dim 128 (K4's at 256), without bias or
dropout, and
launched here with the shipped entry's arguments after the variant's id.
Only the sweep scripts (`benchmarks/prof_*`), `chip_smoke.py` and the tests
call these: no wrapper of the main path (`flash_attn_func`,
`flash_attn_varlen_func`, `flash_attn_with_kvcache`, the model, the engine)
reaches a variant, and no variant is any kernel's default.

The counterparts of the JAX scripts' TPU knobs: `block_sizes` (tile
shapes), `kv_unroll` (U key tiles a step under one online softmax), the
monkeypatched all-fast-path "ceiling" (every tile unmasked) and the int4
decode's patched tiles (parts of the nibble chain taken out).  The rows
marked timing-only compute a wrong function on purpose; every other variant
computes the shipped kernel's function and is held to its plain twin at the
shipped kernel's gate.

Each launcher takes CUDA tensors only (the variants have no plain version
of their own: their function is the shipped kernel's) and raises on CPU
tensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from flash_attn_v100_tpu_torch.config import NEG_INF
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import build
from flash_attn_v100_tpu_torch.ops.cuda.bwd import softmax_delta
from flash_attn_v100_tpu_torch.ops.cuda.decode import (
    KIND_CODE, _counters, _i32, block_rows, resolve_num_splits)
from flash_attn_v100_tpu_torch.ops.cuda.fwd import (
    c_dropout_args, c_mask_args)

# variant name -> id in its sweep library's entry (the C sources' tables:
# csrc/fwd.cu sweep_variant, csrc/varlen_paged.cu, csrc/bwd.cu and
# csrc/decode_quant.cu find_variant / find_ablation)
FWD = {"bk128": 1, "bq64": 2, "unmasked": 3, "u2": 4, "u4": 5,
       "pingpong": 6, "pingpong-bk128": 7}          # K1 and K5
PAGED = {"u2": 1, "u4": 2, "u8": 3}                  # K8
DQ = {"bk64": 1}                                     # K2
DKV = {"bq64": 1, "keys128": 2}                      # K3
INT4 = {"full-qk": 1, "qk-one": 2, "no-and": 3}      # K4q over int4 pools
K4 = {"copies": 4}                                   # K4 at D 256
# kernel -> its variants, the library they are built into
TABLES = {"K1": (FWD, "fwd"), "K5": (FWD, "fwd"), "K8": (PAGED, "varlen_paged"),
          "K2": (DQ, "bwd"), "K3": (DKV, "bwd"), "K4q": (INT4, "decode_quant"),
          "K4": (K4, "decode")}
# the tile (q rows x keys a step) and what each variant changes
WHAT = {
    ("K1", "bk128"): "128 x 128, one S product a step",
    ("K1", "bq64"): "64 x 64, one warpgroup a block",
    ("K1", "unmasked"): "128 x 64, every tile unmasked",
    ("K1", "u2"): "128 x (2 x 64): two S products, one online softmax",
    ("K1", "u4"): "128 x (4 x 32): four S products, one online softmax",
    ("K1", "pingpong"): "128 x 64, the warpgroups' products in turns",
    ("K1", "pingpong-bk128"): "128 x 128, the warpgroups' products in turns",
    ("K8", "u2"): "128 x (2 x 64)", ("K8", "u4"): "128 x (4 x 32)",
    ("K8", "u8"): "128 x (8 x 16)",
    ("K2", "bk64"): "64 q rows x 64 keys a step (shipped 64 x 32)",
    ("K3", "bq64"): "64 keys x 64 q rows a step (shipped 64 x 32)",
    ("K3", "keys128"): "128 keys (two warpgroups) x 32 q rows a step",
    ("K4q", "full-qk"): "production S; P V over one nibble half",
    ("K4q", "qk-one"): "one K half's S, duplicated; P V halved",
    ("K4q", "no-and"): "packed bytes read as int8, no unpacking",
    ("K4", "copies"): "the ring alone: copies and barriers, no products",
}
WHAT.update({("K5", v): w for (k, v), w in list(WHAT.items()) if k == "K1"})
# variants whose numbers are wrong on purpose: timing only, never gated
TIMING_ONLY = {("K1", "unmasked"), ("K5", "unmasked"),
               *(("K4q", v) for v in INT4), ("K4", "copies")}
_BF16 = 0   # the entries' dtype code


def timing_only(kernel: str, variant: str) -> bool:
    return (kernel, variant) in TIMING_ONLY


def _id(kernel: str, variant: str) -> int:
    table = TABLES[kernel][0]
    if variant not in table:
        raise ValueError(f"{kernel} has no variant {variant!r} "
                         f"(one of {sorted(table)})")
    return table[variant]


def _lib(kernel: str):
    return build.load(TABLES[kernel][1], "sweep")


def _check(kernel: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"the {kernel} variants launch on CUDA tensors "
                             "only")
        if t.dtype != torch.bfloat16 or t.shape[-1] != 128:
            raise ValueError(f"the {kernel} variants take bf16 at "
                             f"head_dim 128, got {t.dtype} x {t.shape[-1]}")


def _done(rc: int, kernel: str, variant: str) -> None:
    build.check(rc, f"{kernel} variant {variant}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _params(causal: bool) -> masklib.MaskParams:
    return masklib.MaskParams(causal=causal)


def dense_fwd(q, k, v, causal: bool, variant: str,
              softmax_scale: Optional[float] = None):
    """K1's variant on q (B, M, Hq, 128), k/v (B, N, Hk, 128) -> (out,
    lse (B, Hq, M)), as flash_attn_dense_fwd."""
    _check("K1", q, k, v)
    q, k, v = (t.contiguous() for t in (q, k, v))
    B, M, Hq, D = q.shape
    N, Hk = k.shape[1], k.shape[2]
    scale = D ** -0.5 if softmax_scale is None else softmax_scale
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, M), dtype=torch.float32, device=q.device)
    rc = _lib("K1").fa_fwd_sweep_launch(
        _id("K1", variant), _BF16, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None, out.data_ptr(), lse.data_ptr(), B, M, N, Hq, Hk, D, D, N - M,
        float(scale), *c_mask_args(_params(causal)),
        *c_dropout_args(0.0, None, None, Hq), _stream(q.device))
    _done(rc, "K1", variant)
    return out, lse


def varlen_fwd(q, k, v, cu_seqlens, max_seqlen: int, causal: bool,
               variant: str, softmax_scale: Optional[float] = None):
    """K5's variant on packed q (T, Hq, 128), k/v (T, Hk, 128) split by one
    cu_seqlens (self-attention) -> (out, lse (Hq, T)), as
    flash_attn_varlen_fwd."""
    _check("K5", q, k, v)
    q, k, v = (t.contiguous() for t in (q, k, v))
    Tq, Hq, D = q.shape
    Hk = k.shape[1]
    B = cu_seqlens.shape[0] - 1
    cu = cu_seqlens.to(torch.int32).contiguous()
    scale = D ** -0.5 if softmax_scale is None else softmax_scale
    out = torch.zeros_like(q)
    lse = torch.full((Hq, Tq), float("-inf"), dtype=torch.float32,
                     device=q.device)
    rc = _lib("K5").fa_varlen_fwd_sweep_launch(
        _id("K5", variant), _BF16, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cu.data_ptr(), cu.data_ptr(), None, None, None, out.data_ptr(),
        lse.data_ptr(), B, Tq, int(max_seqlen), Hq, Hk, D, D, float(scale),
        *c_mask_args(_params(causal)), *c_dropout_args(0.0, None, None, Hq),
        _stream(q.device))
    _done(rc, "K5", variant)
    return out, lse


def paged_fwd(q, k_pool, v_pool, block_table, cu_seqlens_q, seqlens_k,
              max_seqlen_q: int, max_seqlen_k: int, causal: bool,
              variant: str, softmax_scale: Optional[float] = None):
    """K8's variant on packed q (Tq, Hq, 128) against pools (Hk, P, ps, 128)
    through a block table -> (out, lse (Hq, Tq)), as
    flash_attn_varlen_fwd_paged; ps a multiple of 128."""
    _check("K8", q, k_pool, v_pool)
    q = q.contiguous()
    Tq, Hq, D = q.shape
    Hk, _, ps, _ = k_pool.shape
    if ps % 128 or k_pool.stride() != v_pool.stride():
        raise ValueError("the K8 variants take pages of a multiple of 128 "
                         "rows and k/v pools of equal strides")
    B = cu_seqlens_q.shape[0] - 1
    mp = -(-int(max_seqlen_k) // ps)
    tbl = block_table.to(torch.int32).contiguous()
    cu = cu_seqlens_q.to(torch.int32).contiguous()
    lens = seqlens_k.to(torch.int32).contiguous()
    scale = D ** -0.5 if softmax_scale is None else softmax_scale
    out = torch.zeros_like(q)
    lse = torch.full((Hq, Tq), float("-inf"), dtype=torch.float32,
                     device=q.device)
    p = _params(causal)
    rc = _lib("K8").fa_varlen_paged_sweep_launch(
        _id("K8", variant), _BF16, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), tbl.data_ptr(), tbl.shape[1], cu.data_ptr(),
        lens.data_ptr(), None, None, None, out.data_ptr(), lse.data_ptr(),
        *k_pool.stride()[:3], B, Tq, Hq, Hk, D, ps, mp, int(max_seqlen_q),
        float(scale), int(p.causal), int(p.window_left),
        int(p.window_right), float(p.softcap), int(p.has_alibi),
        _stream(q.device))
    _done(rc, "K8", variant)
    return out, lse


def _bwd(kernel: str, entry: str, variant: str, q, k, v, dout, lse, delta,
         dq, dk, dv, causal: bool, scale: float) -> None:
    B, M, Hq, D = q.shape
    N, Hk = k.shape[1], k.shape[2]

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = getattr(_lib(kernel), entry)(
        _id(kernel, variant), _BF16, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None, ptr(dq), ptr(dk), ptr(dv), B, M, N, Hq, Hk, D, N - M,
        float(scale), *c_mask_args(_params(causal)),
        *c_dropout_args(0.0, None, None, Hq), _stream(q.device))
    _done(rc, kernel, variant)


def dq_only(q, k, v, dout, lse, delta, causal: bool, variant: str,
            softmax_scale: Optional[float] = None):
    """K2's variant alone on contiguous inputs, lse clamped and delta given
    (ops/cuda/bwd.py's dq_kernel arguments) -> dq."""
    _check("K2", q, k, v, dout)
    scale = q.shape[-1] ** -0.5 if softmax_scale is None else softmax_scale
    dq = torch.empty_like(q)
    _bwd("K2", "fa_dq_sweep_launch", variant, q, k, v, dout, lse, delta, dq,
         None, None, causal, scale)
    return dq


def dense_bwd(q, k, v, out, dout, lse, causal: bool,
              dq_variant: Optional[str] = None,
              dkv_variant: Optional[str] = None,
              softmax_scale: Optional[float] = None):
    """(dq, dk, dv) of K1's output as flash_attn_dense_bwd gives them, K2
    from `dq_variant` and K3 from `dkv_variant` (None: the shipped kernel,
    ops/cuda/bwd.py's dq_kernel / dkv_kernel)."""
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    _check("K2", q, k, v, dout)
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5 if softmax_scale is None else softmax_scale
    delta = softmax_delta(out, dout)
    lse = lse.to(torch.float32).clamp_min(NEG_INF).contiguous()
    N, M, Hq = k.shape[1], q.shape[1], q.shape[2]
    args = (q, k, v, dout, lse, delta, None, scale, _params(causal), 0.0,
            None, N - M, None, Hq)
    if dq_variant is None:
        dq = dbwd.dq_kernel(*args)
    else:
        dq = dq_only(q, k, v, dout, lse, delta, causal, dq_variant, scale)
    if dkv_variant is None:
        dk, dv = dbwd.dkv_kernel(*args)
    else:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        _bwd("K3", "fa_dkv_sweep_launch", dkv_variant, q, k, v, dout, lse,
             delta, None, dk, dv, causal, scale)
    return dq, dk, dv


def decode_int4(q_rows, k_pages, v_pages, k_scales, v_scales, block_table,
                cache_seqlens, variant: str, group: int,
                params: Optional[masklib.MaskParams] = None,
                num_splits: int = 0, softmax_scale: Optional[float] = None):
    """K4q's int4 ablation on GQA-folded q rows (B, Hk, Rq <= 16, 128) bf16
    over int4 pool views (C1, Hk, C2, ps / 2, 128) with scales (C1, Hk, C2,
    ps, 1) -> the merged o (B, Hk, Rq, 128), as
    paged_decode_attention_merged(int4=True) with `params` (default
    causal), one new token a row.  Timing only: its numbers are wrong on
    purpose."""
    _check("K4q", q_rows)
    if k_pages.dtype != torch.int8 or k_pages.stride() != v_pages.stride():
        raise ValueError("int4 pools are int8 bytes of equal strides")
    q_rows = q_rows.contiguous()
    B, Hk, Rq, D = q_rows.shape
    C2, ps = k_pages.shape[2], k_scales.shape[-2]
    dev = q_rows.device
    max_pages = block_table.shape[1]
    S = resolve_num_splits(num_splits, B, Hk, Rq, max_pages, dev)
    tbl, lens = _i32(block_table), _i32(cache_seqlens)
    o_part = lse_part = None
    if S > 1:
        o_part = torch.empty((B, Hk, S, Rq, D), dtype=torch.float32,
                             device=dev)
        lse_part = torch.empty((B, Hk, S, Rq, 1), dtype=torch.float32,
                               device=dev)
    o = torch.empty((B, Hk, Rq, D), dtype=q_rows.dtype, device=dev)
    lse = torch.empty((B, Hk, Rq, 1), dtype=torch.float32, device=dev)
    counters = _counters(dev, B * Hk * -(-Rq // block_rows(Rq)))
    scale = D ** -0.5 if softmax_scale is None else softmax_scale
    p = _params(True) if params is None else params

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = _lib("K4q").fa_decode_quant_sweep_launch(
        _id("K4q", variant), KIND_CODE["int4"], _BF16, q_rows.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
        v_scales.data_ptr(), tbl.data_ptr(), lens.data_ptr(), None, None,
        None, ptr(o_part), ptr(lse_part), o.data_ptr(), lse.data_ptr(),
        counters.data_ptr(), *k_pages.stride()[:4], *k_scales.stride()[:4],
        C2, B, Hk, Rq, D, S, max_pages, ps, -(-max_pages // S), 1, group,
        float(scale), int(p.causal), int(p.window_left), int(p.window_right),
        float(p.softcap), int(p.has_alibi), _stream(dev))
    _done(rc, "K4q", variant)
    return o


def decode_ablation(q_rows, k_pages, v_pages, block_table, cache_seqlens,
                    group: int, variant: str):
    """K4's ablation on GQA-folded q rows (B, Hk, Rq <= 16, 256) bf16 over
    16-bit pool views (C1, Hk, C2, ps, 256), the shipped launch's grid and
    auto split count, one new token a row (window_right 0).  "copies": the
    ring with no products; returns the partials (o_part, lse_part), timing
    only, its numbers wrong on purpose (O 0, LSE -inf)."""
    for t in (q_rows, k_pages, v_pages):
        if (t.device.type != "cuda" or t.dtype != torch.bfloat16
                or t.shape[-1] != 256):
            raise ValueError("the K4 ablations take CUDA bf16 at head_dim "
                             "256")
    if q_rows.shape[2] > 16 or k_pages.stride() != v_pages.stride():
        raise ValueError("the K4 ablations take Rq <= 16 and pools of "
                         "equal strides")
    vid = _id("K4", variant)
    q_rows = q_rows.contiguous()
    B, Hk, Rq, D = q_rows.shape
    C2, ps = k_pages.shape[2], k_pages.shape[3]
    dev = q_rows.device
    max_pages = block_table.shape[1]
    S = resolve_num_splits(0, B, Hk, Rq, max_pages, dev)
    tbl, lens = _i32(block_table), _i32(cache_seqlens)
    o_part = torch.empty((B, Hk, S, Rq, D), dtype=torch.float32, device=dev)
    lse_part = torch.empty((B, Hk, S, Rq, 1), dtype=torch.float32,
                           device=dev)
    p = masklib.MaskParams(window_right=0)   # one new token: causal
    rc = _lib("K4").fa_decode_sweep_launch(
        vid, _BF16, q_rows.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), tbl.data_ptr(), lens.data_ptr(), None, None,
        None, o_part.data_ptr(), lse_part.data_ptr(), None, None, None,
        *k_pages.stride()[:4], C2, B, Hk, Rq, D, S, max_pages, ps,
        -(-max_pages // S), 1, group, D ** -0.5, int(p.causal),
        int(p.window_left), int(p.window_right), float(p.softcap),
        int(p.has_alibi), _stream(dev))
    _done(rc, "K4", variant)
    return o_part, lse_part


def occupancy(kernel: str, variant: str) -> Dict[str, int]:
    """The variant's registers, local memory (spills and stack) and dynamic
    shared memory a block, threads a block and resident blocks a
    multiprocessor, from its library's occupancy entry."""
    import ctypes
    out = (ctypes.c_int * 5)()
    at = ctypes.addressof(out)
    lib, vid = _lib(kernel), _id(kernel, variant)
    if kernel in ("K1", "K5"):
        rc = lib.fa_fwd_sweep_occupancy(vid, int(kernel == "K5"), at)
    elif kernel == "K8":
        rc = lib.fa_varlen_paged_sweep_occupancy(vid, at)
    elif kernel in ("K2", "K3"):
        rc = lib.fa_bwd_sweep_occupancy(int(kernel == "K3"), vid, at)
    elif kernel == "K4":
        rc = lib.fa_decode_sweep_occupancy(vid, at)
    else:
        rc = lib.fa_decode_quant_sweep_occupancy(vid, at)
    build.check(rc, f"{kernel} {variant} occupancy")
    blocks, smem, threads, regs, local = out
    return dict(blocks=blocks, smem=smem, threads=threads, regs=regs,
                local=local)


def occupancy_text(occ: Dict[str, int]) -> str:
    """A variant line's registers, spills and shared memory."""
    return (f"regs {occ['regs']}, local {occ['local']} B, smem "
            f"{occ['smem'] // 1024} KB, {occ['threads']} threads, "
            f"{occ['blocks']} block(s)/SM")
