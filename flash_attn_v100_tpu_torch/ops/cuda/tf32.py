"""A plain model of the fp32 kernels' 3 x TF32 split products, for tests.

The fp32 bodies of K1 (with K5, K8; `csrc/fwd_f32.cu`) and K3 (with K7;
`csrc/bwd_f32.cu`) run each product on the tensor cores as three TF32
products of split operands (`csrc/f32_tiles.cuh`): x = hi + lo with hi = x
rounded to TF32 (10 mantissa bits, round to nearest, ties away from zero:
`cvt.rna.tf32.f32`) and lo = x - hi, and

    A B = A_lo B_hi + A_hi B_lo + A_hi B_hi      (A_lo B_lo dropped).

This module computes the same products on the CPU in fp32, so that the
error of the split can be held against the reference before and apart from
the card: the plain twins of K1 and K2 / K3 (`fwd.flash_attn_dense_fwd_ref`,
`bwd.flash_attn_dense_bwd_ref`) and of K5 and K6 / K7 (`varlen.
flash_attn_varlen_fwd_ref`, `varlen.flash_attn_varlen_bwd_ref`) take
`einsum=einsum_3xtf32`.

The tensor cores add each product into the fp32 accumulator by truncation
(round toward zero), so an accumulator that lives across a long loop (K2's
dQ over every key of a row) drifts towards zero.  `add_rz` models that
addition and `matmul_3xtf32_chain` a product accumulated as a kernel
accumulates it: k-steps of 8, three split products each added by
truncation, `flush` k-steps at a time into a zeroed fragment that is then
added to the result in fp32 (f32_tiles.cuh `flush`), or one chain.
Nothing on the main path calls this module.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_DROPPED = 13                    # fp32's 23 mantissa bits less TF32's 10
_HALF = 1 << (_DROPPED - 1)
_KEEP = ~((1 << _DROPPED) - 1)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 `x` rounded to TF32 (cvt.rna: to nearest, ties away from
    zero): the low 13 bits of each word zero.  inf and NaN pass as they
    are."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    # the sign is bit 31 and the magnitude below it, so adding half of
    # the dropped bits' unit rounds the magnitude half away from zero
    r = ((bits + _HALF) & _KEEP).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = round_tf32(x), lo = round_tf32(x - hi); x - hi is
    exact in fp32, so hi + lo is x to 2**-22 of |x|."""
    hi = round_tf32(x)
    return hi, round_tf32(x.to(torch.float32) - hi)


def einsum_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum(eq, a, b) as the kernels' split products: the two small
    terms, then the large one, each an fp32 product of TF32 operands."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    small = torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
    return small + torch.einsum(eq, a_hi, b_hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D or batched) as 3 x TF32 split products in fp32."""
    return einsum_3xtf32("...ik,...kj->...ij", a, b)


def einsum_tf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product (both operands rounded once): the single product the
    split replaces, for comparison."""
    return torch.einsum(eq, round_tf32(a), round_tf32(b))


def add_rz(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """acc + x in fp32 rounded toward zero: the sum rounded to nearest,
    moved one unit towards zero where it was rounded away from it (the sign
    of TwoSum's exact error against the sum's)."""
    s = acc + x
    bb = s - acc
    err = (acc - (s - bb)) + (x - bb)
    away = (err != 0) & ((err > 0) != (s > 0))
    return torch.where(away, torch.nextafter(s, torch.zeros_like(s)), s)


def matmul_3xtf32_chain(a: torch.Tensor, b: torch.Tensor, k_step: int = 8,
                        flush: Optional[int] = 2) -> torch.Tensor:
    """a @ b ((..., M, K) x (K, N) or (..., K, N)) as the kernels
    accumulate it: per k-step of `k_step`, the split's three products (each
    an fp32 product of TF32 operands) added to a fragment by truncation;
    every `flush` k-steps the fragment is added to the result in fp32 and
    zeroed.  `flush=None` is one chain of truncating additions."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    K = a.shape[-1]
    t = torch.zeros(torch.broadcast_shapes(a.shape[:-1] + (1,),
                                           b.shape[:-2] + (1, 1))[:-1]
                    + (b.shape[-1],), dtype=torch.float32)
    acc = torch.zeros_like(t)
    for i, k0 in enumerate(range(0, K, k_step)):
        ks = slice(k0, k0 + k_step)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            t = add_rz(t, x[..., ks] @ y[..., ks, :])
        if flush is not None and (i + 1) % flush == 0:
            acc = acc + t
            t = torch.zeros_like(t)
    return acc + t
