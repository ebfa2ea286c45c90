"""Varlen forward and backward rates: the counterpart of the JAX
repository's `benchmarks/prof_varlen.py` on the card.

K5 (the packed varlen forward) and its backward, K6 + K7 through
`flash_attn_varlen_func`'s autograd with the loss (o * do).sum() (the
forward runs in the timed call too, as in jax.grad), at the JAX shapes:
32/8 heads x 128, bf16, 8 x 2048 causal and full, and the mixed batch
[128, 512, 1024, 4096, 2048, 300, 37, 4096] causal, each chained
`--chain` times (q <- q + 1e-6 o; the backward by dq).  FLOPs are the JAX
script's, sum(4 Hq L^2 D / (2 if causal)), the backward's x 2.5, against
989 TFLOP/s.  `bs` adds K5's tile variants (the JAX script's block-size
rows; on the card build variants of K5, benchmarks/variants.py) on the
uniform and the mixed batch, each held to K5's plain twin at K5's gate;
`ceiling` adds K5 with every tile unmasked (the JAX all-fast-path probe;
wrong numbers on purpose, timing only).  Rows run in turns, the median of
`--rounds`, as a call and as a CUDA-graph replay's device time.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_varlen [bs]
        [ceiling] [--device cpu]

On the CPU the shipped rows run the plain twins; variant rows print
"needs the card".
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks import variants as var
from flash_attn_v100_tpu_torch.benchmarks.common import (
    SweepRow, finite_text, gate_text, randn, run_sweep, sweep_card)
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import varlen as dvl
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func
from flash_attn_v100_tpu_torch.utils.testing import FWD_ATOL, FWD_MULT

SEED = 0


def varlen_flops(lens, Hq: int, D: int, causal: bool) -> int:
    """The JAX script's count: sum(4 Hq L^2 D // (2 if causal else 1))."""
    return sum(4 * Hq * L * L * D // (2 if causal else 1) for L in lens)


class Packed:
    """One packed self-attention batch: q, k, v, do and cu_seqlens drawn on
    the device, and K5's plain twin (once) for the variants' gate."""

    def __init__(self, gen, lens, Hq: int, Hk: int, D: int, dev):
        T = sum(lens)
        self.lens, self.L = list(lens), max(lens)
        self.q, self.k, self.v, self.do = (
            randn(gen, s, dev)
            for s in ((T, Hq, D), (T, Hk, D), (T, Hk, D), (T, Hq, D)))
        self.cu = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])
                                   .astype(np.int32)).to(dev)
        self._refs = {}

    def fwd(self, causal: bool):
        return lambda qi: flash_attn_varlen_func(
            qi, self.k, self.v, self.cu, self.cu, self.L, self.L,
            causal=causal)

    def grad(self, causal: bool):
        """q -> dq of (o * do).sum() through the autograd of
        flash_attn_varlen_func (K5, then K6 and K7)."""
        def fn(qi):
            leaves = [x.detach().requires_grad_()
                      for x in (qi, self.k, self.v)]
            o = flash_attn_varlen_func(*leaves, self.cu, self.cu, self.L,
                                       self.L, causal=causal)
            return torch.autograd.grad((o * self.do).sum(), leaves)[0]
        return fn

    def variant(self, causal: bool, name: str):
        return lambda qi: var.varlen_fwd(qi, self.k, self.v, self.cu, self.L,
                                         causal, name)[0]

    def gate(self, causal: bool, name: str) -> str:
        if causal not in self._refs:
            args = (self.q, self.k, self.v, self.cu, self.cu, self.L, self.L,
                    self.q.shape[-1] ** -0.5,
                    masklib.MaskParams(causal=causal))
            self._refs[causal] = (dvl.flash_attn_varlen_fwd_ref(*args)[0],
                                  dvl.flash_attn_varlen_fwd_ref(
                                      *args, upcast=False)[0])
        out = (self.fwd(causal)(self.q) if name == "K5"
               else var.varlen_fwd(self.q, self.k, self.v, self.cu, self.L,
                                   causal, name)[0])
        return gate_text(out, *self._refs[causal], FWD_MULT, FWD_ATOL,
                         f"K5 {name} out" if name != "K5" else "K5 out")


def parser() -> argparse.ArgumentParser:
    """The script's flags: the JAX script's fixed values, --device and
    --rounds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("extra", nargs="*", default=[],
                    help="bs: K5's tile variants; ceiling: every tile "
                         "unmasked")
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--chain", type=int, default=4,
                    help="calls chained (the JAX scan's NCH)")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--uniform", type=int, nargs=2, default=[8, 2048],
                    metavar=("B", "L"), help="the uniform batch")
    ap.add_argument("--mixed", type=int, nargs="+",
                    default=[128, 512, 1024, 4096, 2048, 300, 37, 4096])
    ap.add_argument("--tiles", nargs="*", default=["bk128", "bq64"],
                    help="bs: K5's tile variants (benchmarks/variants.py)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    if set(args.extra) - {"bs", "ceiling"}:
        raise SystemExit(f"unknown extras {args.extra} (bs, ceiling)")
    dev, _ = sweep_card(args.device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Hq, Hk, D = args.heads, args.kv_heads, args.head_dim
    card = dev.type == "cuda"
    nb, L = args.uniform
    uni = Packed(gen, [L] * nb, Hq, Hk, D, dev)
    mixed = Packed(gen, args.mixed, Hq, Hk, D, dev)
    rows = []
    for pk, causal, tag in ((uni, True, f"{nb}x{L} causal"),
                            (uni, False, f"{nb}x{L} full  "),
                            (mixed, True, "mixed causal ")):
        fl = varlen_flops(pk.lens, Hq, D, causal)
        rows.append(SweepRow(f"{tag} fwd", pk.fwd(causal), pk.q, flops=fl,
                             check=lambda p=pk, c=causal: p.gate(c, "K5")))
        rows.append(SweepRow(f"{tag} bwd", pk.grad(causal), pk.q,
                             flops=int(fl * 2.5)))
    if "bs" in args.extra:
        for pk, tag in ((uni, f"{nb}x{L} causal"), (mixed, "mixed causal ")):
            fl = varlen_flops(pk.lens, Hq, D, True)
            for name in args.tiles:
                rows.append(SweepRow(
                    f"{tag} {name} fwd",
                    pk.variant(True, name) if card else None, pk.q, flops=fl,
                    kernel="K5", variant=name,
                    check=lambda p=pk, n=name: p.gate(True, n)))
    if "ceiling" in args.extra:
        rows.append(SweepRow(
            f"{nb}x{L} causal CEILING(all-fast) fwd",
            uni.variant(True, "unmasked") if card else None, uni.q,
            flops=varlen_flops(uni.lens, Hq, D, True), kernel="K5",
            variant="unmasked",
            check=lambda: finite_text(*var.varlen_fwd(
                uni.q, uni.k, uni.v, uni.cu, uni.L, True, "unmasked"))))
    return run_sweep(rows, dev, args.chain, args.rounds, args.iters)


if __name__ == "__main__":
    main()
