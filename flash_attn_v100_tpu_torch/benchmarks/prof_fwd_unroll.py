"""K1 with U key tiles a step: the counterpart of the JAX repository's
`benchmarks/prof_fwd_unroll.py` on the card.

The JAX script sets its dense forward's `kv_unroll` U (U key tiles a grid
step) at the 4k prefill shape.  On the card U is a build variant of K1
(benchmarks/variants.py FWD "u2", "u4"): U S products issued back to back,
one online softmax over their keys, U P V products; U 1 is the shipped
K1 (one 64-key tile a step).  U 2 steps over two 64-key sub-tiles; U 4
over four 32-key ones (four of 64 keys would need 2 x 128 KB of stages,
past the 227 KB a block may hold).  K1 at B 4 x 4096, 32/8 heads x 128,
bf16, causal and not, chained `--chain` times (q <- q + 1e-6 o); TF/s over
attention_flops(causal) against 989 TFLOP/s; rows in turns, the median of
`--rounds`, as a call and as a CUDA-graph replay's device time.  Each
variant is held to K1's plain twin at K1's gate, its registers, spills
and shared memory printed.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_fwd_unroll
        [--unroll 1 2 4] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from flash_attn_v100_tpu_torch.benchmarks import variants as var
from flash_attn_v100_tpu_torch.benchmarks.common import (
    SweepRow, randn, run_sweep, sweep_card)
from flash_attn_v100_tpu_torch.benchmarks.prof_prefill import k1_gate
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.utils.benchmarking import attention_flops

SEED = 0


def add_k1_flags(ap: argparse.ArgumentParser, chain: int, iters: int) -> None:
    """The K1 sweeps' shape, chain and timing flags (the JAX scripts' B, M,
    Hq, Hk, D, NCH and measure iters)."""
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seqlen", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--chain", type=int, default=chain,
                    help="forward calls chained (the JAX scan's NCH)")
    ap.add_argument("--iters", type=int, default=iters)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")


class DenseFwd:
    """q, k, v of the JAX shape drawn on the device and K1's rows: the
    shipped kernel and its variants, each held to the plain twin."""

    def __init__(self, args, dev):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        B, M, Hq, Hk, D = (args.batch, args.seqlen, args.heads,
                           args.kv_heads, args.head_dim)
        self.shape = (B, M, Hq, D)
        self.q, self.k, self.v = (
            randn(gen, s, dev)
            for s in ((B, M, Hq, D), (B, M, Hk, D), (B, M, Hk, D)))
        self.card = dev.type == "cuda"
        self._gates = {}

    def gate(self, causal: bool):
        if causal not in self._gates:
            self._gates[causal] = k1_gate(self.q, self.k, self.v, causal)
        return self._gates[causal]

    def row(self, name: str, causal: bool,
            variant: Optional[str] = None) -> SweepRow:
        B, M, Hq, D = self.shape
        q, k, v = self.q, self.k, self.v
        if variant is None:
            fn = lambda qi: flash_attn_func(qi, k, v, causal=causal)  # noqa
            check = lambda: self.gate(causal)(  # noqa: E731
                (flash_attn_func(q, k, v, causal=causal),), "K1")
        else:
            fn = ((lambda qi: var.dense_fwd(qi, k, v, causal, variant)[0])
                  if self.card else None)
            check = lambda: self.gate(causal)(  # noqa: E731
                var.dense_fwd(q, k, v, causal, variant), f"K1 {variant}")
        return SweepRow(name, fn, q,
                        flops=attention_flops(B, M, M, Hq, D, causal=causal),
                        kernel="K1" if variant else None, variant=variant,
                        check=check)


def parser() -> argparse.ArgumentParser:
    """The script's flags: the JAX script's fixed values, --device and
    --rounds."""
    ap = argparse.ArgumentParser()
    add_k1_flags(ap, chain=8, iters=3)
    ap.add_argument("--unroll", type=int, nargs="+", default=[1, 2, 4])
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    dev, _ = sweep_card(args.device)
    case = DenseFwd(args, dev)
    rows = [case.row(f"causal={causal} U={U}", causal,
                     None if U == 1 else f"u{U}")
            for causal in (True, False) for U in args.unroll]
    return run_sweep(rows, dev, args.chain, args.rounds, args.iters)


if __name__ == "__main__":
    main()
