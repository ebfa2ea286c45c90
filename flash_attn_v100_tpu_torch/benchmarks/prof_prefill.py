"""Prefill tile sweep and the masked tiles' cost: the counterpart of the JAX
repository's `benchmarks/prof_prefill.py` on the card.

K1 (the dense forward) at the JAX shape, B 4 x 4096, 32/8 heads x 128,
bf16, causal and not, chained `--chain` times as the JAX scan chains it
(q <- q + 1e-6 o).  The JAX script sweeps the TPU kernel's `block_sizes`;
on the card a tile is a build variant of K1 (benchmarks/variants.py):
the shipped 128 q rows x 64 keys, then `--tiles` (default 128 x 128 and
64 x 64).  "causal CEILING" is the JAX script's all-fast-path probe: K1
with every tile unmasked, wrong numbers on purpose (timing only), so the
masked edge tiles' share of the causal time is shipped - ceiling.  Each
row's TF/s is over `attention_flops(..., causal)` (perfect causal
efficiency equals the non-causal rate), against 989 TFLOP/s; rows run in
turns, the median of `--rounds`, as a call with its host time and as a
CUDA-graph replay's device time.  Every same-function variant is held to
K1's plain twin at K1's gate; a variant row prints its registers, spills
and shared memory.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_prefill
        [causal] [full] [ceiling] [--tiles bk128 bq64] [--device cpu]

On the CPU (`--device cpu`) the shipped rows run K1's plain twin at the
shapes given; the variant rows print "needs the card".
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from flash_attn_v100_tpu_torch.benchmarks import variants as var
from flash_attn_v100_tpu_torch.benchmarks.common import (
    SweepRow, finite_text, gate_text, randn, run_sweep, sweep_card)
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.utils.benchmarking import attention_flops
from flash_attn_v100_tpu_torch.utils.testing import FWD_ATOL, FWD_MULT

SEED = 0


def k1_gate(q, k, v, causal: bool):
    """A check holding a K1 variant's (out, lse) to K1's plain twin at K1's
    gate; the twin is computed once for all the rows that use it."""
    params = masklib.MaskParams(causal=causal)
    scale = q.shape[-1] ** -0.5
    refs = {}

    def check(out_lse, name):
        if not refs:
            refs["32"] = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params)
            refs["16"] = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params,
                                                       upcast=False)
        return gate_text(out_lse[0], refs["32"][0], refs["16"][0], FWD_MULT,
                         FWD_ATOL, f"{name} out")
    return check


def parser() -> argparse.ArgumentParser:
    """The script's flags: the JAX script's fixed values, --device and
    --rounds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="*", default=["causal", "full", "ceiling"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seqlen", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--chain", type=int, default=4,
                    help="forward calls chained (the JAX scan's NCH)")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--tiles", nargs="*", default=["bk128", "bq64"],
                    help="K1's tile variants (benchmarks/variants.py FWD)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    dev, _ = sweep_card(args.device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, M, Hq, Hk, D = (args.batch, args.seqlen, args.heads, args.kv_heads,
                       args.head_dim)
    q, k, v = (randn(gen, s, dev)
               for s in ((B, M, Hq, D), (B, M, Hk, D), (B, M, Hk, D)))
    card = dev.type == "cuda"
    rows = []

    def shipped(causal):
        return lambda qi: flash_attn_func(qi, k, v, causal=causal)

    def variant(causal, name):
        return lambda qi: var.dense_fwd(qi, k, v, causal, name)[0]

    for causal in (True, False):
        tag = "causal" if causal else "full  "
        if tag.strip() not in args.which:
            continue
        fl = attention_flops(B, M, M, Hq, D, causal=causal)
        gate = k1_gate(q, k, v, causal)
        rows.append(SweepRow(
            f"{tag} shipped 128x64", shipped(causal), q, flops=fl,
            check=lambda c=causal, g=gate: g(
                (flash_attn_func(q, k, v, causal=c),), "K1")))
        for name in args.tiles:
            rows.append(SweepRow(
                f"{tag} {name:9s}", variant(causal, name) if card else None,
                q, flops=fl, kernel="K1", variant=name,
                check=lambda c=causal, n=name, g=gate: g(
                    var.dense_fwd(q, k, v, c, n), f"K1 {n}")))
    if "ceiling" in args.which:
        rows.append(SweepRow(
            "causal CEILING (every tile unmasked)",
            variant(True, "unmasked") if card else None, q,
            flops=attention_flops(B, M, M, Hq, D, causal=True), kernel="K1",
            variant="unmasked",
            check=lambda: finite_text(*var.dense_fwd(q, k, v, True,
                                                     "unmasked"))))
    return run_sweep(rows, dev, args.chain, args.rounds, args.iters)


if __name__ == "__main__":
    main()
