"""K1 with its two warpgroups in ping-pong: the counterpart of the JAX
repository's `benchmarks/prof_fwd_pipeline.py` on the card.

The JAX script A/B-tests a software-pipelined dense forward (all S
products of a step issued before the softmax chain) against the per-tile
body.  Hopper's counterpart is FA3's ping-pong: K1's two consumer
warpgroups take turns to issue their products through two named barriers,
so one warpgroup's softmax runs while the other's products are on the
tensor cores (PR 14's schedule of csrc/probes.cu, here on K1's cp.async
ring; benchmarks/variants.py FWD "pingpong", "pingpong-bk128").  Rows: the
shipped K1, then the ping-pong at the shipped tile (128 x 64) and at 128
keys a step, at B 4 x 4096, 32/8 heads x 128, bf16, causal and not,
chained `--chain` times; TF/s over attention_flops(causal) against 989
TFLOP/s; rows in turns, the median of `--rounds`, as a call and as a
CUDA-graph replay's device time.  Each variant is held to K1's plain twin
at K1's gate, its registers, spills and shared memory printed.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_fwd_pipeline
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from flash_attn_v100_tpu_torch.benchmarks.common import run_sweep, sweep_card
from flash_attn_v100_tpu_torch.benchmarks.prof_fwd_unroll import (
    DenseFwd, add_k1_flags)


def parser() -> argparse.ArgumentParser:
    """The script's flags: the JAX script's fixed values, --device and
    --rounds."""
    ap = argparse.ArgumentParser()
    add_k1_flags(ap, chain=8, iters=3)
    ap.add_argument("--variants", nargs="*",
                    default=["pingpong", "pingpong-bk128"],
                    help="K1's schedule variants (benchmarks/variants.py)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    dev, _ = sweep_card(args.device)
    case = DenseFwd(args, dev)
    rows = []
    for causal in (True, False):
        rows.append(case.row(f"causal={causal} shipped (128,  64)", causal))
        rows += [case.row(f"causal={causal} {n}", causal, n)
                 for n in args.variants]
    return run_sweep(rows, dev, args.chain, args.rounds, args.iters)


if __name__ == "__main__":
    main()
