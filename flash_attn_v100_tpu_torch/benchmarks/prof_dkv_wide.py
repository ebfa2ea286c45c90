"""K3 (dK, dV) with a wider q step or a larger key block: the counterpart of
the JAX repository's `benchmarks/prof_dkv_wide.py` on the card.

The JAX script widens its dKV kernel's q tile (one q / dO / lse / delta
stream at double width, one wide S^T product, K / V resident) and sweeps
the dKV tile shapes at the canonical 4k shape, reporting the forward +
backward rate.  Here: K1, K2 and K3 of the loss (o * do).sum() at B 4 x
4096, 32/8 heads x 128, bf16, causal, chained `--chain` times consuming
dq, dk and dv; the shipped K3 (64 keys x 32 q rows a step), then K3's
build variants (benchmarks/variants.py DKV): 64 q rows a step (the wide q
step) and 128 keys a block (two warpgroups), K2 shipped.  TF/s are the JAX
line's, attention_flops(causal) x 3.5, against 989 TFLOP/s; rows in turns,
the median of `--rounds`, as a call and as a CUDA-graph replay's device
time.  Each variant's gradients are held to the plain twin at the gradient
gate (a K3 tile sums dK / dV over q in another order), its registers,
spills and shared memory printed.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_dkv_wide
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from flash_attn_v100_tpu_torch.benchmarks.common import run_sweep, sweep_card
from flash_attn_v100_tpu_torch.benchmarks.prof_bwd import (
    DenseGrad, add_shape_flags)


def parser() -> argparse.ArgumentParser:
    """The script's flags: the JAX script's fixed values, --device and
    --rounds."""
    ap = argparse.ArgumentParser()
    add_shape_flags(ap, chain=4, iters=3)
    ap.add_argument("--dkv-tiles", nargs="*", default=["bq64", "keys128"],
                    help="K3's tile variants (benchmarks/variants.py DKV)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    dev, _ = sweep_card(args.device)
    case = DenseGrad(args, dev)
    res = {}
    for causal in (True,):
        rows = [case.row(f"causal={causal} dkv=(  64,  32) shipped", causal,
                         3.5)]
        rows += [case.row(f"causal={causal} dkv {n}", causal, 3.5, dkv=n)
                 for n in args.dkv_tiles]
        res.update(run_sweep(rows, dev, args.chain, args.rounds, args.iters))
    return res


if __name__ == "__main__":
    main()
