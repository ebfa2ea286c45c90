"""Calibrate the timing method against work of known size: the counterpart
of the JAX repository's `benchmarks/prof_calibrate.py` on the card.

A 2 GiB bf16 sum must stream 2 GiB from HBM, so its rate cannot pass the
H100 SXM's 3.35 TB/s; a 4096^3 bf16 matmul cannot pass its 989 TFLOP/s
dense bf16 tensor-core peak.  A timer that reads past either is broken:
fix it before trusting any kernel number.  Both run through the port's
`utils/benchmarking.measure` (CUDA events, queue delta), four rounds each.
No port kernel is on this path: the sum is a PyTorch reduction and the
matmul cuBLAS, the yardsticks of the JAX script.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_calibrate
        [--rounds 4] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    BF16_FLOPS_PER_S, HBM_BYTES_PER_S, backend, pct, randn)
from flash_attn_v100_tpu_torch.utils.benchmarking import gbps, measure, tflops

SEED = 0


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, default=1 << 30,
                    help="bf16 elements summed (2 GiB)")
    ap.add_argument("--matmul", type=int, default=4096,
                    help="n of the n^3 bf16 matmul")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # the bf16 array summed in fp32 without an fp32 copy (JAX fuses its
    # astype into the reduction)
    x = randn(gen, (args.elements,), dev)
    nbytes = x.numel() * x.element_size()

    def f(x):
        return torch.sum(x, dtype=torch.float32)

    sums = []
    for r in range(args.rounds):
        dt = measure(f, x, iters=args.iters, device=dev)
        sums.append(gbps(nbytes, dt))
        print(f"r{r} sum {nbytes / 2**30:g}GiB bf16: {dt*1e3:8.3f} ms  "
              f"{sums[-1]:6.0f} GB/s", flush=True)
    del x

    n = args.matmul
    a, b = randn(gen, (n, n), dev), randn(gen, (n, n), dev)

    def g(a, b):
        return a @ b

    mms = []
    for r in range(args.rounds):
        dt = measure(g, a, b, iters=args.iters, device=dev)
        mms.append(tflops(2 * n ** 3, dt))
        print(f"r{r} matmul {n}^3:  {dt*1e3:8.3f} ms  {mms[-1]:6.1f} TF/s",
              flush=True)
    bw, fl = max(sums), max(mms)
    ok = bw * 1e9 <= HBM_BYTES_PER_S and fl * 1e12 <= BF16_FLOPS_PER_S
    verdict = "OK" if ok else "FAILED (a rate past the peak)"
    print(f"calibration: best {bw:.0f} GB/s "
          f"({pct(bw * 1e9, HBM_BYTES_PER_S):.1f}% of 3.35 TB/s), best "
          f"{fl:.1f} TF/s ({pct(fl * 1e12, BF16_FLOPS_PER_S):.1f}% of 989 "
          f"TFLOP/s): {verdict}", flush=True)
    return dict(sum_gbps=sums, matmul_tflops=mms, ok=ok)


if __name__ == "__main__":
    main()
