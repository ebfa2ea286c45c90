"""32k-context decode from bf16 and int8 pools, best of rounds: the
counterpart of the JAX repository's `benchmarks/prof_decode_int8.py` on
the card.

Its methodology notes hold here too:
  * K and V are DISTINCT pools.  Passing one tensor as both lets the
    second stream hit the cache (on the H100 its 50 MB L2) right after the
    first read the same rows, and the rate reads past the HBM roofline
    (the port's bench_decode read 120-133% of 3.35 TB/s that way).
  * Variants are measured interleaved, several rounds, reporting the BEST
    round per variant: noise only ever adds time.
Each call goes through the merged decode entry (`ops/cuda/decode.py::
paged_decode_attention_merged`: K4 over bf16 pools, K4q over int8 pools;
"int8-deq" dequantizes the int8 pools to bf16 first, then K4), unchained,
at B 8, 32/8 x 128, 32k context, pages of 256 and 512.  Besides the JAX
script's time a call (host included) each variant reports its device time
a call from a CUDA-graph replay.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_decode_int8
        [--rounds 3] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    DecodeCase, backend, graph_seconds, rate_line)
from flash_attn_v100_tpu_torch.utils.benchmarking import gbps, measure

SEED = 0
# name: (page size, kind)
VARIANTS = {
    "bf16 ps=256":     (256, "bf16"),
    "bf16 ps=512":     (512, "bf16"),
    "int8-mxu ps=256": (256, "int8"),
    "int8-mxu ps=512": (512, "int8"),
    "int8-deq ps=256": (256, "int8-deq"),
    "int8-deq ps=512": (512, "int8-deq"),
}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--ctx", type=int, default=32768)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    case = DecodeCase(gen, args.batch, args.heads, args.kv_heads,
                      args.head_dim, args.ctx, dev)
    B, q = args.batch, case.q
    fns = {name: (case.core(ps, kind), case.nbytes(kind != "bf16"))
           for name, (ps, kind) in VARIANTS.items()}
    best = {k: float("inf") for k in fns}
    best_dev = {k: float("inf") for k in fns}
    for r in range(args.rounds):
        for name, (fn, _) in fns.items():
            dt = measure(fn, q, iters=16, device=dev)
            best[name] = min(best[name], dt)
            line = f"  r{r} {name:16s}: {dt*1e3:7.3f} ms"
            if dev.type == "cuda":
                ddt = graph_seconds(lambda: fn(q), dev)
                best_dev[name] = min(best_dev[name], ddt)
                line += f"  device {ddt*1e3:7.3f} ms"
            print(line, flush=True)

    print("\n== best-of rounds ==")
    rows = {}
    for name, (_, nbytes) in fns.items():
        dt = best[name]
        line = f"{name:16s}: {rate_line(B, dt, nbytes)}"
        row = dict(call_s=dt, call_gbps=gbps(nbytes, dt), nbytes=nbytes)
        if dev.type == "cuda":
            ddt = best_dev[name]
            line += f"\n{'':16s}  device: {rate_line(B, ddt, nbytes)}"
            row.update(device_s=ddt, device_gbps=gbps(nbytes, ddt))
        print(line, flush=True)
        rows[name] = row
    return rows


if __name__ == "__main__":
    main()
