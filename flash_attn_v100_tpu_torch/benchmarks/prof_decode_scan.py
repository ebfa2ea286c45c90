"""Decode timing from chained calls: the counterpart of the JAX repository's
`benchmarks/prof_decode_scan.py` on the card.

The JAX script chains 64 decode calls in one jitted scan, the q of call
i + 1 depending on call i's output (q <- q + 1e-6 o), so dispatch noise
amortizes and nothing can be hoisted.  Here the same chain runs on the
port's merged decode entry (`ops/cuda/decode.py::
paged_decode_attention_merged`: K4 over bf16 pools, K4q over int8 pools)
at the JAX shapes, B 8, 32/8 x 128, 32k context, pages of 256 and 512.
Each variant reports the time a call with the host's Python time in it
(`utils/benchmarking.measure` of the chain) and the device time a call (a
CUDA-graph replay of the chain), each as tok/s, GB/s and its share of
the H100 SXM's 3.35 TB/s, over the JAX script's byte count.

Variant names are the JAX script's.  "int8-mxu" is K4q (its products are
int8 on the tensor cores); "int8-deq" (the TPU kernel's int8_matmul=False)
becomes: dequantize the int8 pools to bf16, then K4.  A name with "U<n>"
sets the TPU kernel's `kv_unroll`, a Mosaic unroll of its page loop that
K4 / K4q have no counterpart of: those rows print "n/a on the port".

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_decode_scan
        [--set main|unroll] [--rounds 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, List, Optional

import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    DecodeCase, backend, chain_seconds, rate_line)
from flash_attn_v100_tpu_torch.utils.benchmarking import gbps

SEED = 0
# name: (page size, kind, kv_unroll)
SETS = {
    "main": {
        "bf16 ps=256":        (256, "bf16", None),
        "bf16 ps=512":        (512, "bf16", None),
        "int8-mxu ps=256":    (256, "int8", None),
        "int8-mxu ps=256 U1": (256, "int8", 1),
        "int8-mxu ps=512":    (512, "int8", None),
        "int8-mxu ps=512 U2": (512, "int8", 2),
        "int8-deq ps=256":    (256, "int8-deq", None),
        "int8-deq ps=512":    (512, "int8-deq", None),
    },
    "unroll": {
        "int8 ps=256 U2":  (256, "int8", 2),
        "int8 ps=256 U4":  (256, "int8", 4),
        "int8 ps=256 U8":  (256, "int8", 8),
        "int8 ps=512 U2":  (512, "int8", 2),
        "int8 ps=512 U4":  (512, "int8", 4),
        "int8 ps=1024 U1": (1024, "int8", 1),
        "int8 ps=1024 U2": (1024, "int8", 2),
        "bf16 ps=512 U2":  (512, "bf16", 2),
        "bf16 ps=1024 U1": (1024, "bf16", 1),
    },
}
NA = ("n/a on the port (kv_unroll unrolls the TPU kernel's page loop for "
      "Mosaic; K4 / K4q take no unroll)")


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--ctx", type=int, default=32768)
    ap.add_argument("--chain", type=int, default=64,
                    help="decode calls chained (the JAX scan's length)")
    ap.add_argument("--set", default="main", choices=sorted(SETS))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    case = DecodeCase(gen, args.batch, args.heads, args.kv_heads,
                      args.head_dim, args.ctx, dev)
    B, n = args.batch, args.chain
    variants = {}
    for name, (ps, kind, unroll) in SETS[args.set].items():
        if unroll is None:
            variants[name] = (case.core(ps, kind), case.nbytes(kind != "bf16"))
    calls = {k: [] for k in variants}
    device = {k: [] for k in variants}
    for _ in range(args.rounds):
        for name, (fn, _) in variants.items():
            call, dev_s = chain_seconds(fn, case.q, n, dev)
            calls[name].append(call)
            device[name].append(dev_s)

    print(f"\n== median of rounds (chained x{n}) ==")
    rows = {}
    for name in SETS[args.set]:
        if name not in variants:
            print(f"{name:19s}: {NA}", flush=True)
            rows[name] = None
            continue
        nbytes = variants[name][1]
        dt = statistics.median(calls[name])
        line = (f"{name:19s}: {rate_line(B, dt, nbytes)}   runs="
                f"{['%.3f' % (t * 1e3) for t in calls[name]]}")
        row = dict(call_s=dt, call_gbps=gbps(nbytes, dt), nbytes=nbytes)
        if dev.type == "cuda":
            ddt = statistics.median(device[name])
            line += f"\n{'':19s}  device: {rate_line(B, ddt, nbytes)}"
            row.update(device_s=ddt, device_gbps=gbps(nbytes, ddt))
        print(line, flush=True)
        rows[name] = row
    return rows


if __name__ == "__main__":
    main()
