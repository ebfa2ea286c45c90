"""int4 against int8 decode at a 32k context, chained calls: the counterpart
of the JAX repository's `benchmarks/prof_int4.py` on the card.

Both pools are token-packed as the JAX package packs them (`ops/quant.py`:
two int4 tokens a byte), and each decode goes through
`flash_attn_with_kvcache` (K4q over the int8 or the int4 pool) at B 8,
32/8 x 128, chained `--chain` times as the JAX scan chains them (q <- q +
1e-6 o).  The int4 pool streams half the payload bytes, so the JAX gate
is int4 at ~1.9-2x int8's tok/s.  Each line gives the time a call with its
host time (`measure` of the chain) and, on the card, the device time a
call from a CUDA-graph replay of the chain.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_int4
        [--ctx 32768] [--page-size 512] [--chain 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, List, Optional

import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    HBM_BYTES_PER_S, backend, chain_seconds, pct, randn)
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.quant import quantize_kv
from flash_attn_v100_tpu_torch.utils.benchmarking import gbps

SEED = 0


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--ctx", type=int, default=32768)
    ap.add_argument("--page-size", type=int, default=512)
    ap.add_argument("--chain", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, Hq, Hk, D = args.batch, args.heads, args.kv_heads, args.head_dim
    ctx, PS, n = args.ctx, args.page_size, args.chain
    P_ = B * ctx // PS
    kpool, vpool = (randn(gen, (Hk, P_, PS, D), dev) for _ in range(2))
    table = torch.arange(P_, dtype=torch.int32, device=dev).reshape(B, -1)
    cs = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    qd = randn(gen, (B, 1, Hq, D), dev)

    def bench(name, pools, payload_bytes_per_tok):
        a, b, c, d = pools

        def core(qc):
            return flash_attn_with_kvcache(
                qc, a, b, cache_seqlens=cs, block_table=table, causal=True,
                k_scales=c, v_scales=d, kv_cache_layout="HND")
        runs = [chain_seconds(core, qd, n, dev) for _ in range(3)]
        dt = statistics.median(r[0] for r in runs)
        nbytes = B * payload_bytes_per_tok
        bw = gbps(nbytes, dt)
        line = (f"{name}: {B/dt:.0f} tok/s/chip, {bw:.0f} GB/s "
                f"({pct(bw * 1e9, HBM_BYTES_PER_S):.0f}% of 3.35 TB/s)")
        row = dict(call_s=dt, call_gbps=bw, nbytes=nbytes)
        if dev.type == "cuda":
            ddt = statistics.median(r[1] for r in runs)
            dbw = gbps(nbytes, ddt)
            line += (f"; device {B/ddt:.0f} tok/s, {dbw:.0f} GB/s "
                     f"({pct(dbw * 1e9, HBM_BYTES_PER_S):.0f}%)")
            row.update(device_s=ddt, device_gbps=dbw)
        print(line, flush=True)
        return row

    print(f"== decode int8 vs int4, ctx={ctx}, ps={PS} ==", flush=True)
    k8, ks8 = quantize_kv(kpool, torch.int8)
    v8, vs8 = quantize_kv(vpool, torch.int8)
    r8 = bench("int8", (k8, v8, ks8, vs8), 2 * ctx * Hk * (D + 4))
    del k8, v8
    k4, ks4 = quantize_kv(kpool, "int4")
    v4, vs4 = quantize_kv(vpool, "int4")
    r4 = bench("int4", (k4, v4, ks4, vs4), 2 * ctx * Hk * (D // 2 + 4))
    speedup = r8["call_s"] / r4["call_s"]
    line = f"int4/int8 speedup: {speedup:.2f}x (target ~1.9x)"
    if dev.type == "cuda":
        line += f"; device {r8['device_s'] / r4['device_s']:.2f}x"
    print(line, flush=True)
    return dict(int8=r8, int4=r4, speedup=speedup)


if __name__ == "__main__":
    main()
