"""Decode page-size sweep at the serving shape: the counterpart of the JAX
repository's `benchmarks/prof_decode_pagesize.py` on the card.

The engine decodes against 128-token pages while the 32k decode benches
run 512-token pages; if K4's per-page work sets the serving step, the
time a step moves with the page size.  B 16, 32/8 x 128, context 2048,
bf16 pools of 128 / 256 / 512 / 1024-token pages, each decode through
`flash_attn_with_kvcache` (K4), chained `--chain` times (q <- q + 1e-6 o)
as the JAX scan chains them.  A page size the port refuses prints
`FAILED <Exception>`.  Each line gives ms a step with the host's time in
it, GB/s and its share of 3.35 TB/s, and on the card the device time a
step from a CUDA-graph replay of the chain.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_decode_pagesize
        [--page-sizes 128 256 512 1024] [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, List, Optional

import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    HBM_BYTES_PER_S, backend, chain_seconds, chained, pct, randn, sync)
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.utils.benchmarking import gbps

SEED = 0


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--chain", type=int, default=32)
    ap.add_argument("--page-sizes", type=int, nargs="+",
                    default=[128, 256, 512, 1024])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, Hq, Hk, D, ctx = (args.batch, args.heads, args.kv_heads,
                         args.head_dim, args.ctx)
    rows = {}
    for ps in args.page_sizes:
        P = B * ctx // ps
        kp, vp = (randn(gen, (Hk, P, ps, D), dev) for _ in range(2))
        tbl = torch.arange(P, dtype=torch.int32, device=dev).reshape(B, -1)
        cs = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        qd = randn(gen, (B, 1, Hq, D), dev)

        def step(qc):
            return flash_attn_with_kvcache(qc, kp, vp, cache_seqlens=cs,
                                           block_table=tbl, causal=True,
                                           kv_cache_layout="HND")
        try:
            chained(step, qd, args.chain)
            sync(dev)
        except (RuntimeError, ValueError) as e:   # the port refuses it
            print(f"ps={ps}: FAILED {type(e).__name__}", flush=True)
            rows[ps] = dict(failed=f"{type(e).__name__}: {e}")
            continue
        runs = [chain_seconds(step, qd, args.chain, dev) for _ in range(3)]
        dt = statistics.median(r[0] for r in runs)
        byts = 2 * B * ctx * Hk * D * 2
        bw = gbps(byts, dt)
        line = (f"decode b{B} ctx{ctx} ps={ps:4d}: {dt*1e3:6.3f} ms/step, "
                f"{bw:5.0f} GB/s ({pct(bw * 1e9, HBM_BYTES_PER_S):.0f}% of "
                f"3.35 TB/s)")
        row = dict(call_s=dt, call_gbps=bw, nbytes=byts)
        if dev.type == "cuda":
            ddt = statistics.median(r[1] for r in runs)
            dbw = gbps(byts, ddt)
            line += (f"; device {ddt*1e3:6.3f} ms, {dbw:5.0f} GB/s "
                     f"({pct(dbw * 1e9, HBM_BYTES_PER_S):.0f}%)")
            row.update(device_s=ddt, device_gbps=dbw)
        print(line, flush=True)
        rows[ps] = row
        del kp, vp
    return rows


if __name__ == "__main__":
    main()
