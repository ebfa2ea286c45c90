"""Decode-attention roofline: achieved HBM bandwidth against context length.

The counterpart of the JAX repository's `benchmarks/bench_decode.py` on the
port.  Decode (T_q = 1) is bound by bytes: every step streams the whole KV
cache once.  This bench reports the achieved GB/s of
`flash_attn_with_kvcache` over a paged HND pool, bf16 (K4,
`csrc/decode.cu`) and int8 (K4q, `csrc/decode_quant.cu`), across context
lengths and split counts, against `--hbm-peak-gbps` (default 3350, the
H100 SXM's HBM3 rate).  The byte count is the JAX script's: the K and V
payload (and int8's per-token scales) of every live token, once; K and V
are drawn as pools of their own (the JAX script's bf16 case reads one
pool as both).

    python -m flash_attn_v100_tpu_torch.benchmarks.bench_decode
        [--ctx 4096 32768] [--batch 8] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import torch

from flash_attn_v100_tpu_torch.benchmarks.common import backend
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.quant import quantize_kv
from flash_attn_v100_tpu_torch.utils.benchmarking import gbps, measure

SEED = 0


def decode_bytes(B: int, ctx: int, Hk: int, D: int, dtype: str) -> int:
    """The K and V bytes a decode step reads (the JAX script's count)."""
    if dtype == "int8":
        return 2 * B * ctx * Hk * D * 1 + 2 * B * ctx * Hk * 4
    return 2 * B * ctx * Hk * D * 2


def bench_one(gen: torch.Generator, B, Hq, Hk, D, ctx, page_size, dtype,
              num_splits=0, dev=None) -> Tuple[float, float, int]:
    """(seconds a decode step, GB/s, bytes) of one configuration."""
    P = B * ctx // page_size

    def mk(*s):
        return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
    # K and V in pools of their own: the JAX script passes one pool as
    # both, whose V reads then hit the card's L2 right after the K reads of
    # the same rows, and its byte count would overstate the rate twofold
    kpool, vpool = mk(Hk, P, page_size, D), mk(Hk, P, page_size, D)
    table = torch.arange(P, dtype=torch.int32, device=dev).reshape(B, -1)
    cs = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    q = mk(B, 1, Hq, D)
    kw = dict(cache_seqlens=cs, block_table=table, causal=True,
              kv_cache_layout="HND", num_splits=num_splits)
    if dtype == "int8":
        kq, ks = quantize_kv(kpool, torch.int8)
        vq, vs = quantize_kv(vpool, torch.int8)
        del kpool, vpool

        def f(q, a, b, c, d):
            return flash_attn_with_kvcache(q, a, b, k_scales=c, v_scales=d,
                                           **kw)
        dt = measure(f, q, kq, vq, ks, vs, iters=16, device=dev)
    else:
        def f(q, a, b):
            return flash_attn_with_kvcache(q, a, b, **kw)
        dt = measure(f, q, kpool, vpool, iters=16, device=dev)
    nbytes = decode_bytes(B, ctx, Hk, D, dtype)
    return dt, gbps(nbytes, dt), nbytes


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", type=int, nargs="+",
                    default=[4096, 8192, 16384, 32768])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=256)
    ap.add_argument("--splits", type=int, nargs="+", default=[0])
    ap.add_argument("--hbm-peak-gbps", type=float, default=3350.0,
                    help="the card's HBM peak for %%-of-roofline (H100 SXM: "
                         "3350)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, Hq, Hk, D = args.batch, args.heads, args.kv_heads, args.head_dim
    print(f"backend={card} hbm_peak_gbps={args.hbm_peak_gbps:g} B={B} "
          f"Hq={Hq} Hk={Hk} D={D}", flush=True)
    rows = []
    for ctx in args.ctx:
        for dtype in ("bf16", "int8"):
            for ns in args.splits:
                dt, bw, nbytes = bench_one(gen, B, Hq, Hk, D, ctx,
                                           args.page_size, dtype, ns, dev)
                print(f"  ctx={ctx:6d} kv={dtype:5s} splits={ns}: "
                      f"{dt*1e6:7.0f} us  {B/dt:7.0f} tok/s/chip  "
                      f"{bw:6.0f} GB/s ({100*bw/args.hbm_peak_gbps:.0f}% "
                      f"of roofline)", flush=True)
                rows.append(dict(ctx=ctx, kv=dtype, splits=ns, seconds=dt,
                                 gbps=bw, nbytes=nbytes))
    return rows


if __name__ == "__main__":
    main()
