"""Per-kernel device profiles of the flagship paths on the card, rendered as
markdown: the counterpart of the JAX repository's
`benchmarks/profile_kernels.py` (its TPU tracer) on `torch.profiler`.

Each section runs one path `--iters` times under the profiler
(`utils/profiling.profile_ops`) and reports the device lane's time by
kernel, the port's kernels labelled by their ids (K1 dense forward, K2 dQ,
K3 dK/dV, K4 decode, K4q its quantized pools, K5 varlen forward), with a
footer giving the total device time a call against the section's analytic
floor: its tensor-core FLOPs at 989 TFLOP/s (bf16, H100 SXM) or its HBM
bytes at 3.35 TB/s.  The sections and shapes are the JAX script's: the
dense causal prefill (B 4 x 4096, 32/8 x 128, bf16) and its backward, the
32k decode (B 8, 512-token pages) from bf16 and int8 pools, and the mixed
varlen batch.

    python -m flash_attn_v100_tpu_torch.benchmarks.profile_kernels
        [--out flash_attn_v100_tpu_torch/docs/profiles.md] [--device cpu]

On the CPU (`--device cpu`, the kernels' plain versions) the profiler has
no device lane and the rows are the CPU ops.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    BF16_FLOPS_PER_S, HBM_BYTES_PER_S, backend, device_lane, randn)
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.quant import quantize_kv
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func
from flash_attn_v100_tpu_torch.utils.profiling import (
    capture_trace, summarize_trace)

SEED = 0


def ctx_label(ctx: int) -> str:
    return f"{ctx // 1024}k" if ctx % 1024 == 0 else str(ctx)


def fmt(rows, iters: int, flops: Optional[int] = None,
        bytes_: Optional[int] = None) -> Dict:
    """The section's table and footer (markdown) and its numbers: total
    device µs a call, the achieved rate and its share of the card's peak."""
    total_us = sum(us for _, us, _ in rows) / iters
    out = ["| device op | total µs / call | calls / capture |",
           "|---|---|---|"]
    for name, us, n in rows[:8]:
        short = name if len(name) <= 60 else name[:57] + "..."
        out.append(f"| `{short}` | {us / iters:.1f} | {n} |")
    floor, share = [], None
    if flops:
        tfs = flops / (total_us * 1e-6) / 1e12
        share = 100 * tfs * 1e12 / BF16_FLOPS_PER_S
        floor.append(f"{tfs:.0f} TF/s achieved = {share:.0f}% of 989 "
                     f"TFLOP/s (bf16)")
    if bytes_:
        gbs = bytes_ / (total_us * 1e-6) / 1e9
        share = 100 * gbs * 1e9 / HBM_BYTES_PER_S
        floor.append(f"{gbs:.0f} GB/s achieved = {share:.0f}% of 3.35 TB/s "
                     f"(HBM)")
    out.append("")
    out.append(f"Total device time {total_us:.0f} µs/call"
               + ("; " + "; ".join(floor) if floor else "") + ".")
    return dict(text="\n".join(out), total_us=total_us, share_pct=share,
                top=rows[0][0] if rows else None,
                rows=[(n, us / iters, c) for n, us, c in rows[:8]])


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seqlen", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--decode-batch", type=int, default=8)
    ap.add_argument("--ctx", type=int, default=32768)
    ap.add_argument("--page-size", type=int, default=512)
    ap.add_argument("--lens", type=int, nargs="+",
                    default=[128, 512, 1024, 4096, 2048, 300, 37, 4096])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    iters = args.iters
    sections = []

    def profile(fn, *a):
        """utils/profiling.profile_ops, refusing a card's trace without
        its device lane."""
        d = capture_trace(fn, *a, iters=iters)
        device_lane(d, dev)
        return summarize_trace(d, top=20)

    def mkb(*s):
        return randn(gen, s, dev)

    # dense causal prefill
    B, M, Hq, Hk, D = (args.batch, args.seqlen, args.heads, args.kv_heads,
                       args.head_dim)
    q, k, v = mkb(B, M, Hq, D), mkb(B, M, Hk, D), mkb(B, M, Hk, D)
    fl_causal = 4 * B * M * M * Hq * D // 2

    def dense_fwd_causal(q, k, v):
        return flash_attn_func(q, k, v, causal=True)

    rows = profile(dense_fwd_causal, q, k, v)
    sections.append((f"Dense causal prefill (B{B} S{M} Hq{Hq} D{D})", rows,
                     dict(flops=fl_causal)))
    print("dense done", flush=True)

    # dense backward (the forward runs in the capture too, as jax.grad's)
    do = mkb(B, M, Hq, D)

    def dense_bwd_causal(q, k, v):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = flash_attn_func(*leaves, causal=True)
        return torch.autograd.grad((out * do).to(torch.float32).sum(),
                                   leaves)

    rows = profile(dense_bwd_causal, q, k, v)
    sections.append(("Dense causal backward (same shape)", rows,
                     dict(flops=int(fl_causal * 2.5))))
    del q, k, v, do
    print("bwd done", flush=True)

    # 32k decode bf16 + int8 (K and V pools of their own)
    B2, ctx, ps = args.decode_batch, args.ctx, args.page_size
    P_ = B2 * ctx // ps
    kp, vp = mkb(Hk, P_, ps, D), mkb(Hk, P_, ps, D)
    tbl = torch.arange(P_, dtype=torch.int32, device=dev).reshape(B2, -1)
    cs = torch.full((B2,), ctx, dtype=torch.int32, device=dev)
    qd = mkb(B2, 1, Hq, D)

    def decode_32k_bf16(q, a, b):
        return flash_attn_with_kvcache(
            q, a, b, cache_seqlens=cs, block_table=tbl, causal=True,
            kv_cache_layout="HND")

    rows = profile(decode_32k_bf16, qd, kp, vp)
    sections.append((f"Decode {ctx_label(ctx)} ctx bf16 (B{B2} Hq{Hq} D{D}, "
                     f"{ps}-token pages)", rows,
                     dict(bytes_=2 * B2 * ctx * Hk * D * 2)))
    kq, ks = quantize_kv(kp, torch.int8)
    vq, vs = quantize_kv(vp, torch.int8)
    del kp, vp

    def decode_32k_int8(q, a, b, c, d):
        return flash_attn_with_kvcache(
            q, a, b, cache_seqlens=cs, block_table=tbl, causal=True,
            k_scales=c, v_scales=d, kv_cache_layout="HND")

    rows = profile(decode_32k_int8, qd, kq, vq, ks, vs)
    sections.append((f"Decode {ctx_label(ctx)} ctx INT8 (same shape)", rows,
                     dict(bytes_=2 * B2 * ctx * Hk * (D + 4))))
    del kq, vq, ks, vs
    print("decode done", flush=True)

    # varlen mixed causal
    lens = args.lens
    T = sum(lens)
    cu = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(
        np.int32)).to(dev)
    qv, kv_, vv = mkb(T, Hq, D), mkb(T, Hk, D), mkb(T, Hk, D)

    def varlen_mixed_causal(q, k, v):
        return flash_attn_varlen_func(q, k, v, cu, cu, max(lens), max(lens),
                                      causal=True)

    rows = profile(varlen_mixed_causal, qv, kv_, vv)
    fl_vl = sum(4 * Hq * L * L * D // 2 for L in lens)
    sections.append((f"Varlen mixed-length causal ({min(lens)}..{max(lens)}"
                     f", Hq{Hq} D{D})", rows, dict(flops=fl_vl)))
    print("varlen done", flush=True)

    doc = ["# Per-kernel device profiles (NVIDIA H100)",
           "",
           f"Card: {card}.  Captured with `utils/profiling.profile_ops`",
           "(`torch.profiler`: the device lane's own kernel durations, the",
           "counterpart of the reference's ncu reports).  Rows are",
           "aggregated by label: the port's kernels by their ids (K1 dense",
           "forward, K2 dQ, K3 dK/dV, K4 decode, K4q its quantized pools, K5",
           "varlen forward), other kernels by their CUDA names.  Each",
           "section's footer compares the total device time a call to the",
           "analytic floor (989 TFLOP/s bf16 or 3.35 TB/s).  Regenerate:",
           "`python -m flash_attn_v100_tpu_torch.benchmarks.profile_kernels "
           "--out flash_attn_v100_tpu_torch/docs/profiles.md`.",
           ""]
    results = []
    for title, rows, kw in sections:
        res = fmt(rows, iters, **kw)
        results.append(dict(title=title, **res))
        doc.append(f"## {title}\n")
        doc.append(res["text"])
        doc.append("")
    text = "\n".join(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text)
    return results


if __name__ == "__main__":
    main()
