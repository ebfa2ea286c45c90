"""Serving benchmark: continuous-batching throughput and p50/p99 TTFT.

The counterpart of the JAX repository's `benchmarks/bench_serving.py` on
the port: the full runtime stack (native scheduler + paged allocator +
paged decode engine) on a bf16 Llama-shaped model with random weights,
prefills through K8 (`csrc/varlen_paged.cu`) or K4's prefill route, decode
through K4 (`csrc/decode.cu`).  It prints the same lines as the JAX
script, with the card line (`nvidia-smi --query-gpu=name,power.limit`) in
place of the JAX backend, and the kernels' launch counts of the timed run.

    python -m flash_attn_v100_tpu_torch.benchmarks.bench_serving
        [--dim 1024] [--layers 8] [--requests 32] [--max-batch 16]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import backend
from flash_attn_v100_tpu_torch.models.transformer import (
    ModelConfig, init_params)
from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
from flash_attn_v100_tpu_torch.runtime.engine import ServingEngine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_counts() -> Dict[str, int]:
    """K4's and K8's launches so far (each counts one a layer a step)."""
    return {"K4": dec.paged_decode_attention.launches,
            "K8": vl.flash_attn_varlen_fwd_paged.launches}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen-len", type=int, default=128)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--decode-fuse", type=int, default=8,
                    help="max decode steps fused into one dispatch (1 = off)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)

    cfg = ModelConfig(
        vocab_size=32000, dim=args.dim, n_layers=args.layers,
        n_heads=args.heads, n_kv_heads=args.kv_heads, head_dim=args.head_dim,
        ffn_dim=int(args.dim * 2.75), max_seq_len=args.max_seq,
        dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)   # PRNGKey(0)
    num_pages = args.max_batch * (args.max_seq // args.page_size)
    eng = ServingEngine(params, cfg, max_batch=args.max_batch,
                        num_pages=num_pages, page_size=args.page_size,
                        decode_fuse=args.decode_fuse, device=dev)
    print(f"backend={card} native_sched={eng.sched.is_native} "
          f"model: L={cfg.n_layers} d={cfg.dim} Hq={cfg.n_heads} "
          f"Hk={cfg.n_kv_heads} hd={cfg.head_dim}", flush=True)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, args.prompt_len).tolist()
               for _ in range(args.requests)]

    # warmup, as the JAX script's: every power-of-two admission width up to
    # max_batch and the fused decode windows of a 24-token generation, so
    # the kernels' first launches and the CUDA caching allocator's growth
    # stay out of the timed run
    nb = 1
    while True:
        for i in range(min(nb, args.max_batch)):
            eng.submit(prompts[i][:args.prompt_len], max_new_tokens=24)
        eng.run_to_completion()
        if nb >= args.max_batch:
            break
        nb *= 2

    before = launch_counts()
    _sync(dev)
    t0 = time.monotonic()
    rids = [eng.submit(p, max_new_tokens=args.gen_len) for p in prompts]
    # steady decode rate: tokens generated by steps that did no prefill
    # work, over those steps' wall (each step's tokens are fetched to the
    # host lazily; the final fetch is charged to the decode phase)
    dec_toks = 0
    dec_wall = 0.0
    while not eng.idle():
        pf0 = eng.metrics["prefill_tokens"]
        tg0 = eng.metrics["tokens_generated"]
        ts = time.monotonic()
        eng.step()
        te = time.monotonic()
        if eng.metrics["prefill_tokens"] == pf0:
            dec_toks += eng.metrics["tokens_generated"] - tg0
            dec_wall += te - ts
    tf = time.monotonic()
    total_new = sum(len(eng.result(r)) for r in rids)
    _sync(dev)
    dec_wall += time.monotonic() - tf
    wall = time.monotonic() - t0
    launches = {k: v - before[k] for k, v in launch_counts().items()}

    ttfts = sorted(eng.ttft(r) for r in rids)

    def p(q):
        return ttfts[min(len(ttfts) - 1, int(q * len(ttfts)))]
    st = eng.sched.stats()
    steady = dec_toks / max(dec_wall, 1e-9)
    print(f"requests={args.requests} prompt={args.prompt_len} "
          f"gen={args.gen_len} batch<={args.max_batch}")
    print(f"decode: {steady:.0f} tok/s/chip steady "
          f"({dec_toks} toks), {total_new / wall:.0f} tok/s/chip e2e "
          f"(+{eng.metrics['prefill_tokens'] / wall:.0f} prefill tok/s)")
    print(f"TTFT p50={p(0.5)*1e3:.0f}ms p99={p(0.99)*1e3:.0f}ms  "
          f"preemptions={st['preemptions']} steps={eng.metrics['steps']}")
    print(f"launches: K4 {launches['K4']}, K8 {launches['K8']} "
          f"(one a layer a forward step)", flush=True)
    return dict(decode_tok_s=steady, e2e_tok_s=total_new / wall,
                ttft_p50_s=p(0.5), ttft_p99_s=p(0.99), total_new=total_new,
                dec_toks=dec_toks, launches=launches,
                preemptions=st["preemptions"], steps=eng.metrics["steps"])


if __name__ == "__main__":
    main()
