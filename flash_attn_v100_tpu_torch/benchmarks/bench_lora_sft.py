"""LoRA SFT end-to-end training benchmark.

The counterpart of the JAX repository's `benchmarks/bench_lora_sft.py` on
the port: LoRA fine-tuning of a Llama-family model (random bf16 base
weights, frozen) through the attention kernels K1-K3 (`csrc/fwd.cu`,
`csrc/bwd.cu`) for N steps with wall-clock reporting.  One step to warm
up, then `--steps` steps between two `torch.cuda.synchronize()`; it prints
the JAX script's lines (ms a step, tok/s, the final loss), with the card
line in place of the JAX backend.

    python -m flash_attn_v100_tpu_torch.benchmarks.bench_lora_sft
        [--steps 20] [--seq 4096] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import backend
from flash_attn_v100_tpu_torch.integrations.lora import (
    LoraConfig, lora_init, lora_leaves, make_lora_train_step)
from flash_attn_v100_tpu_torch.models.transformer import (
    ModelConfig, init_params, param_leaves)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--dim", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)

    cfg = ModelConfig(
        vocab_size=32000, dim=args.dim, n_layers=args.layers,
        n_heads=args.dim // 128, n_kv_heads=max(1, args.dim // 256),
        head_dim=128, ffn_dim=int(args.dim * 2.75),
        max_seq_len=args.seq, dtype=torch.bfloat16, dropout_p=args.dropout)
    params = init_params(cfg, seed=0, device=dev)        # PRNGKey(0)
    lcfg = LoraConfig(rank=args.rank, alpha=2.0 * args.rank)
    lora = lora_init(params, lcfg, seed=1, device=dev)   # PRNGKey(1)
    n_lora = sum(x.numel() for x in lora_leaves(lora))
    n_base = sum(x.numel() for x in param_leaves(params))
    print(f"backend={card} base={n_base/1e6:.0f}M "
          f"lora={n_lora/1e6:.2f}M (r={args.rank}) seq={args.seq}",
          flush=True)

    step, init_opt = make_lora_train_step(cfg, lcfg)
    opt = init_opt(lora)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (args.batch, args.seq + 1))).to(dev)
    # dropout's stream (PRNGKey(2), folded per step in the JAX script)
    gen = torch.Generator(device=dev).manual_seed(2)

    loss, lora, opt = step(lora, opt, params, toks, generator=gen)  # warm-up
    _sync(dev)
    first = float(loss)
    t0 = time.monotonic()
    for _ in range(args.steps):
        loss, lora, opt = step(lora, opt, params, toks, generator=gen)
    _sync(dev)
    dt = (time.monotonic() - t0) / args.steps
    tok_s = args.batch * args.seq / dt
    final = float(loss)
    print(f"{args.steps} steps: {dt*1e3:.0f} ms/step, {tok_s:.0f} tok/s, "
          f"final loss {final:.4f}", flush=True)
    return dict(ms_per_step=dt * 1e3, tok_s=tok_s, first_loss=first,
                final_loss=final, steps=args.steps)


if __name__ == "__main__":
    main()
