"""Continuous-batching serving with streaming and a quantized KV pool, the
port's counterpart of the JAX package's examples/serve_engine.py.

    python -m flash_attn_v100_tpu_torch.examples.serve_engine
    python -m flash_attn_v100_tpu_torch.examples.serve_engine --device cpu

Six sampled requests on a small random model, four at a time, from an int8
page pool (K8q prefill and K4q decode on the GPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from flash_attn_v100_tpu_torch import ModelConfig, ServingEngine
from flash_attn_v100_tpu_torch.config import resolve_device
from flash_attn_v100_tpu_torch.models.transformer import init_params
from flash_attn_v100_tpu_torch.runtime.engine import SamplingParams


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = ModelConfig(vocab_size=1024, dim=256, n_layers=2, n_heads=8,
                      n_kv_heads=4, head_dim=32, ffn_dim=704, max_seq_len=512,
                      dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    eng = ServingEngine(params, cfg, max_batch=4, num_pages=128,
                        page_size=16, kv_dtype=torch.int8, device=dev)
    print("native C++ scheduler:", eng.sched.is_native)

    rng = np.random.default_rng(0)
    streamed = {}

    def on_token(rid, toks):
        streamed.setdefault(rid, []).extend(toks)

    rids = [eng.submit(rng.integers(1, cfg.vocab_size, 64).tolist(),
                       max_new_tokens=24,
                       sampling=SamplingParams(temperature=0.8, top_k=40,
                                               top_p=0.95),
                       on_token=on_token)
            for _ in range(6)]            # > max_batch: queued and batched
    eng.run_to_completion()
    for r in rids:
        if streamed[r] != eng.result(r):
            raise RuntimeError(f"request {r}: streamed tokens differ")
    lens = {r: len(eng.result(r)) for r in rids}
    print(lens, "| metrics:", eng.metrics["steps"], "steps,",
          eng.sched.stats()["preemptions"], "preemptions")
    return dict(lens=lens, steps=eng.metrics["steps"])


if __name__ == "__main__":
    main()
