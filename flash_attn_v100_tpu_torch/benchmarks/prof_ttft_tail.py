"""TTFT tail (p90) by scheduling knob on a burst of 24 x 2048-token prompts:
the counterpart of the JAX repository's `benchmarks/prof_ttft_tail.py` on
the card.

The burst comes in two waves under max_batch 16 (the second waits for
rows of the first), so p90 is the second wave's TTFT.  The knob sets are
the JAX script's: the six bf16 sets of its `__main__` (staggered admission
`max_prefill_seqs`, chunked prefill, a wider batch) and the three int8
sets of its `quant_configs()` (an int8 pool holds 580 pages in the bytes
of 290 bf16 ones, so all 24 requests fit at once).  With bf16 pools the
tail is page-bound in the JAX package (24 x 17 pages = 408 > 290); the
port's allocator makes the same decisions.  Each set runs the burst twice
on one engine, a full warm-up burst and the timed one, and prints p50 /
p90 TTFT and end-to-end tok/s; the model is the JAX script's (vocab
32000, d 4096, 16 layers, 32/8 heads x 128, ffn 11008, bf16, seeded random
weights), 64 new tokens a request, 128-token pages.  Prefills run K8
(K8q from int8 pools), decodes K4 (K4q).

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_ttft_tail
        [--configs baseline mps8 ...|all] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np

from flash_attn_v100_tpu_torch.benchmarks.common import (
    add_model_flags, backend, measure_model)
from flash_attn_v100_tpu_torch.runtime.engine import ServingEngine

# key: (the JAX script's tag, the engine's knobs)
BF16_CONFIGS = {
    "baseline": ("baseline max_batch=16", dict(max_batch=16)),
    "mps8": ("staggered mps=8", dict(max_batch=16, max_prefill_seqs=8)),
    "mps4": ("staggered mps=4", dict(max_batch=16, max_prefill_seqs=4)),
    "chunk1024": ("chunked 1024", dict(max_batch=16, prefill_chunk=1024)),
    "wide24": ("wide batch=24", dict(max_batch=24)),
    "wide_mps8": ("wide+staggered", dict(max_batch=24, max_prefill_seqs=8)),
}
INT8_CONFIGS = {
    "int8_290": ("int8 290p b16 (capacity-matched)",
                 dict(max_batch=16, num_pages=290, kv_dtype="int8")),
    "int8_580_mps8": ("int8 580p b24 mps=8",
                      dict(max_batch=24, num_pages=580, max_prefill_seqs=8,
                           kv_dtype="int8")),
    "int8_580": ("int8 580p b24",
                 dict(max_batch=24, num_pages=580, kv_dtype="int8")),
}
CONFIGS = {**BF16_CONFIGS, **INT8_CONFIGS}


def run(tag: str, params, cfg, prompts, new_tokens: int, dev,
        page_size: int = 128, **kw) -> Dict:
    """Two bursts of `prompts` on one engine (the first a warm-up); the
    timed burst's p50 / p90 TTFT and e2e tok/s, and each burst's
    scheduler decisions: steps, prefill tokens and the step (counted from
    the burst's first) at which each request got its first token."""
    eng = ServingEngine(params, cfg, num_pages=kw.pop("num_pages", 290),
                        page_size=page_size, device=dev, **kw)
    bursts = []
    for _ in range(2):   # burst 1 = warm-up; burst 2 timed
        steps0 = eng.metrics["steps"]
        pf0 = eng.metrics["prefill_tokens"]
        t0 = time.monotonic()
        rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        first = {}
        while not eng.idle():      # run_to_completion, one step at a time
            for sid in eng.step():
                eng.result(sid)
            for r in rids:
                if r not in first and eng.ttft(r) is not None:
                    first[r] = eng.metrics["steps"] - steps0
        wall = time.monotonic() - t0
        ttfts = sorted(eng.ttft(r) for r in rids)
        bursts.append(dict(steps=eng.metrics["steps"] - steps0,
                           prefill_tokens=eng.metrics["prefill_tokens"] - pf0,
                           first_token_step=[first[r] for r in rids]))
    p50 = ttfts[len(ttfts) // 2]
    p90 = ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.9))]
    total = sum(len(eng.result(r)) for r in rids)
    print(f"{tag}: p50 {p50*1e3:.0f} ms  p90 {p90*1e3:.0f} ms  "
          f"e2e {total/wall:.0f} tok/s", flush=True)
    return dict(tag=tag, p50_s=p50, p90_s=p90, e2e_tok_s=total / wall,
                total=total, bursts=bursts,
                preemptions=eng.sched.stats()["preemptions"])


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    add_model_flags(ap)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--configs", nargs="+", default=None,
                    choices=list(CONFIGS) + ["all"],
                    help="knob sets to run (default: the JAX script's "
                         "__main__, the six bf16 sets; `all` adds its "
                         "quant_configs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    print(f"card: {card}", flush=True)
    cfg, params = measure_model(args, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, args.prompt_len).tolist()
               for _ in range(args.requests)]
    keys = args.configs or list(BF16_CONFIGS)
    if "all" in keys:
        keys = list(CONFIGS)
    out = []
    for key in keys:
        tag, kw = CONFIGS[key]
        out.append(run(tag, params, cfg, prompts, args.new_tokens, dev,
                       page_size=args.page_size, **kw))
    return out


if __name__ == "__main__":
    main()
