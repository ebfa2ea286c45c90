"""Attribute the steady decode step: the counterpart of the JAX repository's
`benchmarks/prof_decode_attrib.py` on the card.

The serving bench's decode rate mixes two costs.  This splits them:

  (a) the device time of a decode step: the full model forward
      (`runtime/engine.py::paged_forward`, K4 in every layer) chained
      `--chain` times with greedy tokens fed back, as the JAX scan chains
      it, at the serving shape (B 16, 2048 live tokens, 128-token pages),
      over layer-folded bf16 pools.  Its device time is the union of the
      device lane's kernel intervals in a `torch.profiler` trace of the
      chain (`utils/profiling.trace_events`, `common.device_busy_us`),
      beside the chain's wall time, and a CUDA-graph replay's time of the
      chain (no host sync on the decode path, so it captures);
  (b) the engine's steady decode (`ServingEngine`, B 16 prompts of 2048
      tokens, 290 pages of 128) at decode_fuse 1 / 8 / 16 / 32: ms an
      engine step, ms a decode step and tok/s over the steps that did no
      prefill work.
The host's share of a decode step is (b) less (a).  The model is the JAX
script's: vocab 32000, d 4096, 16 layers, 32/8 heads x 128, ffn 11008,
bf16, seeded random weights (`common.measure_model`).

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_decode_attrib
        [--fuse 1 8 16 32] [--batch 16] [--new-tokens 160] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    add_model_flags, backend, device_busy_us, device_lane, graph_seconds,
    measure_model, params_gib, sync)
from flash_attn_v100_tpu_torch.models.transformer import rope_tables
from flash_attn_v100_tpu_torch.runtime.engine import (
    ServingEngine, paged_forward)
from flash_attn_v100_tpu_torch.utils.debugging import trace


class DecodeChain:
    """The JAX script's `device_only` state: zero layer-folded pools, every
    row at `plen` live tokens on its own pages (block table 1 + arange),
    the first tokens `toks` (B,)."""

    def __init__(self, params, cfg, toks: np.ndarray, plen: int, ps: int,
                 dev):
        B = len(toks)
        mp = cfg.max_seq_len // ps
        shape = (cfg.n_kv_heads, (B * mp + 1) * cfg.n_layers, ps,
                 cfg.head_dim)
        self.params, self.cfg = params, cfg
        self.kp = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.vp = torch.zeros_like(self.kp)
        self.bt = torch.from_numpy(
            1 + np.arange(B * mp, dtype=np.int32).reshape(B, mp)).to(dev)
        self.cs = torch.full((B,), plen, dtype=torch.int32, device=dev)
        self.toks = torch.from_numpy(toks.astype(np.int32)).to(dev)
        self.rope = rope_tables(cfg, cfg.max_seq_len, device=dev)

    def run(self, n: int) -> torch.Tensor:
        """n greedy decode steps from the initial tokens and lengths (the
        pools keep what earlier runs appended past them); returns the
        tokens (n, B)."""
        tok, cs, out = self.toks, self.cs, []
        for _ in range(n):
            logits, _, _ = paged_forward(self.params, self.kp, self.vp,
                                         tok[:, None], cs, self.bt,
                                         cfg=self.cfg, rope=self.rope)
            tok = torch.argmax(logits[:, 0], -1).to(torch.int32)
            cs = cs + 1
            out.append(tok)
        return torch.stack(out)


def device_only(chain: DecodeChain, n: int, dev) -> Dict:
    """(a): the chain's wall time and device-busy time a step from a trace,
    and a CUDA-graph replay's time a step where the chain captures."""
    chain.run(n)                       # first-call work outside the trace
    sync(dev)
    with tempfile.TemporaryDirectory(prefix="fa_attrib_") as d:
        with trace(d):
            t0 = time.perf_counter()
            chain.run(n)
            sync(dev)
            wall = time.perf_counter() - t0
        events = device_lane(d, dev)
    res = dict(wall_s=wall / n, busy_s=device_busy_us(events) * 1e-6 / n,
               events=len(events))
    if dev.type == "cuda":       # the decode path syncs nowhere: it captures
        res["graph_s"] = graph_seconds(lambda: chain.run(n), dev,
                                       reps=3) / n
    return res


def engine_steady(params, cfg, fuse: int, prompts, num_pages: int, ps: int,
                  new_tokens: int, dev) -> Dict:
    """(b): the engine's steady decode at decode_fuse `fuse` after a
    warm-up burst that reaches every fused width and row bucket."""
    B = len(prompts)
    eng = ServingEngine(params, cfg, max_batch=B, num_pages=num_pages,
                        page_size=ps, decode_fuse=fuse, device=dev)
    for p in prompts:
        eng.submit(p, max_new_tokens=4 * max(fuse, 8))
    eng.run_to_completion()
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    dec_toks, dec_wall, dec_steps = 0, 0.0, 0
    while not eng.idle():
        pf0 = eng.metrics["prefill_tokens"]
        tg0 = eng.metrics["tokens_generated"]
        ts = time.monotonic()
        eng.step()
        te = time.monotonic()
        if eng.metrics["prefill_tokens"] == pf0:
            dec_toks += eng.metrics["tokens_generated"] - tg0
            dec_wall += te - ts
            dec_steps += 1
    tf = time.monotonic()
    for r in rids:
        eng.result(r)
    sync(dev)
    dec_wall += time.monotonic() - tf
    return dict(fuse=fuse, tok_s=dec_toks / max(dec_wall, 1e-9),
                engine_step_s=dec_wall / max(dec_steps, 1),
                decode_step_s=dec_wall * B / max(dec_toks, 1),
                steps=dec_steps, toks=dec_toks)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    add_model_flags(ap)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--num-pages", type=int, default=290)
    ap.add_argument("--chain", type=int, default=32)
    ap.add_argument("--fuse", type=int, nargs="+", default=[1, 8, 16, 32])
    ap.add_argument("--new-tokens", type=int, default=160)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    print(f"card: {card}", flush=True)
    cfg, params = measure_model(args, dev)
    B, PLEN = args.batch, args.prompt_len
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, PLEN).tolist()
               for _ in range(B)]
    toks = rng.integers(1, cfg.vocab_size, (B,))

    chain = DecodeChain(params, cfg, toks, PLEN, args.page_size, dev)
    a = device_only(chain, args.chain, dev)
    del chain
    ctx = f"{PLEN // 1024}k" if PLEN % 1024 == 0 else str(PLEN)
    print(f"device-only decode step (chained x{args.chain}, b{B}, {ctx} "
          f"ctx): {a['busy_s']*1e3:.2f} ms device busy -> "
          f"{B/a['busy_s']:.0f} tok/s; {a['wall_s']*1e3:.2f} ms wall a step",
          flush=True)
    if "graph_s" in a:
        print(f"device-only decode step (CUDA graph replay): "
              f"{a['graph_s']*1e3:.2f} ms", flush=True)
    engines = []
    for fuse in args.fuse:
        r = engine_steady(params, cfg, fuse, prompts, args.num_pages,
                          args.page_size, args.new_tokens, dev)
        host = r["decode_step_s"] - a["busy_s"]
        r["host_s"] = host
        print(f"engine decode_fuse={fuse:2d}: {r['tok_s']:6.0f} tok/s "
              f"steady, {r['engine_step_s']*1e3:7.2f} ms/engine-step over "
              f"{r['steps']} steps ({r['toks']} toks); "
              f"{r['decode_step_s']*1e3:.2f} ms/decode-step, host "
              f"{host*1e3:.2f} ms of it", flush=True)
        engines.append(r)
    print(f"floor check: params {params_gib(params):.2f} GiB/step; device "
          f"step above includes it", flush=True)
    return dict(device=a, engines=engines)


if __name__ == "__main__":
    main()
