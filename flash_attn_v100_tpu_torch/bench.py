"""Headline benchmark of the port on one NVIDIA H100: prefill attention
TFLOP/s at 4k context, bf16.

    python -m flash_attn_v100_tpu_torch.bench

Prints ONE JSON line to stdout, {"metric", "value", "unit", "vs_baseline"}:
K1 (`flash_attn_func`) at B 4 x 4096, 32/8 heads x 128, causal, and
vs_baseline = the time of one `scaled_dot_product_attention` call
(enable_gqa, causal) on the same inputs over K1's, a yardstick the port
never calls.  The secondary lines go to stderr, as the JAX package's
root bench.py prints them: SDPA's own rate, a 32k causal prefill, the 32k
decode (B 8, 32/8 x 128) from bf16, int8, fp8 and int4 pools (int4 on
2048-token pages), varlen 8 x 2048 causal, and serving a 16-layer d 4096
model (24 requests of 2048 tokens, 64 new each) from the four pools.

Timing: `utils/benchmarking.measure` (CUDA events around queues of calls,
two queue depths differenced).  K and V are distinct tensors: one tensor
fed twice lets the memory system serve half the traffic and inflates the
decode's bytes/s past the roofline (the JAX bench's lesson).  Rooflines
use the H100's 3.35 TB/s.  Inputs and weights are random, made on the card
from seed 0.  A failing section raises and the script exits non-zero; a
watchdog ends a run that hangs.
"""

from __future__ import annotations

import gc
import json
import signal
import sys
import time

import torch
import torch.nn.functional as F

from flash_attn_v100_tpu_torch import (
    ModelConfig, ServingEngine, flash_attn_func, flash_attn_varlen_func,
    flash_attn_with_kvcache, quantize_kv)
from flash_attn_v100_tpu_torch.config import resolve_device
from flash_attn_v100_tpu_torch.models.transformer import init_params
from flash_attn_v100_tpu_torch.utils.benchmarking import (
    attention_flops, gbps, measure, tflops)

HBM_GB_PER_S = 3350.0          # H100 SXM
WATCHDOG_S = 20 * 60

# the headline shape (the JAX bench.py:71-78)
B, M, HQ, HK, D = 4, 4096, 32, 8, 128
# the 32k decode
DEC_B, DEC_CTX, DEC_PS = 8, 32768, 512
# serving (the JAX bench's llama-7B-class config)
SERVE_CFG = dict(vocab_size=32000, dim=4096, n_layers=16, n_heads=32,
                 n_kv_heads=8, head_dim=128, ffn_dim=11008, max_seq_len=2560,
                 dtype=torch.bfloat16)
PLEN, NREQ, NEW = 2048, 24, 64


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def headline(dev, gen) -> dict:
    """K1 at the headline shape, and SDPA on the same inputs."""
    def mk(*s):
        return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = mk(B, M, HQ, D), mk(B, M, HK, D), mk(B, M, HK, D)
    dt = measure(lambda: flash_attn_func(q, k, v, causal=True), device=dev)
    fl = attention_flops(B, M, M, HQ, D, causal=True)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    dt_base = measure(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), device=dev)
    log(f"sdpa_baseline_full_shape: {tflops(fl, dt_base):.1f} TF/s "
        f"(SDPA, enable_gqa, causal: a yardstick; K1 {dt * 1e3:.4f} ms, "
        f"SDPA {dt_base * 1e3:.4f} ms)")
    return {"metric": "prefill_attn_tflops_chip_4k_bf16",
            "value": round(tflops(fl, dt), 2), "unit": "TFLOP/s",
            "vs_baseline": round(dt_base / dt, 3)}


def prefill_32k(dev, gen) -> None:
    S = 32768
    q = torch.randn((1, S, HQ, D), generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.randn((1, S, HK, D), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((1, S, HK, D), generator=gen, device=dev).to(
        torch.bfloat16)
    dt = measure(lambda: flash_attn_func(q, k, v, causal=True), device=dev)
    fl = attention_flops(1, S, S, HQ, D, causal=True)
    log(f"prefill_32k_causal: {tflops(fl, dt):.1f} TF/s")


def decode_32k(dev, gen) -> None:
    """The 32k-context decode from each pool: tok/s, GB/s, roofline."""
    q = torch.randn((DEC_B, 1, HQ, D), generator=gen, device=dev).to(
        torch.bfloat16)
    cs = torch.full((DEC_B,), DEC_CTX, dtype=torch.int32, device=dev)
    base = None
    for kind in (None, torch.int8, torch.float8_e4m3fn, "int4"):
        # int4 wants large pages (the JAX bench's lesson): 2048 tokens
        ps = 2048 if kind == "int4" else DEC_PS
        P = DEC_B * DEC_CTX // ps
        table = torch.arange(P, dtype=torch.int32, device=dev).reshape(
            DEC_B, -1)
        pools = [torch.randn((HK, P, ps, D), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2)]
        kw = dict(cache_seqlens=cs, block_table=table, causal=True,
                  kv_cache_layout="HND")
        if kind is None:
            kc, vc = pools
            nbytes = 2 * DEC_B * DEC_CTX * HK * D * 2
        else:
            (kc, ksc), (vc, vsc) = (quantize_kv(x, kind) for x in pools)
            kw.update(k_scales=ksc, v_scales=vsc)
            payload = D // 2 if kind == "int4" else D
            nbytes = 2 * DEC_B * DEC_CTX * HK * (payload + 4)
        del pools
        dt = measure(lambda: flash_attn_with_kvcache(q, kc, vc, **kw),
                     device=dev)
        tag = {None: "bf16", torch.int8: "int8",
               torch.float8_e4m3fn: "fp8", "int4": "int4"}[kind]
        rate = gbps(nbytes, dt)
        extra = "" if base is None else f", {base / dt:.2f}x bf16"
        pages = " (2048-token pages)" if kind == "int4" else ""
        log(f"decode_32k_{tag}: {DEC_B / dt:.0f} tok/s/chip, {rate:.0f} GB/s "
            f"({rate / HBM_GB_PER_S * 100:.0f}% roofline){extra}{pages}")
        base = dt if base is None else base
        del kc, vc, kw
        torch.cuda.empty_cache()


def varlen(dev, gen) -> None:
    lens = [2048] * 8
    T = sum(lens)
    q = torch.randn((T, HQ, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((T, HK, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((T, HK, D), generator=gen, device=dev).to(torch.bfloat16)
    cu = torch.arange(0, T + 1, 2048, dtype=torch.int32, device=dev)
    dt = measure(lambda: flash_attn_varlen_func(
        q, k, v, cu, cu, max(lens), max(lens), causal=True), device=dev)
    fl = sum(4 * HQ * L * L * D // 2 for L in lens)
    log(f"varlen_8x2048_causal_fwd: {tflops(fl, dt):.1f} TF/s")


def serving(dev) -> None:
    """TTFT p50/p90 and decode tok/s from the four pools.  The port
    compiles nothing at run time, so one short request warms the engine
    (the JAX bench's four warm-up waves covered XLA's compiles)."""
    import numpy as np

    cfg = ModelConfig(**SERVE_CFG)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, PLEN).tolist()
               for _ in range(NREQ)]
    log(f"serving config: L={cfg.n_layers} d={cfg.dim} GQA "
        f"{cfg.n_heads}/{cfg.n_kv_heads} D={cfg.head_dim}, {NREQ} reqs x "
        f"{PLEN} prompt, {NEW} new, batch<=16, 128-token pages")
    # (tag, kv_dtype, engine options): quantized pools spend their savings
    # on capacity as in the JAX bench (the same HBM budget holds 2x / 4x
    # the pages); int4 on 512-token pages
    runs = (("bf16", None, {}),
            ("int8", torch.int8,
             dict(num_pages=580, max_batch=24, max_prefill_seqs=8)),
            ("fp8", torch.float8_e4m3fn,
             dict(num_pages=580, max_batch=24, max_prefill_seqs=8)),
            ("int4", "int4",
             dict(num_pages=290, max_batch=24, max_prefill_seqs=8,
                  page_size=512)))
    for tag, kv_dtype, kw in runs:
        opts = dict(max_batch=16, num_pages=290, page_size=128,
                    kv_dtype=kv_dtype, device=dev)
        opts.update(kw)
        eng = ServingEngine(params, cfg, **opts)
        eng.submit(prompts[0][:256], max_new_tokens=4)
        eng.run_to_completion()
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        rids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
        dec_toks, dec_wall = 0, 0.0
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
        dec_wall += time.monotonic() - tf
        wall = time.monotonic() - t0
        ttfts = sorted(eng.ttft(r) for r in rids)
        p50 = ttfts[len(ttfts) // 2]
        p90 = ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.9))]
        if total_new != NREQ * NEW:
            raise RuntimeError(f"serving_{tag}: {total_new} tokens, "
                               f"expected {NREQ * NEW}")
        log(f"serving_{tag}: ttft p50 {p50 * 1e3:.0f} ms / p90 "
            f"{p90 * 1e3:.0f} ms; decode {dec_toks / max(dec_wall, 1e-9):.0f}"
            f" tok/s/chip steady, {total_new / wall:.0f} tok/s/chip e2e")
        del eng
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    def _die(signum, frame):
        log(f"bench watchdog: exceeded {WATCHDOG_S} s")
        sys.exit(3)

    signal.signal(signal.SIGALRM, _die)
    signal.alarm(WATCHDOG_S)
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    head = headline(dev, gen)
    print(json.dumps(head), flush=True)
    torch.cuda.empty_cache()
    prefill_32k(dev, gen)
    torch.cuda.empty_cache()
    decode_32k(dev, gen)
    varlen(dev, gen)
    torch.cuda.empty_cache()
    serving(dev)
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
