#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout (`nvcc`, sm_90a), holds each
kernel against its plain PyTorch version at the shapes the serving engine
gives it, times the kernel, the plain version and one PyTorch library call
computing the same function, then drives the paged serving engine at
TinyLlama-1.1B width (22 layers, bf16, random weights from a seed) through
both kernels and checks its output.  Prints the card, a `kernels` JSON line,
and as its last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
Any failed phase raises and the script exits non-zero; with no GPU, or
without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of one call, CUDA events around each call; the L2
    is flushed before each timed call when `flush` is given."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def make_pool(torch, gen, dev, Hk, n_pages, ps, D, dtype):
    shape = (Hk, n_pages, ps, D)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return k, v


def paged_tables(torch, gen, lens, ps, max_pages, dev):
    """Block tables over a shuffled pool: sequence b owns ceil(len/ps)
    distinct pages; unused slots point at page 0."""
    need = [-(-int(n) // ps) for n in lens]
    perm = torch.randperm(sum(need) + 1, generator=gen, device="cpu")
    perm = perm[perm != 0]
    tbl = torch.zeros((len(lens), max_pages), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        tbl[b, :n] = perm[at:at + n].to(torch.int32)
        at += n
    return tbl.to(dev), sum(need) + 1


# ---------------------------------------------------------------- K4 phase

def gated(torch, out, ref32, ref_native, name, mult=None, atol=None):
    """assert_close_rel against the fp32 plain version; returns the error
    and the gate it was held to (mult x the native plain error + atol)."""
    from flash_attn_v100_tpu_torch.utils import testing as tt
    mult = tt.FWD_MULT if mult is None else mult
    atol = tt.FWD_ATOL if atol is None else atol
    err = tt.assert_close_rel(out, ref32, ref_native, mult, atol, name=name)
    return err, mult * tt.max_abs_err(ref_native, ref32) + atol


def phase_k4(torch, flush):
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ggen = torch.Generator(device=dev).manual_seed(SEED)
    B, Hk, group, D, ps, max_pages = 8, 4, 8, 64, 128, 16
    lens = torch.randint(600, 2001, (B,), generator=gen)
    tbl, n_pages = paged_tables(torch, gen, lens, ps, max_pages, dev)
    kp, vp = make_pool(torch, ggen, dev, Hk, n_pages, ps, D, torch.bfloat16)
    kview, vview = kp[None], vp[None]
    causal0 = masklib.MaskParams(window_right=0)
    prefill = masklib.MaskParams(causal=True, window_right=0)

    cases = {
        # the engine's decode step: T_new = 1, causal -> window_right 0
        "decode": dict(t_new=1, params=causal0, num_splits=0, lens=lens),
        "decode_splits1": dict(t_new=1, params=causal0, num_splits=1,
                               lens=lens),
        "tnew4_window_softcap_alibi": dict(
            t_new=4, params=masklib.MaskParams(
                causal=True, window_left=256, window_right=0, softcap=30.0,
                has_alibi=True), num_splits=0, lens=lens),
        # the engine's short-prompt prefill: 2 rows bucketed to T = 64 from
        # cache length 0 (Rq = 512, causal among the new tokens) ...
        "prefill_tnew64": dict(t_new=64, params=prefill, num_splits=0,
                               lens=torch.tensor([64, 64])),
        # ... and the same behind cached prefixes of 0 and 300 tokens
        "prefill_tnew64_prefix": dict(t_new=64, params=prefill, num_splits=0,
                                      lens=torch.tensor([64, 364])),
    }
    res = {}
    for name, c in cases.items():
        t_new, params = c["t_new"], c["params"]
        n_b = len(c["lens"])
        lens_d = c["lens"].to(dev, torch.int32)
        tbl_c = tbl if c["lens"] is lens else paged_tables(
            torch, gen, c["lens"], ps, max_pages, dev)[0]
        Rq = max(-(-group * t_new // 8) * 8, 8)
        q = torch.randn((n_b, Hk, Rq, D), generator=ggen, device=dev).to(
            torch.bfloat16)
        q[:, :, group * t_new:] = 0
        slopes = None
        if params.has_alibi:
            slopes = torch.rand((n_b, Hk, Rq, 1), generator=ggen,
                                device=dev) * 0.1
        kw = dict(qpos_vec=lens_d - t_new, softmax_scale=D ** -0.5,
                  params=params, t_new=t_new, group=group,
                  num_splits=c["num_splits"], alibi_slopes_rows=slopes)
        lp = torch.zeros(n_b, dtype=torch.int32, device=dev)
        args = (q, kview, vview, tbl_c, lens_d, lp)
        o, lse = dec.merge_partials(*dec.paged_decode_attention(*args, **kw))
        torch.cuda.synchronize()
        o32, lse32 = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, **kw))
        onat, lsenat = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, upcast=False, **kw))
        err, gate = gated(torch, o, o32, onat, f"K4 {name} out")
        fin = torch.isfinite(lse32)
        assert torch.equal(fin, torch.isfinite(lse)), f"K4 {name}: lse -inf rows"
        lse_err, lse_gate = gated(torch, lse[fin], lse32[fin], lsenat[fin],
                                  f"K4 {name} lse")
        res[name] = dict(max_abs_err=err, gate=gate)
        print(f"K4 {name} (B={n_b}, T_new={t_new}, Rq={Rq}, lens="
              f"{c['lens'].tolist() if n_b <= 2 else 'as decode'}): out "
              f"max_abs_err {err:.3e} <= gate {gate:.3e}, lse {lse_err:.3e} "
              f"<= {lse_gate:.3e} (gate: 2 x bf16 plain err vs fp32 plain "
              f"+ 1e-5)")

    # timings at the engine decode shape
    c = cases["decode"]
    Rq = 8
    lens_d = lens.to(dev, torch.int32)
    lp = torch.zeros(B, dtype=torch.int32, device=dev)
    q = torch.randn((B, Hk, Rq, D), generator=ggen, device=dev).to(
        torch.bfloat16)
    kw = dict(qpos_vec=lens_d - 1, softmax_scale=D ** -0.5,
              params=c["params"], t_new=1, group=group, num_splits=0)
    args = (q, kview, vview, tbl, lens_d, lp)
    kernel_ms = time_ms(torch, lambda: dec.paged_decode_attention(*args, **kw),
                        flush=flush)
    plain_ms = time_ms(torch, lambda: dec.paged_decode_attention_ref(
        *args, **kw), reps=5, flush=flush)
    # library yardstick: SDPA over the K/V already gathered to contiguous
    nmax = int(lens.max())
    kc = torch.zeros((B, Hk, nmax, D), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    for b in range(B):
        n = int(lens[b])
        pages = tbl[b, :-(-n // ps)].long()
        kc[b, :, :n] = kp[:, pages].reshape(Hk, -1, D)[:, :n]
        vc[b, :, :n] = vp[:, pages].reshape(Hk, -1, D)[:, :n]
    qs = q[:, :, :group].reshape(B, Hk * group, 1, D)
    mask = (torch.arange(nmax, device=dev)[None, :] < lens_d[:, None].long()
            )[:, None, None, :]
    F = torch.nn.functional
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kc, vc, attn_mask=mask, enable_gqa=True), flush=flush)
    S = dec.resolve_num_splits(0, B, Hk, Rq, max_pages, dev)
    live = int(lens.sum())
    # inputs once, and the output as one fp32 partial + LSE per row (S = 1):
    # the split count is the kernel's choice, not part of the function
    nbytes = (q.numel() * 2 + 2 * live * Hk * D * 2 + tbl.numel() * 4 + B * 12
              + B * Hk * Rq * (D + 1) * 4)
    flops = 4 * live * Hk * group * D
    bms, by = bound_ms(nbytes, flops)
    print(f"K4 decode B={B} Hk={Hk} group={group} D={D} ps={ps} "
          f"lens={lens.tolist()} splits={S}: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
          f"bound {bms:.5f} ms ({by})")
    worst = max(res.values(), key=lambda r: r["max_abs_err"])
    return dict(max_abs_err=worst["max_abs_err"], gate=worst["gate"],
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bms, bound_by=by)


# ---------------------------------------------------------------- K8 phase

def phase_k8(torch, flush):
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    ggen = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, T, Hq, Hk, D, ps = 4, 512, 32, 4, 64, 128
    prefix = torch.tensor([0, 300, 0, 300])
    seqlens = prefix + T
    max_k = int(seqlens.max())
    mp = -(-max_k // ps)
    tbl, n_pages = paged_tables(torch, gen, seqlens, ps, mp, dev)
    kp, vp = make_pool(torch, ggen, dev, Hk, n_pages, ps, D, torch.bfloat16)
    q = torch.randn((B * T, Hq, D), generator=ggen, device=dev).to(
        torch.bfloat16)
    cu_q = torch.arange(B + 1, dtype=torch.int32, device=dev) * T
    seq_d = seqlens.to(dev, torch.int32)
    params = masklib.MaskParams(causal=True, window_right=0)
    args = (q, kp, vp, tbl, cu_q, seq_d, T, max_k, D ** -0.5, params)
    out, lse = vl.flash_attn_varlen_fwd_paged(*args)
    torch.cuda.synchronize()
    o32, lse32 = vl.flash_attn_varlen_fwd_paged_ref(*args)
    onat, lsenat = vl.flash_attn_varlen_fwd_paged_ref(*args, upcast=False)
    err, gate = gated(torch, out, o32, onat, "K8 out")
    lse_err, lse_gate = gated(torch, lse, lse32, lsenat, "K8 lse")
    print(f"K8 prefill: out max_abs_err {err:.3e} <= gate {gate:.3e}, lse "
          f"{lse_err:.3e} <= {lse_gate:.3e} (gate: 2 x bf16 plain err vs "
          f"fp32 plain + 1e-5)")

    kernel_ms = time_ms(torch, lambda: vl.flash_attn_varlen_fwd_paged(*args),
                        flush=flush)
    plain_ms = time_ms(torch, lambda: vl.flash_attn_varlen_fwd_paged_ref(
        *args), reps=5, flush=flush)
    kc = torch.zeros((B, Hk, max_k, D), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    for b in range(B):
        n = int(seqlens[b])
        pages = tbl[b, :-(-n // ps)].long()
        kc[b, :, :n] = kp[:, pages].reshape(Hk, -1, D)[:, :n]
        vc[b, :, :n] = vp[:, pages].reshape(Hk, -1, D)[:, :n]
    qs = q.view(B, T, Hq, D).transpose(1, 2)
    kpos = torch.arange(max_k, device=dev)[None, None, :]
    qpos = torch.arange(T, device=dev)[None, :, None] + prefix.to(dev)[:, None, None]
    mask = (kpos <= qpos)[:, None]                      # bottom-right causal
    F = torch.nn.functional
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kc, vc, attn_mask=mask, enable_gqa=True), flush=flush)
    live_pairs = sum(T * int(p) + T * (T + 1) // 2 for p in prefix)
    flops = 4 * live_pairs * Hq * D
    nbytes = (2 * q.numel() * 2 + Hq * B * T * 4
              + 2 * int(seqlens.sum()) * Hk * D * 2 + tbl.numel() * 4)
    bms, by = bound_ms(nbytes, flops)
    print(f"K8 prefill B={B} T={T} prefixes={prefix.tolist()} Hq={Hq} "
          f"Hk={Hk} D={D} ps={ps}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bms:.5f} ms "
          f"({by})")
    return dict(max_abs_err=err, gate=gate, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bms, bound_by=by)


# ------------------------------------------------------------ engine phase

ENGINE_LOGITS_MULT, ENGINE_LOGITS_ATOL = 2.0, 1e-5
ENGINE_LOGITS_GATE = ("assert_close_rel(mult=2, atol=1e-5): kernel-path logits "
                      "vs fp32-plain-attention logits within 2x the "
                      "bf16-plain-attention logits' distance")
# the engine run: LONG prompts prefill first (K8 route), then SHORT prompts
# arrive (K4 prefill route, T bucket 64) and all decode N_NEW tokens greedily
N_LONG, LONG_LEN, SHORT_LENS, N_NEW = 6, 512, (40, 25), 32
PAGE_SIZE, NUM_PAGES = 128, 64


def phase_engine(torch, cfg):
    """ServingEngine at `cfg` through both kernels; the first prefill step
    of each route is replayed with the plain attention versions."""
    import functools
    import numpy as np
    from flash_attn_v100_tpu_torch import ServingEngine
    from flash_attn_v100_tpu_torch.models.transformer import init_params
    from flash_attn_v100_tpu_torch.ops import kvcache as kv_mod
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    from flash_attn_v100_tpu_torch.runtime import engine as eng_mod

    params = init_params(cfg, seed=SEED, device="cuda", lm_head=True)
    eng = ServingEngine(params, cfg, max_batch=N_LONG + len(SHORT_LENS),
                        num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                        device="cuda")
    assert eng.sched.is_native, "the native scheduler must be in use"
    rng = np.random.default_rng(SEED)
    long_prompts = [rng.integers(1, cfg.vocab_size, LONG_LEN).tolist()
                    for _ in range(N_LONG)]
    short_prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                     for n in SHORT_LENS]

    # capture the first prefill (T > 1) step of each route: the pools
    # before it, its inputs and its logits
    real_pf = eng_mod.paged_forward
    cap = {}

    def spy(params_, k_pool, v_pool, tokens, cs, bt, cfg_, **kw):
        route = eng_mod._route(cfg_, tokens.shape[1], k_pool.shape[2])
        if route in cap or tokens.shape[1] == 1:
            return real_pf(params_, k_pool, v_pool, tokens, cs, bt, cfg_, **kw)
        c = cap[route] = dict(k=k_pool.clone(), v=v_pool.clone(), kw=kw,
                              args=(tokens.clone(), cs.clone(), bt.clone()))
        out = real_pf(params_, k_pool, v_pool, tokens, cs, bt, cfg_, **kw)
        c["logits"] = out[0].clone()
        return out

    dec.paged_decode_attention.launches = 0
    vl.flash_attn_varlen_fwd_paged.launches = 0
    eng_mod.paged_forward.calls.update(decode=0, varlen=0)
    eng_mod.paged_forward = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=N_NEW) for p in long_prompts]
        eng.step()                       # 6 x 512-token prefill: K8 route
        rids += [eng.submit(p, max_new_tokens=N_NEW) for p in short_prompts]
        eng.step()                       # short prefills (K4) + 6 decodes
        torch.cuda.synchronize()
        t_a, tok_a = time.perf_counter(), eng.metrics["tokens_generated"]
        out = eng.run_to_completion()
        torch.cuda.synchronize()
        t_b, tok_b = time.perf_counter(), eng.metrics["tokens_generated"]
    finally:
        eng_mod.paged_forward = real_pf
    launches = {"decode": dec.paged_decode_attention.launches,
                "varlen": vl.flash_attn_varlen_fwd_paged.launches}
    calls = dict(eng_mod.paged_forward.calls)

    assert sorted(out) == sorted(rids), "every request must finish"
    for rid in rids:
        toks = out[rid]
        assert len(toks) == N_NEW, (rid, len(toks))
        assert all(0 <= t < cfg.vocab_size for t in toks)
    L = cfg.n_layers
    for route in ("decode", "varlen"):
        assert calls[route] > 0 and launches[route] > 0, (calls, launches)
        assert launches[route] == L * calls[route], (route, launches, calls)
    assert sorted(cap) == ["decode", "varlen"], sorted(cap)

    # each captured prefill step again, with the plain attention versions
    def replay(c, decode_fn, varlen_fn):
        saved = (kv_mod.paged_decode_attention,
                 kv_mod.flash_attn_varlen_fwd_paged)
        kv_mod.paged_decode_attention = decode_fn
        kv_mod.flash_attn_varlen_fwd_paged = varlen_fn
        try:
            return real_pf(params, c["k"].clone(), c["v"].clone(),
                           *c["args"], cfg, **c["kw"])[0]
        finally:
            (kv_mod.paged_decode_attention,
             kv_mod.flash_attn_varlen_fwd_paged) = saved

    errs = {}
    for route in ("varlen", "decode"):
        c = cap[route]
        plain32 = replay(c, dec.paged_decode_attention_ref,
                         vl.flash_attn_varlen_fwd_paged_ref)
        plain16 = replay(
            c, functools.partial(dec.paged_decode_attention_ref, upcast=False),
            functools.partial(vl.flash_attn_varlen_fwd_paged_ref,
                              upcast=False))
        logits = c["logits"]
        assert logits.shape == plain32.shape and torch.isfinite(logits).all()
        err, gate = gated(torch, logits, plain32, plain16,
                          f"first {route}-route prefill logits",
                          ENGINE_LOGITS_MULT, ENGINE_LOGITS_ATOL)
        errs[route] = err
        tokens = c["args"][0]
        print(f"engine: first {route}-route prefill (tokens "
              f"{tuple(tokens.shape)}) logits max_abs_err {err:.4e} <= gate "
              f"{gate:.4e} vs fp32 plain ({ENGINE_LOGITS_GATE})")
    assert launches["varlen"] == vl.flash_attn_varlen_fwd_paged.launches
    assert launches["decode"] == dec.paged_decode_attention.launches

    ttfts = [eng.ttft(r) for r in rids]
    ttft_p50_ms = statistics.median(ttfts) * 1e3
    decode_tok_s = (tok_b - tok_a) / (t_b - t_a)
    print(f"engine: {cfg.n_layers} layers, dim {cfg.dim}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.head_dim}, {cfg.dtype}, untied "
          f"lm_head; {len(rids)} requests ({N_LONG} x {LONG_LEN} + "
          f"{list(SHORT_LENS)} prompt tokens, {N_NEW} new each, greedy), "
          f"max_batch {eng.max_batch}, page_size {PAGE_SIZE}")
    print(f"engine: forward calls {calls}, kernel launches {launches}")
    print(f"engine: TTFT p50 {ttft_p50_ms:.2f} ms (first-wave "
          f"{statistics.median(ttfts[:N_LONG]) * 1e3:.2f} ms, second-wave "
          f"{statistics.median(ttfts[N_LONG:]) * 1e3:.2f} ms), steady decode "
          f"{decode_tok_s:.1f} tok/s ({tok_b - tok_a} tokens in "
          f"{t_b - t_a:.3f} s), total {t_b - t0:.3f} s")
    prof = profile_decode(torch, eng, cfg)
    return dict(launches=launches, ttft_p50_ms=ttft_p50_ms,
                decode_tok_s=decode_tok_s, logits_err=errs, profile=prof)


def profile_decode(torch, eng, cfg, prompt_len=64, n_new=17):
    """Where a steady decode step's time goes: one fused window of decode
    steps at full batch under torch.profiler (CPU + CUDA activities)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 2)
    for _ in range(eng.max_batch):
        eng.submit(rng.integers(1, cfg.vocab_size, prompt_len).tolist(),
                   max_new_tokens=n_new)
    eng.step()                                  # prefill
    eng.step()                                  # first (unfused) decode
    torch.cuda.synchronize()
    tok0 = eng.metrics["tokens_generated"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()                              # one fused window
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_steps = (eng.metrics["tokens_generated"] - tok0) // eng.max_batch
    eng.run_to_completion()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    res = dict(steps=n_steps, wall_ms_per_step=wall * 1e3 / max(n_steps, 1),
               busy_ms_per_step=busy_us / 1e3 / max(n_steps, 1),
               launches_per_step=len(kernels) / max(n_steps, 1))
    print(f"decode profile (torch.profiler, batch {eng.max_batch}, one fused "
          f"window of {n_steps} steps): wall {res['wall_ms_per_step']:.3f} "
          f"ms/step, device busy {res['busy_ms_per_step']:.3f} ms/step "
          f"({100 * busy_us / 1e3 / max(wall * 1e3, 1e-9):.1f}%), "
          f"{res['launches_per_step']:.0f} kernel launches/step")
    for name, us in top:
        print(f"  {us / 1e3 / max(n_steps, 1):8.3f} ms/step  {name[:90]}")
    return res


# -------------------------------------------------------------------- main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from flash_attn_v100_tpu_torch.ops.cuda import build

    card = card_line()
    print(f"card: {card}", flush=True)
    # fp32 matmuls stay full fp32 (no TF32) in the plain references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc per source, "
          f"concurrent: {built})", flush=True)
    for name in build.SOURCES:
        log = build.build_log(name).splitlines()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in log
                if "registers" in ln and "Used " in ln]
        stack = [ln.strip() for ln in log if "stack frame" in ln
                 and not ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                               "spill stores, 0 bytes spill")]
        print(f"build {name}: {len(regs)} kernels, registers "
              f"{min(regs)}-{max(regs)}, stack/spills: {stack or 'none'}",
              flush=True)

    flush = torch.empty(64 * 2 ** 20 // 4, device="cuda")   # > 50 MB L2
    k4 = phase_k4(torch, flush)
    k8 = phase_k8(torch, flush)
    del flush
    from flash_attn_v100_tpu_torch import ModelConfig
    eng = phase_engine(torch, ModelConfig.tinyllama_1b())

    kernels = []
    for name, res, src, replaces, key in (
            ("K4 paged_decode_attention", k4, "decode.cu",
             "flash_attn_v100_tpu/ops/pallas/decode.py:72", "decode"),
            ("K8 flash_attn_varlen_fwd_paged", k8, "varlen_paged.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:947", "varlen")):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"flash_attn_v100_tpu_torch/csrc/{src}", replaces=replaces,
            launches=eng["launches"][key], max_abs_err=res["max_abs_err"],
            max_abs_err_gate=res["gate"],
            ms=res["ms"], plain_ms=res["plain_ms"],
            bound_ms=res["bound_ms"], bound_by=res["bound_by"],
            library_ms=res["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
