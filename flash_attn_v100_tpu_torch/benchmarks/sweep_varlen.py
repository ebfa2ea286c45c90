"""Hardware oracle sweep of packed varlen attention (K5 forward, K6/K7
backward, K8 over a page pool), the counterpart of the JAX repository's
`benchmarks/sweep_varlen.py` on the card.

Each case (mixed 37-4096 lengths, equal lengths, cross-attention lengths, a
window, softcap, ALiBi; 32/8 heads x 128, bf16) runs forward and backward
through `flash_attn_varlen_func` and is gated with the reference's
relative tolerance model against the fp32 oracle (forward <= 2 x the bf16
oracle's error + 1e-5, each gradient <= 3 x + 1e-4).  The oracle runs one
sequence at a time, sliced over heads to half the device's free memory.
Then the in-kernel paged prefill over an HND page pool against the oracle,
and (without --quick) its time against the packed-contiguous forward
(gate: at least 80% of its speed).  Last, a case of the port's own (the
JAX script has none): the same pool quantized to int8, fp8 and int4
payloads with per-token scales, prefilled through flash_attn_with_kvcache's
paged route (K8q, one launch each) and held to the fp32 oracle over the
dequantized pool within the JAX package's quantized gates (0.1 for int8
and fp8, 0.3 for int4).

    python -m flash_attn_v100_tpu_torch.benchmarks.sweep_varlen [--quick]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    gate, normal, oracle, oracle_budget, run_device)
from flash_attn_v100_tpu_torch.ops import quant
from flash_attn_v100_tpu_torch.ops.cuda import varlen as cuda_varlen
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func
from flash_attn_v100_tpu_torch.utils.benchmarking import measure, tflops
from flash_attn_v100_tpu_torch.utils.testing import (
    BWD_ATOL, BWD_MULT, FWD_ATOL, FWD_MULT)

CASES = [
    # (name, lens_q, lens_k, kwargs)
    ("mixed-causal", [128, 512, 1024, 4096, 2048, 300, 37, 4096], None,
     dict(causal=True)),
    ("mixed-full", [128, 512, 1024, 4096, 2048, 300, 37, 4096], None,
     dict(causal=False)),
    ("equal-8x2048-causal", [2048] * 8, None, dict(causal=True)),
    ("cross-lens", [16, 48, 333], [128, 96, 999], dict(causal=False)),
    ("window", [700, 1500, 64], None,
     dict(causal=True, window_size=(256, -1))),
    ("softcap", [512, 1024], None, dict(causal=True, softcap=30.0)),
    ("alibi", [512, 777], None, dict(causal=True, alibi_slopes="auto")),
]
QUICK = [CASES[0], CASES[3], CASES[4]]
SEED = 421
PAGED_MIN_SPEED = 0.8          # paged prefill vs the contiguous forward
# the quantized paged case's payloads and their gates against the fp32
# oracle over the dequantized pool (the JAX package's tests/test_quant.py)
QUANT_GATES = {"int8": (torch.int8, 0.1), "fp8": (torch.float8_e4m3fn, 0.1),
               "int4": ("int4", 0.3)}


def _cu(lens, dev):
    return torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]),
                           dtype=torch.int32).to(dev)


def packed_oracle(q, k, v, do, lens_q, lens_k, upcast, budget, **kw):
    """The oracle's packed output and, given `do`, its gradients: each
    sequence through common.oracle."""
    cu_q, cu_k = np.cumsum([0] + list(lens_q)), np.cumsum([0] + list(lens_k))
    cd = torch.float32 if upcast else q.dtype
    out = q.new_zeros(q.shape, dtype=cd)
    grads = (None if do is None
             else [x.new_zeros(x.shape, dtype=cd) for x in (q, k, v)])
    for b in range(len(lens_q)):
        sq = slice(int(cu_q[b]), int(cu_q[b + 1]))
        sk = slice(int(cu_k[b]), int(cu_k[b + 1]))
        o, g = oracle(q[sq][None], k[sk][None], v[sk][None],
                      None if do is None else do[sq][None], upcast, budget,
                      **kw)
        out[sq] = o[0]
        if g is not None:
            for dst, gb, s in zip(grads, g, (sq, sk, sk)):
                dst[s] = gb[0]
    return out, grads


def run_case(rng, name, lens_q, lens_k, kw, Hq=32, Hk=8, D=128,
             do_time=False, device="cuda"):
    """One case, inputs drawn from `rng` in the JAX script's order; prints
    its line and returns whether it passed."""
    dev = torch.device(device)
    lens_k = lens_k or lens_q
    Tq, Tk = sum(lens_q), sum(lens_k)
    kw = dict(kw)

    def mk(*s):
        return normal(rng, s, dev)
    q, k, v = mk(Tq, Hq, D), mk(Tk, Hk, D), mk(Tk, Hk, D)
    cu_q, cu_k = _cu(lens_q, dev), _cu(lens_k, dev)
    if kw.get("alibi_slopes") == "auto":
        kw["alibi_slopes"] = torch.as_tensor(
            rng.uniform(0.01, 0.2, (Hq,)), dtype=torch.float32).to(dev)
    budget = oracle_budget(dev)

    def fwd(q, k, v):
        return flash_attn_varlen_func(q, k, v, cu_q, cu_k, max(lens_q),
                                      max(lens_k), **kw)
    with torch.no_grad():
        out = fwd(q, k, v)
        ref32, _ = packed_oracle(q, k, v, None, lens_q, lens_k, True,
                                 budget, **kw)
        refnat, _ = packed_oracle(q, k, v, None, lens_q, lens_k, False,
                                  budget, **kw)
    e, en, fwd_ok = gate(out, ref32, refnat, FWD_MULT, FWD_ATOL)
    del ref32, refnat

    do = mk(*out.shape)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fwd(*leaves).backward(do)
    _, g32 = packed_oracle(q, k, v, do, lens_q, lens_k, True, budget, **kw)
    _, gn = packed_oracle(q, k, v, do, lens_q, lens_k, False, budget, **kw)
    bwd_ok = True
    errs = []
    for x, r32, rn in zip(leaves, g32, gn):
        ge, gne, ok = gate(x.grad, r32, rn, BWD_MULT, BWD_ATOL)
        errs.append((ge, gne))
        bwd_ok &= ok
    del leaves, g32, gn
    extra = ""
    if do_time:
        with torch.no_grad():
            dt = measure(fwd, q, k, v, iters=8, device=dev)
        fl = sum(4 * Hq * lq * lk * D // (2 if kw.get("causal") else 1)
                 for lq, lk in zip(lens_q, lens_k))
        extra = f"  fwd {dt * 1e3:.4f} ms {tflops(fl, dt):.1f} TF/s"
    ok = fwd_ok and bwd_ok
    print(f"{'PASS' if ok else 'FAIL'} varlen {name}: fwd_err={e:.2e} "
          f"(native {en:.2e}) bwd_errs=dq/dk/dv "
          + " ".join(f"{a:.2e} (native {b:.2e})" for a, b in errs)
          + extra, flush=True)
    return ok


def run_paged_case(rng, do_time=False, device="cuda", Hq=32, Hk=8, D=128,
                   ps=256, lens_q=(512, 2048, 300, 1024),
                   lens_k=(700, 2048, 300, 1500)):
    """The in-kernel paged HND prefill (no K/V gather) against the oracle,
    timed (`do_time`) against the packed-contiguous forward."""
    dev = torch.device(device)
    Tq, Tk = sum(lens_q), sum(lens_k)

    def mk(*s):
        return normal(rng, s, dev)
    q, k, v = mk(Tq, Hq, D), mk(Tk, Hk, D), mk(Tk, Hk, D)
    cu_q, cu_k = _cu(lens_q, dev), _cu(lens_k, dev)
    # scatter the packed K/V into pool pages; page 0 stays unused
    B = len(lens_k)
    ppseq = [-(-L // ps) for L in lens_k]
    kp = k.new_zeros((Hk, sum(ppseq) + 1, ps, D))
    vp = torch.zeros_like(kp)
    bt = torch.zeros((B, max(ppseq)), dtype=torch.int32)
    nxt, off = 1, 0
    for b, L in enumerate(lens_k):
        for j in range(ppseq[b]):
            n = min(ps, L - j * ps)
            kp[:, nxt, :n] = k[off + j * ps: off + j * ps + n].transpose(0, 1)
            vp[:, nxt, :n] = v[off + j * ps: off + j * ps + n].transpose(0, 1)
            bt[b, j] = nxt
            nxt += 1
        off += L
    bt = bt.to(dev)

    def paged():
        return flash_attn_varlen_func(
            q, kp, vp, cu_q, cu_k, max(lens_q), max(lens_k), causal=True,
            block_table=bt, kv_cache_layout="HND")

    def contiguous():
        return flash_attn_varlen_func(q, k, v, cu_q, cu_k, max(lens_q),
                                      max(lens_k), causal=True)
    budget = oracle_budget(dev)
    with torch.no_grad():
        out = paged()
        ref32, _ = packed_oracle(q, k, v, None, lens_q, lens_k, True,
                                 budget, causal=True)
        refnat, _ = packed_oracle(q, k, v, None, lens_q, lens_k, False,
                                  budget, causal=True)
        e, en, ok = gate(out, ref32, refnat, FWD_MULT, FWD_ATOL)
        extra = ""
        if do_time:
            dtp = measure(paged, iters=8, device=dev)
            dtc = measure(contiguous, iters=8, device=dev)
            extra = (f"  paged {dtp * 1e3:.4f} ms vs contiguous "
                     f"{dtc * 1e3:.4f} ms ({dtc / dtp * 100:.0f}% of "
                     f"contiguous speed)")
            ok = ok and dtp <= dtc / PAGED_MIN_SPEED
    print(f"{'PASS' if ok else 'FAIL'} varlen paged-HND in-kernel: "
          f"fwd_err={e:.2e} (native {en:.2e}){extra}", flush=True)
    return ok


def run_paged_quant_case(rng, kind, device="cuda", Hq=32, Hk=8, D=128,
                         ps=256, T=512, lens_k=(700, 2048, 600, 1500)):
    """K8q: T new q rows a sequence behind caches of `lens_k` tokens in an
    HND pool of payload `kind` with per-token scales, through
    flash_attn_with_kvcache's paged route (counted: one K8q launch on the
    card), against the fp32 oracle over the dequantized pool (the K/V the
    payloads stand for), causal, within QUANT_GATES[kind]."""
    dev = torch.device(device)
    B = len(lens_k)

    def mk(*s):
        return normal(rng, s, dev)
    q = mk(B, T, Hq, D)
    ppseq = [-(-L // ps) for L in lens_k]
    kp = mk(Hk, sum(ppseq) + 1, ps, D)
    vp = mk(Hk, sum(ppseq) + 1, ps, D)
    bt = torch.zeros((B, max(ppseq)), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(ppseq):
        bt[b, :n] = torch.arange(nxt, nxt + n)
        nxt += n
    bt = bt.to(dev)
    dtype, tol = QUANT_GATES[kind]
    (kq, ks), (vq, vs) = (quant.quantize_kv(x, dtype) for x in (kp, vp))
    kd, vd = (quant.dequantize_kv(p, sc, torch.float32, int4=kind == "int4")
              for p, sc in ((kq, ks), (vq, vs)))
    before = cuda_varlen.flash_attn_varlen_fwd_paged.quant_launches[kind]
    with torch.no_grad():
        out = flash_attn_with_kvcache(
            q, kq, vq, cache_seqlens=torch.tensor(lens_k, dtype=torch.int32,
                                                  device=dev),
            block_table=bt, causal=True, kv_cache_layout="HND",
            k_scales=ks, v_scales=vs)
        launched = (cuda_varlen.flash_attn_varlen_fwd_paged
                    .quant_launches[kind] - before)
        err = 0.0
        budget = oracle_budget(dev)
        for b, L in enumerate(lens_k):
            rows = bt[b, :ppseq[b]].long()
            kb, vb = (x[:, rows].reshape(Hk, -1, D)[:, :L].transpose(0, 1)
                      for x in (kd, vd))
            ref, _ = oracle(q[b:b + 1].float(), kb[None], vb[None], None, True,
                            budget, causal=True)
            err = max(err, float((out[b].float() - ref[0]).abs().max()))
    ok = err <= tol and (dev.type != "cuda" or launched == 1)
    print(f"{'PASS' if ok else 'FAIL'} varlen paged-HND {kind} pool (K8q, "
          f"{launched} launch): err vs the fp32 oracle over the dequantized "
          f"pool {err:.2e} <= {tol}", flush=True)
    return ok


def main(quick: bool = False, device: str = "cuda") -> int:
    """Run the cases (QUICK with `quick`) and the paged case; returns the
    number that failed."""
    dev = run_device(device)
    rng = np.random.default_rng(SEED)
    print(f"sweep_varlen: device={dev}", flush=True)
    n_fail = 0
    for name, lens_q, lens_k, kw in (QUICK if quick else CASES):
        t0 = time.time()
        n_fail += not run_case(rng, name, lens_q, lens_k, kw,
                               do_time=name.startswith(("mixed", "equal")),
                               device=dev)
        print(f"  ({time.time() - t0:.1f}s)", flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    t0 = time.time()
    n_fail += not run_paged_case(rng, do_time=not quick, device=dev)
    print(f"  ({time.time() - t0:.1f}s)", flush=True)
    for kind in QUANT_GATES:
        t0 = time.time()
        n_fail += not run_paged_quant_case(rng, kind, device=dev)
        print(f"  ({time.time() - t0:.1f}s)", flush=True)
    print(f"sweep_varlen: {'OK' if n_fail == 0 else f'{n_fail} FAILURES'}",
          flush=True)
    return n_fail


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    sys.exit(1 if main(ap.parse_args().quick) else 0)
