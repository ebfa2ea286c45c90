"""Hardware oracle sweep of KV-cache decode (K4, K4q), the counterpart of
the JAX repository's `benchmarks/sweep_decode.py` on the card.

Gates, through `flash_attn_with_kvcache`:
  * a 32k-context paged decode with rotary and an appended token (HND page
    pool, page 512, 32/8 heads x 128) from a bf16 pool against the fp32
    oracle with the reference's tolerance model (<= 2 x the bf16 oracle's
    error + 1e-5), and from int8 (<= 0.1 max abs against the unquantized
    oracle), int4 (<= 0.3) and fp8 e4m3 (<= 0.1, no append) pools;
  * contiguous caches: a T = 3 append, leftpad and a window;
  * split-KV consistency: num_splits 0, 1 and 4 within 5e-3.
Without --quick (an 8k context) it also times the 32k decode at B 8 from a
bf16 pool and prints its rate against the card's 3.35 TB/s.

    python -m flash_attn_v100_tpu_torch.benchmarks.sweep_decode [--quick]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    HBM_BYTES_PER_S, normal, run_device)
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.quant import quantize_kv
from flash_attn_v100_tpu_torch.ops.reference import mha_reference_kvcache
from flash_attn_v100_tpu_torch.utils.benchmarking import gbps, measure
from flash_attn_v100_tpu_torch.utils.testing import (
    FWD_ATOL, FWD_MULT, max_abs_err)

SEED = 421
SPLIT_TOL = 5e-3
QUANT_GATE = {"int8": 0.1, "int4": 0.3, "fp8": 0.1}
QUANT_DTYPE = {"int8": torch.int8, "int4": "int4",
               "fp8": torch.float8_e4m3fn}
THROUGHPUT_B = 8


def _oracle(q, kc_hnd, vc_hnd, **kw):
    """(fp32, same-dtype) oracle outputs over head-major contiguous caches."""
    kc, vc = kc_hnd.transpose(1, 2), vc_hnd.transpose(1, 2)
    o32 = mha_reference_kvcache(q, kc, vc, upcast=True, **kw)[0]
    onat = mha_reference_kvcache(q, kc, vc, upcast=False, **kw)[0]
    return o32, onat


def gate(name, out, o32, onat, flat=None) -> bool:
    e, en = max_abs_err(out, o32), max_abs_err(onat, o32)
    ok = e <= (FWD_MULT * en + FWD_ATOL if flat is None else flat)
    print(f"{'PASS' if ok else 'FAIL'} decode {name}: err={e:.2e} "
          f"(native {en:.2e}{'' if flat is None else f', gate {flat}'})",
          flush=True)
    return ok


def run_cases(rng, ctx, B=2, Hq=32, Hk=8, D=128, ps=512, device="cuda"
              ) -> int:
    """Every gated case, inputs drawn from `rng` in the JAX script's order;
    returns the number that failed."""
    dev = torch.device(device)

    def mkb(*s):
        return normal(rng, s, dev)
    fails = 0

    # ---- 32k ctx paged + rotary + append, from each pool ----
    P_ = B * (ctx + ps) // ps
    kpool, vpool = mkb(Hk, P_, ps, D), mkb(Hk, P_, ps, D)
    table = torch.arange(P_, dtype=torch.int32, device=dev).reshape(B, -1)
    # the second row's live length is not page-aligned
    cs = torch.tensor([ctx, ctx - min(12345, ctx // 2 + 123)],
                      dtype=torch.int32, device=dev)
    qd = mkb(B, 1, Hq, D)
    kn, vn = mkb(B, 1, Hk, D), mkb(B, 1, Hk, D)
    cos = mkb(ctx + ps, D // 2)
    sin = mkb(ctx + ps, D // 2)
    rot = dict(rotary_cos=cos, rotary_sin=sin, cache_seqlens=cs,
               causal=True)
    # the oracle on the equivalent contiguous cache (an iota table: a
    # reshape); the kernels append into copies of the pools
    kc = kpool.reshape(Hk, B, ctx + ps, D).transpose(0, 1)
    vc = vpool.reshape(Hk, B, ctx + ps, D).transpose(0, 1)
    t0 = time.time()
    out, _ = flash_attn_with_kvcache(
        qd, kpool.clone(), vpool.clone(), k=kn, v=vn, block_table=table,
        kv_cache_layout="HND", **rot)
    o32, onat = _oracle(qd, kc, vc, k_new=kn, v_new=vn, **rot)
    fails += not gate(f"paged+rotary+append {ctx // 1024}k bf16", out, o32,
                      onat)
    print(f"  ({time.time() - t0:.1f}s)", flush=True)
    for kind in ("int8", "int4"):
        t0 = time.time()
        kq, ks = quantize_kv(kpool, QUANT_DTYPE[kind])
        vq, vs = quantize_kv(vpool, QUANT_DTYPE[kind])
        outq = flash_attn_with_kvcache(
            qd, kq, vq, k=kn, v=vn, block_table=table, k_scales=ks,
            v_scales=vs, kv_cache_layout="HND", **rot)[0]
        fails += not gate(f"paged+rotary+append {ctx // 1024}k "
                          f"{kind.upper()}", outq, o32, onat,
                          flat=QUANT_GATE[kind])
        print(f"  ({time.time() - t0:.1f}s)", flush=True)
        del kq, vq, ks, vs
    t0 = time.time()
    kq, ks = quantize_kv(kpool, QUANT_DTYPE["fp8"])
    vq, vs = quantize_kv(vpool, QUANT_DTYPE["fp8"])
    outf8 = flash_attn_with_kvcache(
        qd, kq, vq, cache_seqlens=cs, block_table=table, causal=True,
        k_scales=ks, v_scales=vs, kv_cache_layout="HND")
    o32n, onatn = _oracle(qd, kc, vc, cache_seqlens=cs, causal=True)
    fails += not gate(f"paged {ctx // 1024}k FP8-e4m3", outf8, o32n, onatn,
                      flat=QUANT_GATE["fp8"])
    print(f"  ({time.time() - t0:.1f}s)", flush=True)
    del kpool, vpool, kc, vc, kq, vq, ks, vs

    # ---- contiguous caches: T_new = 3 append, leftpad, window ----
    t0 = time.time()
    kcc, vcc = mkb(B, Hk, 2048, D), mkb(B, Hk, 2048, D)
    cs2 = torch.tensor([1200, 333], dtype=torch.int32, device=dev)
    q3 = mkb(B, 3, Hq, D)
    k3, v3 = mkb(B, 3, Hk, D), mkb(B, 3, Hk, D)
    out, _ = flash_attn_with_kvcache(
        q3, kcc.clone(), vcc.clone(), k=k3, v=v3, cache_seqlens=cs2,
        causal=True, kv_cache_layout="HND")
    o32, onat = _oracle(q3, kcc, vcc, k_new=k3, v_new=v3, cache_seqlens=cs2,
                        causal=True)
    fails += not gate("contig T3 append", out, o32, onat)

    lp = torch.tensor([64, 0], dtype=torch.int32, device=dev)
    out = flash_attn_with_kvcache(q3, kcc, vcc, cache_seqlens=cs2,
                                  cache_leftpad=lp, causal=True,
                                  kv_cache_layout="HND")
    o32, onat = _oracle(q3, kcc, vcc, cache_seqlens=cs2, cache_leftpad=lp,
                        causal=True)
    fails += not gate("contig leftpad", out, o32, onat)

    window = (500, -1)
    out = flash_attn_with_kvcache(q3, kcc, vcc, cache_seqlens=cs2,
                                  causal=True, window_size=window,
                                  kv_cache_layout="HND")
    o32, onat = _oracle(q3, kcc, vcc, cache_seqlens=cs2, causal=True,
                        window_size=window)
    fails += not gate("contig window", out, o32, onat)
    print(f"  ({time.time() - t0:.1f}s)", flush=True)

    # ---- split-KV consistency ----
    t0 = time.time()
    outs = [flash_attn_with_kvcache(q3, kcc, vcc, cache_seqlens=cs2,
                                    causal=True, num_splits=s,
                                    kv_cache_layout="HND")
            for s in (0, 1, 4)]
    e = max(max_abs_err(outs[0], o) for o in outs[1:])
    ok = e <= SPLIT_TOL
    print(f"{'PASS' if ok else 'FAIL'} decode split-KV consistency: "
          f"max delta {e:.2e}  ({time.time() - t0:.1f}s)", flush=True)
    return fails + (not ok)


def throughput(rng, ctx, Hq=32, Hk=8, D=128, ps=512, device="cuda") -> dict:
    """The 32k decode at B 8 from a bf16 page pool: seconds a call and its
    rate against the card's memory rate (K and V read once)."""
    dev = torch.device(device)
    B2 = THROUGHPUT_B
    P2 = B2 * ctx // ps

    def mkb(*s):
        return normal(rng, s, dev)
    kp2, vp2 = mkb(Hk, P2, ps, D), mkb(Hk, P2, ps, D)
    t2 = torch.arange(P2, dtype=torch.int32, device=dev).reshape(B2, -1)
    c2 = torch.full((B2,), ctx, dtype=torch.int32, device=dev)
    q2 = mkb(B2, 1, Hq, D)
    dt = measure(lambda: flash_attn_with_kvcache(
        q2, kp2, vp2, cache_seqlens=c2, block_table=t2, causal=True,
        kv_cache_layout="HND"), iters=32, device=dev)
    nbytes = 2 * B2 * ctx * Hk * D * 2
    rate = gbps(nbytes, dt)
    print(f"decode {ctx // 1024}k bf16 B {B2}: {dt * 1e3:.4f} ms, "
          f"{B2 / dt:.0f} tok/s  {rate:.0f} GB/s "
          f"({rate * 1e9 / HBM_BYTES_PER_S * 100:.1f}% of 3.35 TB/s)",
          flush=True)
    return dict(ms=dt * 1e3, gbps=rate)


def main(quick: bool = False, device: str = "cuda") -> int:
    """Run the cases (an 8k context with `quick`, else 32k, then the
    throughput line); returns the number that failed."""
    dev = run_device(device)
    rng = np.random.default_rng(SEED)
    print(f"sweep_decode: device={dev}", flush=True)
    ctx = 8192 if quick else 32768
    fails = run_cases(rng, ctx, device=dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not quick:
        throughput(rng, ctx, device=dev)
    print(f"sweep_decode: {'OK' if fails == 0 else f'{fails} FAILURES'}",
          flush=True)
    return fails


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    sys.exit(1 if main(ap.parse_args().quick) else 0)
