"""`flash_attn_with_kvcache` on the card against the fp32 oracle across the
decode's interior and boundary tiles (K4, K4q), the counterpart of the JAX
repository's `benchmarks/verify_decode_fastpath.py`: causal, window,
leftpad, T_new > 1 with an append, ALiBi, int8 and int4 caches, and paged
caches (token-major NHD layouts, 8/2 heads x 128, B 3, 1536 tokens).  A
case passes when its max abs error over the oracle's max abs value is
below the case's tolerance; quantized caches are held against the oracle
over the dequantized cache.

    python -m flash_attn_v100_tpu_torch.benchmarks.verify_decode_fastpath
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import normal, run_device
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.quant import dequantize_kv, quantize_kv
from flash_attn_v100_tpu_torch.ops.reference import mha_reference_kvcache
from flash_attn_v100_tpu_torch.utils.testing import max_abs_err

SEED = 7
PAGE = 256
CASES = [
    ("dense-causal", dict(causal=True)),
    ("dense-noncausal", dict()),
    ("window", dict(window=(384, -1), causal=True)),
    ("leftpad-causal", dict(leftpad=True, causal=True)),
    ("tnew4-append-causal", dict(t_new=4, append=True, causal=True)),
    ("alibi", dict(alibi=True, causal=True)),
    ("int8-causal", dict(quant="int8", causal=True, tol=4e-2)),
    ("int4-causal", dict(quant="int4", causal=True, tol=8e-2)),
    ("paged-causal", dict(paged=True, causal=True)),
    ("paged-int8", dict(paged=True, quant="int8", causal=True, tol=4e-2)),
    ("paged-window", dict(paged=True, window=(500, -1), causal=True)),
]


def run_case(rng, name, *, causal=False, window=(-1, -1), leftpad=False,
             t_new=1, alibi=False, quant=None, paged=False, N=1536, B=3,
             Hq=8, Hk=2, D=128, append=False, tol=2.5e-2, device="cuda"):
    """One case, inputs drawn from `rng` in the JAX script's order; prints
    its line and returns whether it passed."""
    dev = torch.device(device)

    def mk(*s):
        return normal(rng, s, dev)
    q = mk(B, t_new, Hq, D)
    kc = mk(B, N, Hk, D)
    vc = mk(B, N, Hk, D)
    used = rng.integers(N // 3, N - t_new - 8, B).astype(np.int32)
    lp = rng.integers(0, 32, B).astype(np.int32) if leftpad else None
    kn = vn = None
    if append:
        kn, vn = mk(B, t_new, Hk, D), mk(B, t_new, Hk, D)
    slopes = (torch.as_tensor(rng.uniform(0.01, 0.2, Hq),
                              dtype=torch.float32).to(dev)
              if alibi else None)
    cs = torch.as_tensor(used).to(dev)
    lpt = None if lp is None else torch.as_tensor(lp).to(dev)

    bt = None
    if paged:
        ppb = N // PAGE
        perm = rng.permutation(B * ppb).astype(np.int32)
        bt = torch.as_tensor(perm.reshape(B, ppb)).to(dev)
        kp = torch.zeros((B * ppb, PAGE, Hk, D), dtype=kc.dtype, device=dev)
        vp = torch.zeros_like(kp)
        kp[bt.reshape(-1).long()] = kc.reshape(B * ppb, PAGE, Hk, D)
        vp[bt.reshape(-1).long()] = vc.reshape(B * ppb, PAGE, Hk, D)
        kuse, vuse = kp, vp
        lpt = None
    else:
        kuse, vuse = kc, vc

    ksc = vsc = None
    kc_o, vc_o = kc, vc
    if quant:
        qdt = torch.int8 if quant == "int8" else quant
        kq, ksc = quantize_kv(kuse, qdt, token_axis=1)     # NHD layouts
        vq, vsc = quantize_kv(vuse, qdt, token_axis=1)
        i4 = quant == "int4"
        # the oracle sees the dequantized cache
        kc_o = dequantize_kv(kq, ksc, torch.bfloat16, int4=i4, token_axis=1)
        vc_o = dequantize_kv(vq, vsc, torch.bfloat16, int4=i4, token_axis=1)
        if paged:
            kc_o = kc_o[bt.reshape(-1).long()].reshape(B, N, Hk, D)
            vc_o = vc_o[bt.reshape(-1).long()].reshape(B, N, Hk, D)
        kuse, vuse = kq, vq

    # the port appends in place: the kernel gets copies of the caches
    out = flash_attn_with_kvcache(
        q, kuse.clone(), vuse.clone(), k=kn, v=vn, cache_seqlens=cs,
        block_table=bt, k_scales=ksc, v_scales=vsc, causal=causal,
        window_size=window, cache_leftpad=lpt, alibi_slopes=slopes)
    if isinstance(out, tuple):
        out = out[0]
    ref, _, _ = mha_reference_kvcache(
        q, kc_o, vc_o, k_new=kn, v_new=vn, cache_seqlens=cs,
        cache_leftpad=lpt, causal=causal, window_size=window,
        alibi_slopes=slopes, upcast=True)
    e = max_abs_err(out, ref)
    rel = e / (float(ref.float().abs().max()) + 1e-6)
    ok = rel < tol
    print(f"{'PASS' if ok else 'FAIL'} {name}: max_err={e:.4g} "
          f"rel={rel:.4g} (tol {tol})", flush=True)
    return ok


def main(device: str = "cuda") -> int:
    """Run every case; returns the number that failed."""
    dev = run_device(device)
    rng = np.random.default_rng(SEED)
    fails = sum(not run_case(rng, name, device=dev, **kw)
                for name, kw in CASES)
    print("verify_decode_fastpath: "
          + ("ALL PASS" if fails == 0 else f"{fails} FAILURES"), flush=True)
    return fails


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
