"""P4: does the H100 take packed int4 operands in its tensor cores?  The
TPU probe (the JAX repository's benchmarks/prof_int4_native.py) asks it of
Mosaic; here `mma.sync` m16n8k64 .s4.s4 (int4 x int4) is held against the
way the quantized decode and prefill kernels go, K's nibbles unpacked to
int8 and m16n8k32 .s8.s8 (int8 x int4), both in csrc/probe_int4.cu.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_int4_native

At the TPU script's shape (q (128, 128), k (256, 128), values in [-8, 8)
from default_rng(0)) each product is checked exactly against the plain
twin and timed; a launch dominates there, so both are timed again at
4096^3 with their rate.  A kernel that does not build (ptxas refusing the
s4 mma for sm_90a) or disagrees prints FAILED with the first line of the
error, as the TPU script does.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks import common
from flash_attn_v100_tpu_torch.ops.cuda import probe_int4 as p4
from flash_attn_v100_tpu_torch.utils.benchmarking import measure

LARGE = 4096


def operands(dev, M: int, N: int, K: int, seed: int = 0):
    """(q int8 (M, K), k packed int4 (N, K / 2)) with values in [-8, 8)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-8, 8, (M, K))).to(torch.int8)
    k = torch.from_numpy(rng.integers(-8, 8, (N, K))).to(torch.int8)
    return q.to(dev), p4.pack_int4(k).to(dev)


def main() -> dict:
    dev = common.card()
    res = {}
    small = operands(dev, 128, 256, 128)
    large = operands(dev, LARGE, LARGE, LARGE)
    for name, fn, pack in (("int4xint4", p4.int4_matmul, True),
                           ("int8xint4", p4.int8_int4_matmul, False)):
        try:
            line = []
            for (q, k) in (small, large):
                a = p4.pack_int4(q.cpu()).to(dev) if pack else q
                out = fn(a, k)
                ref = p4.int8_int4_matmul_ref(q, k)
                ok = torch.equal(out, ref)
                dt = measure(lambda: fn(a, k), device=dev)
                ops, _ = p4.work(q.shape[0], k.shape[0], q.shape[1],
                                 4 if pack else 8)
                line.append((ok, dt, ops / dt / 1e12))
            (ok_s, dt_s, _), (ok_l, dt_l, rate) = line
            res[name] = dict(correct=ok_s and ok_l, small_s=dt_s,
                             large_s=dt_l, tops=rate)
            print(f"{name}: BUILT, correct={ok_s and ok_l}, "
                  f"{dt_s * 1e6:.2f} us at 128x256x128, "
                  f"{dt_l * 1e3:.4f} ms at {LARGE}^3 ({rate:.0f} TOP/s)",
                  flush=True)
        except Exception as e:   # the probe's answer: print it, as the TPU
            # script does, and go on to the other product
            res[name] = dict(correct=False, error=str(e))
            print(f"{name}: FAILED — {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:160]}", flush=True)
    return res


if __name__ == "__main__":
    main()
