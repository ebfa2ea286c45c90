"""The dense forward + backward and its split into K1, K2 and K3: the
counterpart of the JAX repository's `benchmarks/prof_bwd_unroll.py` on
the card.

The JAX script A/B-tests its dQ kernel's unrolled fast path by timing the
whole forward + backward at the canonical shape (B 4 x 4096, 32/8 heads x
128, bf16), causal and not, with the shipped tiles and with a wider dQ key
step (its dq512x1024 row).  Here: K1, K2 and K3 of the loss (o * do).sum()
chained `--chain` times, consuming dq, dk and dv (q <- q + 1e-6 dq +
1e-9 (sum dk + sum dv): the JAX script's r5 fix, after XLA dropped the dKV
kernel when only dq was carried); the shipped row, then K2's variant at 64
keys a step (benchmarks/variants.py DQ "bk64", the dq512x1024 counterpart)
held to the plain twin at the gradient gate.  TF/s are attention_flops x
2.5 over the call, against 989 TFLOP/s; rows in turns, the median of
`--rounds`, as a call and as a CUDA-graph replay's device time.  On the
card each causal setting's split follows: K1's, K2's (and the K2
variant's) and K3's device times, each from a CUDA-graph replay of its own
call.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_bwd_unroll
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from flash_attn_v100_tpu_torch.benchmarks import variants as var
from flash_attn_v100_tpu_torch.benchmarks.common import (
    graph_seconds, run_sweep, sweep_card)
from flash_attn_v100_tpu_torch.benchmarks.prof_bwd import (
    DenseGrad, add_shape_flags)
from flash_attn_v100_tpu_torch.config import NEG_INF
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd


def split(case: DenseGrad, causal: bool, dq_tiles, dev) -> Dict[str, float]:
    """Device seconds of K1, K2 (and its variants) and K3 alone at the
    script's shape, each a CUDA-graph replay of its own call."""
    params = masklib.MaskParams(causal=causal)
    q, k, v, do = case.q, case.k, case.v, case.do
    out, lse = dfwd.flash_attn_dense_fwd(q, k, v, case.scale, params)
    delta = dbwd.softmax_delta(out, do)
    lse_c = lse.clamp_min(NEG_INF).contiguous()
    M, N, Hq = q.shape[1], k.shape[1], q.shape[2]
    args = (q, k, v, do, lse_c, delta, None, case.scale, params, 0.0, None,
            N - M, None, Hq)
    res = {"K1": graph_seconds(lambda: dfwd.flash_attn_dense_fwd(
        q, k, v, case.scale, params), dev),
        "K2": graph_seconds(lambda: dbwd.dq_kernel(*args), dev),
        "K3": graph_seconds(lambda: dbwd.dkv_kernel(*args), dev)}
    for name in dq_tiles:
        res[f"K2 {name}"] = graph_seconds(lambda n=name: var.dq_only(
            q, k, v, do, lse_c, delta, causal, n), dev)
    return res


def parser() -> argparse.ArgumentParser:
    """The script's flags: the JAX script's fixed values, --device and
    --rounds."""
    ap = argparse.ArgumentParser()
    add_shape_flags(ap, chain=2, iters=4)
    ap.add_argument("--dq-tiles", nargs="*", default=["bk64"],
                    help="K2's tile variants (benchmarks/variants.py DQ)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    dev, _ = sweep_card(args.device)
    case = DenseGrad(args, dev)
    res = {}
    for causal in (True, False):
        rows = [case.row(f"dq 64x32 dkv 64x32 (shipped) causal={causal}",
                         causal, 2.5)]
        rows += [case.row(f"dq {n} dkv shipped causal={causal}", causal, 2.5,
                          dq=n) for n in args.dq_tiles]
        res.update(run_sweep(rows, dev, args.chain, args.rounds, args.iters))
        if dev.type != "cuda":
            print(f"split causal={causal}: needs the card (CUDA-graph "
                  "replays)", flush=True)
            continue
        sp = split(case, causal, args.dq_tiles, dev)
        res[f"split causal={causal}"] = sp
        print(f"split causal={causal}: " + ", ".join(
            f"{k} {s * 1e3:.3f} ms" for k, s in sp.items())
            + f"; K1 + K2 + K3 {(sp['K1'] + sp['K2'] + sp['K3']) * 1e3:.3f}"
            " ms", flush=True)
    return res


if __name__ == "__main__":
    main()
