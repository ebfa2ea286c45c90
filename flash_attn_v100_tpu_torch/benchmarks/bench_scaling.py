"""Multi-rank scaling of the sharded paths: the counterpart of the JAX
repository's `benchmarks/bench_scaling.py` on torch.distributed.

Weak-scales ring-attention prefill (`parallel/ring.py::ring_attention`,
contiguous causal, `--seq-per-chip` tokens a rank, 8 heads x 128, bf16)
and strong-scales head-sharded decode (`parallel/sharded.py::
flash_attn_with_kvcache_sharded`, `--ctx` tokens, B 8, 32/8 heads x 128)
over n in {1, 2, 4, 8, 16} ranks up to `--devices`, and reports
efficiency T(1) / T(n) (decode: its speedup and speedup / n).  The ranks
are spawned processes in one gloo process group, as the port's tests
spawn them (`common.spawn_ranks`); rank r runs on card r % cards, so on a
one-card machine every rank shares the one H100 and the chunks move
through gloo on the host: those times measure gloo and a shared card, not
NVLink, and the script says so on its lines.  The multi-card figure waits
for a machine with several cards.  Every call is timed in lockstep (a
barrier, the call, a synchronize; the median of the rounds, the slowest
rank's).

At n = 2 the output is also held against the one-rank output on the same
inputs: max |out(2) - out(1)| <= 2 x (the bf16 oracle's error against the
fp32 oracle) + 1e-5, the reference's forward gate.

    python -m flash_attn_v100_tpu_torch.benchmarks.bench_scaling
        [--devices 8] [--seq-per-chip 1024] [--ctx 8192] [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    CPU_ORACLE_BUDGET, backend, normal, oracle, spawn_ranks, sync)
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh
from flash_attn_v100_tpu_torch.parallel.ring import ring_attention
from flash_attn_v100_tpu_torch.parallel.sharded import (
    flash_attn_with_kvcache_sharded)
from flash_attn_v100_tpu_torch.utils.testing import max_abs_err

SIZES = (1, 2, 4, 8, 16)
RING = dict(H=8, D=128, B=1, iters=4)
DECODE = dict(B=8, Hq=32, Hk=8, D=128, iters=8)
GATE_MULT, GATE_ATOL = 2.0, 1e-5


def lockstep_seconds(fn, member: bool, iters: int, dev) -> float:
    """Seconds a call of fn on every member rank at once: a warm-up call,
    then `iters` rounds of (world barrier, call, synchronize); the median
    round of the slowest rank.  Ranks outside the mesh only keep step."""
    import torch.distributed as dist
    if member:
        fn()
        sync(dev)
    times = []
    for _ in range(iters):
        dist.barrier()
        t0 = time.perf_counter()
        if member:
            fn()
            sync(dev)
        times.append(time.perf_counter() - t0)
    t = torch.tensor([statistics.median(times) if member else 0.0],
                     dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _gate(q, k, v, dev, **kw) -> float:
    """The forward gate on these inputs: 2 x max |bf16 oracle - fp32
    oracle| + 1e-5 (q (B, M, Hq, D), k/v (B, N, Hk, D))."""
    budget = (torch.cuda.mem_get_info(dev)[0] // 4 if dev.type == "cuda"
              else CPU_ORACLE_BUDGET)
    o32, _ = oracle(q, k, v, None, True, budget, **kw)
    onat, _ = oracle(q, k, v, None, False, budget, **kw)
    return GATE_MULT * max_abs_err(onat, o32) + GATE_ATOL


def _ring_inputs(n: int, spc: int, dev):
    rng = np.random.default_rng(100 + n)
    shape = (RING["B"], spc * n, RING["H"], RING["D"])
    return [normal(rng, shape, dev) for _ in range(3)]


def _decode_inputs(ctx: int, dev):
    rng = np.random.default_rng(200)
    B, Hq, Hk, D = DECODE["B"], DECODE["Hq"], DECODE["Hk"], DECODE["D"]
    return (normal(rng, (B, 1, Hq, D), dev), normal(rng, (B, Hk, ctx, D), dev),
            normal(rng, (B, Hk, ctx, D), dev))


def _rank(rank: int, world: int, cfg: Dict) -> Dict:
    dev = (torch.device("cuda", torch.cuda.current_device())
           if cfg["device"] == "cuda" else torch.device("cpu"))
    out = dict(ring={}, decode={}, checks={})
    for n in cfg["sizes"]:
        mesh = make_mesh(data=1, seq=n, model=1)
        q = k = v = None
        if mesh.is_member:
            q, k, v = _ring_inputs(n, cfg["seq_per_chip"], dev)
        o = {}

        def ring():
            o["out"] = ring_attention(q, k, v, mesh, causal=True)
        out["ring"][n] = lockstep_seconds(ring, mesh.is_member,
                                          RING["iters"], dev)
        if n == 2 and mesh.is_member:
            one = Mesh(np.full((1, 1, 1), rank), rank, dict.fromkeys(AXES))
            ref = ring_attention(q, k, v, one, causal=True)
            m = q.shape[1] // n
            blk = ref[:, rank * m:(rank + 1) * m]
            out["checks"]["ring"] = (max_abs_err(o["out"], blk),
                                     _gate(q, k, v, dev, causal=True))
    B, Hq, Hk = DECODE["B"], DECODE["Hq"], DECODE["Hk"]
    for n in cfg["sizes"]:
        if Hk % n:          # the kv heads must divide over "model"
            continue
        mesh = make_mesh(data=1, seq=1, model=n)
        member = mesh.is_member
        if member:
            q, kc, vc = _decode_inputs(cfg["ctx"], dev)
            cs = torch.full((B,), cfg["ctx"], dtype=torch.int32, device=dev)
            r = mesh.index("model")
            hq = slice(r * Hq // n, (r + 1) * Hq // n)
            hk = slice(r * Hk // n, (r + 1) * Hk // n)
            ql, kl, vl = q[:, :, hq], kc[:, hk], vc[:, hk]
        o = {}

        def decode():
            o["out"] = flash_attn_with_kvcache_sharded(
                ql, kl, vl, mesh, cs, causal=True)
        out["decode"][n] = lockstep_seconds(decode, member, DECODE["iters"],
                                            dev)
        if n == 2 and member:
            ref = flash_attn_with_kvcache(q, kc, vc, cache_seqlens=cs,
                                          causal=True, kv_cache_layout="HND")
            out["checks"]["decode"] = (
                max_abs_err(o["out"], ref[:, :, hq]),
                _gate(q, kc.transpose(1, 2), vc.transpose(1, 2), dev,
                      causal=True))
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0,
                    help="max ranks (default: one a card; on the CPU 1)")
    ap.add_argument("--seq-per-chip", type=int, default=1024)
    ap.add_argument("--ctx", type=int, default=8192)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    print(f"card: {card}", flush=True)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    n_all = args.devices or max(cards, 1)
    sizes = [n for n in SIZES if n <= n_all]
    where = (f"gloo on {cards} card{'s' if cards != 1 else ''}, not NVLink"
             if dev.type == "cuda" else "gloo on the CPU")
    print(f"backend=gloo cards={cards} devices={n_all}", flush=True)
    ranks = spawn_ranks(_rank, max(sizes), dict(
        sizes=sizes, seq_per_chip=args.seq_per_chip, ctx=args.ctx,
        device=dev.type), dev.type)
    res = ranks[0]

    print("ring-attention prefill (weak scaling, seq/chip const):")
    t1 = None
    for n in sizes:
        t = res["ring"][n]
        t1 = t1 or t
        # causal ring does ~n/2 effective steps; perfect weak scaling for
        # the full-attention FLOPs means T(n) ~ T(1) * n/2 ... raw + eff
        print(f"  n={n}: {t*1e3:8.2f} ms  eff={t1/t:.2f} ({where})")

    print("head-sharded decode (strong scaling, fixed ctx):")
    t1 = None
    for n in sizes:
        if n not in res["decode"]:
            continue
        t = res["decode"][n]
        t1 = t1 or t
        print(f"  n={n}: {t*1e6:8.0f} us  speedup={t1/t:.2f} "
              f"(ideal {n:.1f}) eff={t1/t/n:.2f} ({where})")

    checks = {}
    for name in ("ring", "decode"):
        got = [r["checks"][name] for r in ranks if name in r["checks"]]
        if got:
            err = max(e for e, _ in got)
            gate = min(g for _, g in got)
            checks[name] = dict(err=err, gate=gate, ok=err <= gate)
            print(f"n=2 vs n=1 ({name}): max |diff| {err:.3e} <= gate "
                  f"{gate:.3e}: {'OK' if err <= gate else 'FAILED'}",
                  flush=True)
    return dict(sizes=sizes, ring=res["ring"], decode=res["decode"],
                checks=checks, cards=cards)


if __name__ == "__main__":
    main()
