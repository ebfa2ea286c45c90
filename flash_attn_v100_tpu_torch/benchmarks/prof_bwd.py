"""Dense backward tile sweep: the counterpart of the JAX repository's
`benchmarks/prof_bwd.py` on the card.

The forward and backward of causal attention at the JAX shape, B 4 x 4096,
32/8 heads x 128, bf16: K1, then K2 (dQ) and K3 (dK, dV) of the loss
(o * do).sum(), chained `--chain` times by dq (q <- q + 1e-6 dq, with
1e-9 (sum dk + sum dv) so that every gradient is consumed).  The JAX
script sweeps the TPU backward's (dq, dkv) block sizes; on the card a tile
is a build variant of K2 or K3 (benchmarks/variants.py): the shipped
64 q rows x 32 keys (K2) and 64 keys x 32 q rows (K3), then `--dq-tiles`
(K2 at 64 keys a step) and `--dkv-tiles` (K3 at 64 q rows a step, and at
128 keys a block), the other kernel shipped.  TF/s are the JAX line's,
attention_flops(causal) x 2.5 over the whole call, against 989 TFLOP/s;
rows run in turns, the median of `--rounds`, as a call and as a CUDA-graph
replay's device time.  Each variant's gradients are held to the plain
twin at the gradient gate (3x + 1e-4: a K3 tile sums dK / dV over q in
another order), and its registers, spills and shared memory printed.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_bwd [--device cpu]

On the CPU the shipped row runs the plain twins; variant rows print "needs
the card".
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from flash_attn_v100_tpu_torch.benchmarks import variants as var
from flash_attn_v100_tpu_torch.benchmarks.common import (
    SweepRow, gate_text, randn, run_sweep, sweep_card)
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
from flash_attn_v100_tpu_torch.utils.benchmarking import attention_flops
from flash_attn_v100_tpu_torch.utils.testing import BWD_ATOL, BWD_MULT

SEED = 0


def add_shape_flags(ap: argparse.ArgumentParser, chain: int,
                    iters: int) -> None:
    """The dense backward scripts' shape, chain and timing flags (the JAX
    scripts' B, M, Hq, Hk, D, NCH and measure iters)."""
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seqlen", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--chain", type=int, default=chain,
                    help="calls chained (the JAX scan's NCH)")
    ap.add_argument("--iters", type=int, default=iters)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")


class DenseGrad:
    """q, k, v, do of the JAX shape drawn on the device; a forward +
    backward call by (K2, K3) variant, chained by its gradients; the plain
    twin's gradients (once a causal setting) for the variants' gate."""

    def __init__(self, args, dev):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        B, M, Hq, Hk, D = (args.batch, args.seqlen, args.heads,
                           args.kv_heads, args.head_dim)
        self.shape = (B, M, Hq, D)
        self.q, self.k, self.v, self.do = (
            randn(gen, s, dev)
            for s in ((B, M, Hq, D), (B, M, Hk, D), (B, M, Hk, D),
                      (B, M, Hq, D)))
        self.scale = D ** -0.5
        self.card = dev.type == "cuda"
        self._refs = {}

    def flops(self, causal: bool) -> int:
        B, M, Hq, D = self.shape
        return attention_flops(B, M, M, Hq, D, causal=causal)

    def grads(self, qi, causal: bool, dq: Optional[str] = None,
              dkv: Optional[str] = None):
        """(dq, dk, dv) of K1's output at qi: the shipped wrappers, or K2
        / K3 from their variants `dq` / `dkv`."""
        params = masklib.MaskParams(causal=causal)
        out, lse = dfwd.flash_attn_dense_fwd(qi, self.k, self.v, self.scale,
                                             params)
        if dq is None and dkv is None:
            return dbwd.flash_attn_dense_bwd(qi, self.k, self.v, out, self.do,
                                             lse, self.scale, params)
        return var.dense_bwd(qi, self.k, self.v, out, self.do, lse, causal,
                             dq_variant=dq, dkv_variant=dkv)

    def fn(self, causal: bool, dq: Optional[str] = None,
           dkv: Optional[str] = None):
        """The chained call, or None where a variant needs the card."""
        if (dq or dkv) and not self.card:
            return None

        def step(qi):
            g_q, g_k, g_v = self.grads(qi, causal, dq, dkv)
            return g_q + (1e-9 * (g_k.float().sum() + g_v.float().sum())
                          ).to(qi.dtype)
        return step

    def gate(self, causal: bool, dq: Optional[str] = None,
             dkv: Optional[str] = None) -> str:
        if causal not in self._refs:
            params = masklib.MaskParams(causal=causal)
            out, lse = dfwd.flash_attn_dense_fwd(self.q, self.k, self.v,
                                                 self.scale, params)
            a = (self.q, self.k, self.v, out, self.do, lse, self.scale,
                 params)
            self._refs[causal] = (dbwd.flash_attn_dense_bwd_ref(*a),
                                  dbwd.flash_attn_dense_bwd_ref(
                                      *a, upcast=False))
        got = self.grads(self.q, causal, dq, dkv)
        g32, g16 = self._refs[causal]
        tag = f"K2 {dq}" if dq else f"K3 {dkv}" if dkv else "K2/K3"
        return ", ".join(gate_text(g, r32, r16, BWD_MULT, BWD_ATOL,
                                   f"{tag} {n}")
                         for g, r32, r16, n in zip(got, g32, g16,
                                                   ("dq", "dk", "dv")))

    def row(self, name: str, causal: bool, mult: float,
            dq: Optional[str] = None, dkv: Optional[str] = None) -> SweepRow:
        return SweepRow(
            name, self.fn(causal, dq, dkv), self.q,
            flops=int(self.flops(causal) * mult),
            kernel="K2" if dq else "K3" if dkv else None, variant=dq or dkv,
            check=lambda: self.gate(causal, dq, dkv))


def parser() -> argparse.ArgumentParser:
    """The script's flags: the JAX script's fixed values, --device and
    --rounds."""
    ap = argparse.ArgumentParser()
    add_shape_flags(ap, chain=2, iters=4)
    ap.add_argument("--dq-tiles", nargs="*", default=["bk64"],
                    help="K2's tile variants (benchmarks/variants.py DQ)")
    ap.add_argument("--dkv-tiles", nargs="*", default=["bq64", "keys128"],
                    help="K3's tile variants (benchmarks/variants.py DKV)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    dev, _ = sweep_card(args.device)
    case = DenseGrad(args, dev)
    rows = [case.row("dq 64x32 dkv 64x32 (shipped)", True, 2.5)]
    rows += [case.row(f"dq {n:8s} dkv shipped", True, 2.5, dq=n)
             for n in args.dq_tiles]
    rows += [case.row(f"dq shipped  dkv {n}", True, 2.5, dkv=n)
             for n in args.dkv_tiles]
    return run_sweep(rows, dev, args.chain, args.rounds, args.iters)


if __name__ == "__main__":
    main()
