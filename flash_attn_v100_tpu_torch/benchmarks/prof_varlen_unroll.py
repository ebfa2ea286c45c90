"""K5 and K8 with U key tiles a step: the counterpart of the JAX
repository's `benchmarks/prof_varlen_unroll.py` on the card.

The JAX script sets its varlen forward's `kv_unroll` U on the uniform
8 x 2048 packed-training batch (causal at U 1 / 2 / 4, full at U 1 / 2)
and on its mixed batch (U 1 / 2), and its paged prefill's page unroll on
8 x 2048 with 128-token pages (U 1 / 2 / 4 / 8: the engine's TTFT path,
the table 1 + arange).  On the card U is a build variant
(benchmarks/variants.py): K5's "u2" (two 64-key sub-tiles a step under
one online softmax) and "u4" (four of 32 keys); K8's "u2", "u4", "u8"
(128 keys a step in two, four or eight sub-tiles); U 1 is the shipped
kernel.  32/8 heads x 128, bf16, chained `--chain` times (q <- q + 1e-6
o); TF/s are the JAX line's, sum(4 Hq L^2 D / (2 if causal)), against 989
TFLOP/s; rows in turns, the median of `--rounds`, as a call and as a
CUDA-graph replay's device time.  Each variant is held to its kernel's
plain twin at the shipped kernel's gate, its registers, spills and shared
memory printed.  `--paged-quant` runs the JAX script's uncalled
bench_paged_quant: K8q over int8, fp8 and int4 pools at U 1 (K8q has no
unroll variant: its U > 1 rows print "n/a on the port").

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_varlen_unroll
        [--paged-quant] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from flash_attn_v100_tpu_torch.benchmarks import variants as var
from flash_attn_v100_tpu_torch.benchmarks.common import (
    SweepRow, gate_text, randn, run_sweep, sweep_card)
from flash_attn_v100_tpu_torch.benchmarks.prof_varlen import (
    Packed, varlen_flops)
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import varlen as dvl
from flash_attn_v100_tpu_torch.ops.quant import FP8, quantize_kv
from flash_attn_v100_tpu_torch.utils.testing import FWD_ATOL, FWD_MULT

SEED = 0
NA = "n/a on the port (K8q has no unroll variant)"


class Paged:
    """The JAX script's paged prefill: B sequences of plen new tokens, K/V
    in pools (Hk, B * mp + 1, ps, D) through the table 1 + arange; K8's
    rows and (once) its plain twin for the variants' gate."""

    def __init__(self, gen, plen: int, B: int, ps: int, Hq: int, Hk: int,
                 D: int, dev):
        self.plen, self.B, self.ps = plen, B, ps
        self.mp = -(-plen // ps)
        P = B * self.mp + 1
        self.q = randn(gen, (B * plen, Hq, D), dev)
        self.kf = randn(gen, (Hk, P, ps, D), dev, torch.float32)
        self.vf = randn(gen, (Hk, P, ps, D), dev, torch.float32)
        self.kp, self.vp = self.kf.to(torch.bfloat16), self.vf.to(
            torch.bfloat16)
        self.tbl = 1 + torch.arange(B * self.mp, dtype=torch.int32,
                                    device=dev).reshape(B, self.mp)
        self.cu = torch.arange(B + 1, dtype=torch.int32, device=dev) * plen
        self.sk = torch.full((B,), plen, dtype=torch.int32, device=dev)
        self.params = masklib.MaskParams(causal=True)
        self.scale = D ** -0.5
        self._refs = None

    def flops(self, Hq: int, D: int) -> int:
        return varlen_flops([self.plen] * self.B, Hq, D, True)

    def args(self, qi, kp, vp):
        return (qi, kp, vp, self.tbl, self.cu, self.sk, self.plen,
                self.mp * self.ps, self.scale, self.params)

    def shipped(self, kp=None, vp=None, ks=None, vs=None):
        kp = self.kp if kp is None else kp
        vp = self.vp if vp is None else vp
        return lambda qi: dvl.flash_attn_varlen_fwd_paged(
            *self.args(qi, kp, vp), k_scales=ks, v_scales=vs)[0]

    def variant(self, name: str):
        return lambda qi: var.paged_fwd(
            qi, self.kp, self.vp, self.tbl, self.cu, self.sk, self.plen,
            self.mp * self.ps, True, name)[0]

    def gate(self, name: Optional[str]) -> str:
        if self._refs is None:
            a = self.args(self.q, self.kp, self.vp)
            self._refs = (dvl.flash_attn_varlen_fwd_paged_ref(*a)[0],
                          dvl.flash_attn_varlen_fwd_paged_ref(
                              *a, upcast=False)[0])
        out = (self.shipped() if name is None else self.variant(name))(self.q)
        return gate_text(out, *self._refs, FWD_MULT, FWD_ATOL,
                         f"K8 {name or ''} out".replace("  ", " "))


def parser() -> argparse.ArgumentParser:
    """The script's flags: the JAX script's fixed values, --device and
    --rounds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--chain", type=int, default=8,
                    help="calls chained (the JAX scan's NCH)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--uniform", type=int, nargs=2, default=[8, 2048],
                    metavar=("B", "L"))
    # the JAX script's mixed batch: seven lengths and the rest of 2 x 4096
    ap.add_argument("--mixed", type=int, nargs="+",
                    default=[37, 512, 4096, 1024, 2048, 300, 128, 4143])
    ap.add_argument("--unroll", type=int, nargs="+", default=[1, 2, 4],
                    help="U of the uniform causal rows")
    ap.add_argument("--full-unroll", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--mixed-unroll", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--paged-unroll", type=int, nargs="+",
                    default=[1, 2, 4, 8])
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--paged-quant", action="store_true",
                    help="also K8q over int8, fp8 and int4 pools")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    dev, _ = sweep_card(args.device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Hq, Hk, D = args.heads, args.kv_heads, args.head_dim
    card = dev.type == "cuda"
    nb, L = args.uniform
    uni = Packed(gen, [L] * nb, Hq, Hk, D, dev)
    mixed = Packed(gen, args.mixed, Hq, Hk, D, dev)
    rows = []

    def k5_row(tag, pk, causal, U):
        name = None if U == 1 else f"u{U}"
        fn = (pk.fwd(causal) if name is None
              else pk.variant(causal, name) if card else None)
        return SweepRow(f"{tag} causal={causal} U={U}", fn, pk.q,
                        flops=varlen_flops(pk.lens, Hq, D, causal),
                        kernel=name and "K5", variant=name,
                        check=lambda: pk.gate(causal, name or "K5"))

    rows += [k5_row(f"uniform-{nb}x{L}", uni, True, U) for U in args.unroll]
    rows += [k5_row(f"uniform-{nb}x{L}", uni, False, U)
             for U in args.full_unroll]
    rows += [k5_row("mixed", mixed, True, U) for U in args.mixed_unroll]
    pg = Paged(gen, L, nb, args.page_size, Hq, Hk, D, dev)
    tag = f"paged-{nb}x{L}-ps{args.page_size}"
    for U in args.paged_unroll:
        name = None if U == 1 else f"u{U}"
        fn = (pg.shipped() if name is None
              else pg.variant(name) if card else None)
        rows.append(SweepRow(f"{tag} U={U}", fn, pg.q,
                             flops=pg.flops(Hq, D), kernel=name and "K8",
                             variant=name,
                             check=lambda n=name: pg.gate(n)))
    if args.paged_quant:
        for kind, qd in (("int8", torch.int8), ("fp8", FP8),
                         ("int4", "int4")):
            kq, ks = quantize_kv(pg.kf, qd, token_axis=2)
            vq, vs = quantize_kv(pg.vf, qd, token_axis=2)
            for U in args.paged_unroll:
                rows.append(SweepRow(
                    f"{tag}-{kind} U={U}",
                    pg.shipped(kq, vq, ks, vs) if U == 1 else None, pg.q,
                    flops=pg.flops(Hq, D), note=NA))
    return run_sweep(rows, dev, args.chain, args.rounds, args.iters)


if __name__ == "__main__":
    main()
