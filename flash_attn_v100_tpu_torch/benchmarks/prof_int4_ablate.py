"""The int4 decode's chain, ablated: the counterpart of the JAX
repository's `benchmarks/prof_int4_ablate.py` on the card.

The 32k decode at the JAX shape (B 8, 32/8 heads x 128, one new token a
row, GQA-folded q rows (B, Hk, 8, D), `--page-size` 512-token pages,
chained `--chain` 8 times as the JAX scan chains it) through the merged
decode entry (ops/cuda/decode.py::paged_decode_attention_merged), from
int8 and int4 pools quantized from the same bf16 pools.  The variants are
the JAX script's names (`--variants`, its VARIANTS list by default):
  int8          K4q over int8 pools (shipped)
  int4-prod     K4q over int4 pools (shipped)
  int4-S2       the same with num_splits=2 (ops/cuda/decode.py's split
                rule otherwise)
  int4-U4       the TPU kernel's kv_unroll 4: n/a on the port (K4q takes
                no unroll)
  int4-full-qk  the production S, P V over one nibble half of V
  int4-qk-one   one K half's product, duplicated
  int4-no-and   the packed bytes read as int8, no unpacking
The last three are build variants of K4q (benchmarks/variants.py INT4):
wrong numbers on purpose, timing only, checked finite; each prints its
registers, spills and shared memory.  Bytes are the JAX script's,
2 B ctx Hk ((D / 2 if int4 else D) + 4); each line gives tok/s, ms and
GB/s with its share of the H100's 3.35 TB/s, as a call with its host time
and as a CUDA-graph replay's device time, rows in turns, the median of
`--rounds`.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_int4_ablate
        [--page-size 512] [--chain 8] [--variants int8 int4-prod ...]
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from flash_attn_v100_tpu_torch.benchmarks import variants as var
from flash_attn_v100_tpu_torch.benchmarks.common import (
    SweepRow, finite_text, randn, run_sweep, sweep_card)
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda.decode import (
    paged_decode_attention_merged)
from flash_attn_v100_tpu_torch.ops.quant import quantize_kv

SEED = 0
ALL = ["int8", "int4-prod", "int4-S2", "int4-U4", "int4-full-qk",
       "int4-qk-one", "int4-no-and"]
ABLATION = {"int4-full-qk": "full-qk", "int4-qk-one": "qk-one",
            "int4-no-and": "no-and"}
NA = "n/a on the port (kv_unroll unrolls the TPU kernel's page loop; K4q " \
     "takes no unroll)"


def decode_bytes(B: int, ctx: int, Hk: int, D: int, int4: bool) -> int:
    """The JAX script's count: K and V payload and fp32 scales, once."""
    return 2 * B * ctx * Hk * ((D // 2 if int4 else D) + 4)


def parser() -> argparse.ArgumentParser:
    """The script's flags: the JAX script's fixed values, --device and
    --rounds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--ctx", type=int, default=32768)
    ap.add_argument("--page-size", type=int, default=512)
    ap.add_argument("--chain", type=int, default=8,
                    help="decode calls chained (the JAX scan's N_CHAIN)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=3)
    # the JAX script's VARIANTS default (int4-S2 is defined, not run)
    ap.add_argument("--variants", nargs="+", choices=ALL,
                    default=["int8", "int4-prod", "int4-U4", "int4-full-qk",
                             "int4-qk-one", "int4-no-and"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    dev, _ = sweep_card(args.device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, Hq, Hk, D = args.batch, args.heads, args.kv_heads, args.head_dim
    ctx, PS, group = args.ctx, args.page_size, args.heads // args.kv_heads
    n_pages = B * ctx // PS
    kpool, vpool = (randn(gen, (Hk, n_pages, PS, D), dev) for _ in range(2))
    table = torch.arange(n_pages, dtype=torch.int32,
                         device=dev).reshape(B, -1)
    cs = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    lp = torch.zeros((B,), dtype=torch.int32, device=dev)
    params = masklib.MaskParams(causal=False, window_left=-1, window_right=0)
    qd = randn(gen, (B, Hk, 8, D), dev)
    pools = {}
    if "int8" in args.variants:
        k8, ks8 = quantize_kv(kpool, torch.int8)
        v8, vs8 = quantize_kv(vpool, torch.int8)
        pools["int8"] = (k8, v8, ks8, vs8)
    k4, ks4 = quantize_kv(kpool, "int4")
    v4, vs4 = quantize_kv(vpool, "int4")
    pools["int4"] = (k4, v4, ks4, vs4)
    del kpool, vpool

    def core(kind, num_splits=0):
        a, b_, c, d_ = (x[None] for x in pools[kind])
        return lambda q: paged_decode_attention_merged(
            q, a, b_, table, cs, lp, softmax_scale=D ** -0.5, params=params,
            t_new=1, group=group, k_scales=c, v_scales=d_,
            int4=kind == "int4", num_splits=num_splits)[0]

    def ablation(name):
        a, b_, c, d_ = (x[None] for x in pools["int4"])
        return lambda q: var.decode_int4(q, a, b_, c, d_, table, cs, name,
                                         group, params=params)

    rows = []
    for name in args.variants:
        nb = decode_bytes(B, ctx, Hk, D, name != "int8")
        if name == "int4-U4":
            rows.append(SweepRow(name, None, note=NA, nbytes=nb, batch=B))
        elif name in ABLATION:
            abl = ABLATION[name]
            rows.append(SweepRow(
                name, ablation(abl) if dev.type == "cuda" else None, qd,
                nbytes=nb, batch=B, kernel="K4q", variant=abl,
                check=lambda a=abl: finite_text(ablation(a)(qd))))
        else:
            rows.append(SweepRow(
                name, core("int8" if name == "int8" else "int4",
                           2 if name == "int4-S2" else 0), qd,
                nbytes=nb, batch=B))
    return run_sweep(rows, dev, args.chain, args.rounds, args.iters)


if __name__ == "__main__":
    main()
