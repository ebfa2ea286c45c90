"""One-round against two-round int4 decode append: the counterpart of the
JAX repository's `benchmarks/prof_int4_rmw.py` on the card.

A T = 1 append writes one int4 token a row into a token-packed pool (two
tokens a byte, `ops/quant.py`).  When each row targets its own page no two
writes share a byte, so the append needs one gather and one scatter
(`ops/kvcache.py::_int4_rmw_paged`); the two-round form (even offsets, then
odd, each a gather and a scatter of every row with the other parity's
rows dropped) is the JAX script's `two_round`.  Both run on a layer-folded
decode-shape pool (Hk 8, 16 layers, B 16, 128-token pages, D 128, ~2k
context of pages a row), `--chain` appends back to back; each prints its
time an append with its host time, and on the card the device time from a
CUDA-graph replay, then both pools' bytes are compared from zeros.

The JAX script draws the rows' page ids with replacement, so two rows can
land on one page; the port draws them without replacement
(`rng.choice(P, B, replace=False)`), as the append's contract (one page a
row) requires.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_int4_rmw
        [--chain 64] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    backend, graph_seconds)
from flash_attn_v100_tpu_torch.ops import kvcache as kc
from flash_attn_v100_tpu_torch.utils.benchmarking import measure

SEED = 0


def folded_pages(B: int, L: int) -> int:
    """The folded page axis: ~2k context of pages a row, and a scratch
    page, for each of L layers (the JAX script's P)."""
    return (B * 20 + 1) * L


def draw(rng: np.random.Generator, Hk: int, B: int, PS: int, D: int,
         P: int):
    """(vals (B, 1, Hk, D) int8 in [-8, 8), page ids (B, 1) int32, distinct,
    offsets (B, 1) int32), drawn in the JAX script's order."""
    vals = rng.integers(-8, 8, (B, 1, Hk, D)).astype(np.int8)
    pids = rng.choice(P, B, replace=False).reshape(B, 1).astype(np.int32)
    off = rng.integers(0, PS, (B, 1)).astype(np.int32)
    return vals, pids, off


def one_round(pool, vals, page_ids, off) -> None:
    """The port's append (`_int4_rmw_paged`), in place."""
    kc._int4_rmw_paged(pool, vals, page_ids, off)


def two_round(pool, vals, page_ids, off) -> None:
    """The JAX script's `two_round`, in place: for each parity p, gather
    every row's byte, merge its nibble, scatter only the rows at offsets
    of parity p."""
    idx = kc._paged_index(pool, page_ids, off)
    lo, hi = kc._nibbles(vals)
    parity = off % 2
    even = (parity == 0)[..., None, None]
    contrib = torch.where(even, lo, hi)
    other = torch.where(even, 0xF0, 0x0F)     # the partner's nibble
    for p in (0, 1):
        old = pool[idx].to(torch.int32)
        kc._put(pool, idx, (old & other) | contrib,
                keep=(parity == p)[..., None])


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--chain", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    print(f"card: {card}", flush=True)
    Hk, L, B, PS, D = (args.kv_heads, args.layers, args.batch,
                       args.page_size, args.head_dim)
    P = folded_pages(B, L)
    rng = np.random.default_rng(SEED)
    vals, pids, off = (torch.from_numpy(a).to(dev)
                       for a in draw(rng, Hk, B, PS, D, P))

    def zeros():
        return torch.zeros((Hk, P, PS // 2, D), dtype=torch.int8, device=dev)

    res = {}
    pool = zeros()
    for name, fn in (("two-round (old)", two_round),
                     ("one-round (new)", one_round)):
        def run():
            for _ in range(args.chain):
                fn(pool, vals, pids, off)
        dt = measure(run, iters=1, device=dev) / args.chain
        line = f"{name}: {dt*1e6:.1f} us per T=1 RMW"
        res[name] = dict(call_s=dt)
        if dev.type == "cuda":
            ddt = graph_seconds(run, dev) / args.chain
            line += f"; device {ddt*1e6:.1f} us"
            res[name]["device_s"] = ddt
        print(line, flush=True)

    # the bytes of both forms from zeros
    p1, p2 = zeros(), zeros()
    two_round(p1, vals, pids, off)
    one_round(p2, vals, pids, off)
    if not torch.equal(p1, p2):
        raise RuntimeError("one-round and two-round appends wrote different "
                           "bytes")
    res["equal"] = True
    print("bit-identical OK", flush=True)
    return res


if __name__ == "__main__":
    main()
