"""P1: split the cost of one flash step on an H100 into its stages: a
standalone kernel with K1's structure at D 128 (QK^T -> max -> exp2 -> sum
-> PV) in which each stage can be toggled (wrong numerics where a stage is
missing: a cost probe; chip_smoke.py holds each variant against its plain
twin).  The port of the JAX repository's benchmarks/prof_softmax_cost.py,
with its variants and lines.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_softmax_cost

Its own shape is one 1024-row q block over 16 key tiles of 1024 keys (one
head, N = 16384), at the TPU script's scale 0.0883883 without log2 e.  On
the card that is 8 blocks of 128 rows on 132 multiprocessors, a measure of
one block's serial steps; so the variants run again at P2's shape (B 4,
32/8 heads x 128, M = N = 4096, non-causal), K1's headline shape, where the
card is full.  Each line gives the time per 1024 x 1024 tile of work (the
TPU script's unit), the tensor-core ideal of the tile's products at 989
TFLOP/s bf16, and the call's total.  "2048-kv, 2 sub-tiles" (the TPU
script's kernel2: a grid step over twice the keys) is here a step over 128
keys (twice K1's 64) with one online update.
"""

from __future__ import annotations

from flash_attn_v100_tpu_torch.benchmarks import common
from flash_attn_v100_tpu_torch.ops.cuda import probes

OWN = dict(B=1, Hq=1, Hk=1, M=1024, N=16384)          # the TPU script's
P2_SHAPE = dict(B=4, Hq=32, Hk=8, M=4096, N=4096)     # K1's headline shape


def run_shape(dev, B, Hq, Hk, M, N, title: str) -> dict:
    q, k, v = common.inputs(dev, B * Hq, B * Hk, M, N)
    tiles = B * Hq * M * N / common.TILE_WORK
    print(f"-- {title}: B {B}, {Hq}/{Hk} heads x 128, M {M}, N {N}",
          flush=True)
    res = {}
    for name, probe in probes.P1_VARIANTS.items():
        dt = common.time_probe(probe, q, k, v, probes.SCALE, B)
        ideal = common.tensor_core_s(probe, B * Hq, M, N)
        res[name] = dt
        print(f"{name:24s}: {dt / tiles * 1e6:7.3f} us/tile  "
              f"(tensor-core ideal {ideal / tiles * 1e6:.3f})  "
              f"total {dt * 1e3:.3f} ms", flush=True)
    return res


def main() -> dict:
    dev = common.card()
    return {"own": run_shape(dev, **OWN, title="one 1024-row block"),
            "p2": run_shape(dev, **P2_SHAPE, title="P2's shape")}


if __name__ == "__main__":
    main()
