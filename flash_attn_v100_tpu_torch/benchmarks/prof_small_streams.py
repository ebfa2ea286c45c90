"""P3: the per-step cost of small int32 side streams on top of a minimal
flash step on an H100 (K1's structure at D 128, csrc/probes.cu): q-side
(M,) words read once a block and k-side (N,) words copied with each K tile,
added into the scores times 0.0 (the varlen kernels' qseg/qpos/kseg); the
key-tile count read by every block from device memory (csrc/seq.cuh's
bookkeeping) instead of a kernel argument; and per-step segment min/max
reductions with a 3-way branch (the varlen fast path's).  The port of the
JAX repository's benchmarks/prof_small_streams.py, with its shape (BH 128,
kv heads BH / 4, D 128, M = N = 4096, bf16), variants and lines; a "step"
is its 1024 x 1024 tile of work.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_small_streams
"""

from __future__ import annotations

from flash_attn_v100_tpu_torch.benchmarks import common
from flash_attn_v100_tpu_torch.ops.cuda import probes

BH, M, N = 128, 4096, 4096


def run(name: str, probe: probes.Probe, q, k, v) -> float:
    dt = common.time_probe(probe, q, k, v, probes.SCALE_LOG2)
    steps = BH * M * N / common.TILE_WORK
    print(f"{name:28s}: {dt * 1e6 / steps:6.3f} us/step  "
          f"total {dt * 1e3:.3f} ms", flush=True)
    return dt


def main() -> dict:
    dev = common.card()
    q, k, v = common.inputs(dev, BH, BH // 4, M, N)
    return {name: run(name, probe, q, k, v)
            for name, probe in probes.P3_VARIANTS.items()}


if __name__ == "__main__":
    main()
