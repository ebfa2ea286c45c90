"""P2: bisect a flash forward's per-step cost on an H100 by adding one
production feature at a time to a minimal flash step (K1's structure at D
128, csrc/probes.cu): the LSE epilogue (O normalised, LSE written), the
key tiles walked from a (qi, ki, first, last) pair table in device memory,
and (B, H, M, D) operands under runtime strides on a (q tile, head, batch)
grid.  The port of the JAX repository's benchmarks/prof_fwd_gap.py, with
its shape (B 4, 32/8 heads x 128, M = N = 4096, non-causal, bf16), variants
and lines; a "step" is its 1024 x 1024 tile of work (B * Hq * 16 of them),
so the numbers read as the TPU script's.

    python -m flash_attn_v100_tpu_torch.benchmarks.prof_fwd_gap
"""

from __future__ import annotations

from flash_attn_v100_tpu_torch.benchmarks import common
from flash_attn_v100_tpu_torch.ops.cuda import probes

B, Hq, Hk, M, N = 4, 32, 8, 4096, 4096


def run(name: str, probe: probes.Probe, q, k, v) -> float:
    dt = common.time_probe(probe, q, k, v, probes.SCALE_LOG2, B)
    steps = B * Hq * M * N / common.TILE_WORK
    print(f"{name:22s}: {dt * 1e6 / steps:6.3f} us/step  "
          f"total {dt * 1e3:.3f} ms", flush=True)
    return dt


def main() -> dict:
    dev = common.card()
    q, k, v = common.inputs(dev, B * Hq, B * Hk, M, N)
    return {name: run(name, probe, q, k, v)
            for name, probe in probes.P2_VARIANTS.items()}


if __name__ == "__main__":
    main()
