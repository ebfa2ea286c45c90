"""What the probe scripts share: the card line, seeded inputs, a timer and
one printed line a variant."""

from __future__ import annotations

import subprocess
from typing import Dict

import numpy as np
import torch

from flash_attn_v100_tpu_torch.config import resolve_device
from flash_attn_v100_tpu_torch.ops.cuda import probes
from flash_attn_v100_tpu_torch.utils.benchmarking import measure

BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
TILE_WORK = 1024 * 1024       # the TPU scripts' unit: a 1024 x 1024 tile


def card() -> torch.device:
    """The GPU, its name and power limit printed (nvidia-smi's line)."""
    dev = resolve_device("cuda")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {line}", flush=True)
    return dev


def inputs(dev, BH: int, BHk: int, M: int, N: int, seed: int = 0):
    """q (BH, M, 128), k, v (BHk, N, 128) bf16 from default_rng(seed),
    K and V distinct tensors."""
    rng = np.random.default_rng(seed)

    def mk(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
            dev, torch.bfloat16)

    return mk(BH, M, 128), mk(BHk, N, 128), mk(BHk, N, 128)


def stream_kwargs(probe: probes.Probe, M: int, N: int, dev) -> Dict:
    """The variant's zero int32 side and segment streams (the TPU
    scripts' `jnp.zeros`)."""
    zq = torch.zeros(M, dtype=torch.int32, device=dev)
    zk = torch.zeros(N, dtype=torch.int32, device=dev)
    return dict(qside=[zq] * probe.n_qside, kside=[zk] * probe.n_kside,
                qseg=zq if probe.branches else None,
                kseg=zk if probe.branches else None)


def operands(probe: probes.Probe, q, k, v, B: int):
    """The 3-D operands, viewed (B, H, rows, 128) for a strided variant."""
    if not probe.strided:
        return q, k, v
    return (q.view(B, -1, *q.shape[1:]), k.view(B, -1, *k.shape[1:]),
            v.view(B, -1, *v.shape[1:]))


def time_probe(probe: probes.Probe, q, k, v, scale: float, B: int = 1
               ) -> float:
    """Seconds a call of the variant (queue-delta `measure`, median of
    three), on operands as `operands` gives them."""
    M, N = q.shape[-2], k.shape[-2]
    qq, kk, vv = operands(probe, q, k, v, B)
    kw = stream_kwargs(probe, M, N, q.device)
    return measure(lambda: probes.flash_step(qq, kk, vv, probe, scale,
                                             **kw), device=q.device)


def tensor_core_s(probe: probes.Probe, BH: int, M: int, N: int) -> float:
    """The call's products at the bf16 tensor-core peak, seconds."""
    flops, _ = probes.work(probe, BH, 1, M, N)
    return flops / BF16_FLOPS_PER_S
