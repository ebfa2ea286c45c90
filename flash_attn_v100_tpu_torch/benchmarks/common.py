"""What the benchmark scripts share: the card line and the device; for the
probes seeded inputs, a timer and one printed line a variant; for the
oracle suite seeded draws, the gate and the sliced oracle."""

from __future__ import annotations

import subprocess
from typing import Dict

import numpy as np
import torch

from flash_attn_v100_tpu_torch.config import resolve_device
from flash_attn_v100_tpu_torch.ops.cuda import probes
from flash_attn_v100_tpu_torch.ops.reference import mha_reference
from flash_attn_v100_tpu_torch.utils.benchmarking import measure
from flash_attn_v100_tpu_torch.utils.testing import max_abs_err

# fp32 bytes an oracle keeps a score element, forward and backward (scores,
# masked scores, exponentials, probabilities and their gradients)
ORACLE_BYTES_PER_SCORE = 48
CPU_ORACLE_BUDGET = 2 << 30
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
TILE_WORK = 1024 * 1024       # the TPU scripts' unit: a 1024 x 1024 tile


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def card() -> torch.device:
    """The GPU, its name and power limit printed (nvidia-smi's line)."""
    dev = resolve_device("cuda")
    print(f"card: {card_line()}", flush=True)
    return dev


def backend(device: str = "cuda") -> tuple:
    """(the device a bench script runs on, what it prints as `backend=`):
    the card and its nvidia-smi line, or the CPU (the kernels' plain
    versions) and "cpu"."""
    dev = resolve_device(device)
    return dev, card_line() if dev.type == "cuda" else "cpu"


def run_device(device: str = "cuda") -> torch.device:
    """The device a script runs on: the card (its line printed first) unless
    the caller asks for the CPU, where the kernels' plain versions run."""
    dev = resolve_device(device)
    return card() if dev.type == "cuda" else dev


def normal(rng: np.random.Generator, shape, dev,
           dtype=torch.bfloat16) -> torch.Tensor:
    """rng.standard_normal(shape) in `dtype` on `dev`, rounded on the host
    from float64 through fp32 as the JAX scripts' jnp.asarray rounds, so
    both draw the same bits."""
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype).to(dev)


def gate(x, x32, xnat, mult: float, atol: float):
    """The reference's relative gate: (error against the fp32 oracle, the
    same-dtype oracle's error, error <= mult x that + atol)."""
    e, e_nat = max_abs_err(x, x32), max_abs_err(xnat, x32)
    return e, e_nat, e <= mult * e_nat + atol


def oracle_budget(dev: torch.device) -> int:
    """Bytes an oracle slice may take: half the device's free memory."""
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[0] // 2
    return CPU_ORACLE_BUDGET


def oracle(q, k, v, do, upcast: bool, budget: int, alibi_slopes=None,
           **kw):
    """mha_reference's output (q (B, M, Hq, D), k/v (B, N, Hk, D)) and,
    given the output gradient `do`, its gradients (dq, dk, dv), computed
    over slices of (batch row, kv heads with their q heads) whose score
    tensors fit `budget` bytes; in fp32 when `upcast`, else in q's dtype.
    `alibi_slopes` is (Hq,) or (B, Hq); `kw` are mha_reference's masks."""
    B, M, Hq, D = q.shape
    N, Hk = k.shape[1], k.shape[2]
    group = Hq // Hk
    cd = torch.float32 if upcast else q.dtype
    per_score = ORACLE_BYTES_PER_SCORE * (2 if cd == torch.float64 else 1)
    step = max(1, min(Hk, budget // (per_score * M * N * group)))
    out = q.new_empty(q.shape, dtype=cd)
    grads = (None if do is None
             else [x.new_empty(x.shape, dtype=cd) for x in (q, k, v)])
    for b in range(B):
        for h in range(0, Hk, step):
            hq = slice(h * group, min(h + step, Hk) * group)
            hk = slice(h, min(h + step, Hk))
            leaves = [x[b:b + 1, :, hs].to(cd).requires_grad_(do is not None)
                      for x, hs in ((q, hq), (k, hk), (v, hk))]
            slopes = None
            if alibi_slopes is not None:
                slopes = (alibi_slopes[hq] if alibi_slopes.dim() == 1
                          else alibi_slopes[b:b + 1, hq])
            with torch.set_grad_enabled(do is not None):
                o = mha_reference(*leaves, upcast=upcast,
                                  alibi_slopes=slopes, **kw)
                if do is not None:
                    gs = torch.autograd.grad(o, leaves,
                                             do[b:b + 1, :, hq].to(cd))
                    for g, dst, hs in zip(gs, grads, (hq, hk, hk)):
                        dst[b:b + 1, :, hs] = g
            out[b:b + 1, :, hq] = o.detach()
    return out, grads


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
