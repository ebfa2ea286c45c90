"""Wall-clock measurement utilities.

The reference times with CUDA events, median of 10.  `measure` keeps the
JAX package's queue-and-delta design on top of that: enqueue M calls
back-to-back between two CUDA events, wait for the last, and difference
two queue depths, so the fixed cost of starting and fencing a window
cancels.  On the GPU the window is read from CUDA events after
`torch.cuda.synchronize`; on the CPU (device="cpu", for tests) from
`time.perf_counter`, whose CPU ops return when done.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

from flash_attn_v100_tpu_torch.config import DeviceLike, resolve_device


def _window(fn: Callable, args, m: int, dev: torch.device) -> float:
    """Seconds for `m` back-to-back calls of fn(*args), fenced."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(m):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(m):
        fn(*args)
    return time.perf_counter() - t0


def measure(fn: Callable, *args, iters: int = 32, warmup: int = 2,
            repeats: int = 3, min_window_s: float = 0.1,
            device: DeviceLike = None) -> float:
    """Queue-delta timing: seconds per call of `fn(*args)` on `device`
    (default: the GPU, config.resolve_device).  Enqueues M calls
    back-to-back and differences two queue depths so fixed overhead
    cancels.

    The iteration count adapts until the measured window is at least
    `min_window_s`, and each depth is sampled `repeats` times taking
    medians."""
    dev = resolve_device(device)
    _window(fn, args, 1, dev)
    _window(fn, args, warmup, dev)    # second warmup: steady-state queue
    est = _window(fn, args, 8, dev) / 8
    n = max(iters, int(min_window_s / max(est, 1e-7)))
    n = min(n, 2048)
    t_small = statistics.median(_window(fn, args, warmup, dev)
                                for _ in range(repeats))
    t_big = statistics.median(_window(fn, args, warmup + n, dev)
                              for _ in range(repeats))
    return max((t_big - t_small) / n, 1e-9)


def tflops(flops: int, seconds: float) -> float:
    return flops / seconds / 1e12


def gbps(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 1e9


def attention_flops(B, M, N, Hq, D, causal=False) -> int:
    """Matmul FLOPs of one attention forward (QK^T + PV), the standard
    4*B*H*M*N*D convention; causal halves it."""
    f = 4 * B * Hq * M * N * D
    return f // 2 if causal else f
