"""Debug instrumentation: NaN/Inf scans, stage reports, and a
profiler-trace helper.

Counterpart of the reference's compile-gated kernel instrumentation
(`include/debug.h`: stage-aware NaN scans) and of its ncu scripts: find the
first non-finite value, scan every output and gradient of a call, and
capture a `torch.profiler` trace.  The JAX package's `compiled_hlo` (the
optimized XLA program of a jitted function) has no torch counterpart: the
port's kernels are CUDA sources built by nvcc, whose registers and spills
`ops/cuda/build.py` keeps in each library's build log.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def find_nonfinite(x: Any, name: str = "array") -> Optional[Dict[str, Any]]:
    """First non-finite entry of `x` (index, value, counts), or None.

    Analog of the reference's per-stage `__CHECK_ERRORS` scan, run on the
    host."""
    a = torch.as_tensor(x).detach().to("cpu", torch.float32).numpy()
    bad = ~np.isfinite(a)
    if not bad.any():
        return None
    idx = tuple(int(i) for i in np.argwhere(bad)[0])
    return dict(name=name, index=idx, value=float(a[idx]),
                num_nan=int(np.isnan(a).sum()),
                num_inf=int(np.isinf(a).sum()), shape=a.shape)


def assert_finite(x: Any, name: str = "array") -> None:
    info = find_nonfinite(x, name)
    assert info is None, f"non-finite in {info['name']}: {info}"


def _leaves_with_keys(tree, key: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs keyed as `jax.tree_util.keystr` keys a path:
    `[i]` for a sequence item, `['k']` for a dict entry; None is an empty
    subtree."""
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in _leaves_with_keys(t, f"{key}[{i}]")]
    if isinstance(tree, dict):
        return [kv for k, t in tree.items()
                for kv in _leaves_with_keys(t, f"{key}[{k!r}]")]
    return [(key, tree)]


def stage_report(fn: Callable, args: Sequence[Any],
                 kwargs: Optional[Dict[str, Any]] = None, *,
                 grad_argnums: Optional[Tuple[int, ...]] = None,
                 verbose: bool = True) -> Dict[str, Any]:
    """Run `fn(*args, **kwargs)` and scan every output leaf - and, if
    `grad_argnums` is given, the gradient of the first output leaf's fp32
    sum with respect to each of those arguments - for non-finites.

    Returns {stage_name: scan_result_or_None}, keyed as the JAX package's
    report ("out", "out[0]", ..., "grad[arg0]", ...)."""
    kwargs = dict(kwargs or {})
    report: Dict[str, Any] = {}

    with torch.no_grad():
        out = fn(*args, **kwargs)
    for path, leaf in _leaves_with_keys(out):
        key = "out" + path
        report[key] = find_nonfinite(leaf, key)

    if grad_argnums:
        fresh = list(args)
        for i in grad_argnums:
            fresh[i] = args[i].detach().requires_grad_(True)
        with torch.enable_grad():
            first = _leaves_with_keys(fn(*fresh, **kwargs))[0][1]
            grads = torch.autograd.grad(first.to(torch.float32).sum(),
                                        [fresh[i] for i in grad_argnums],
                                        allow_unused=True)
        for gi, g in zip(grad_argnums, grads):
            key = f"grad[arg{gi}]"
            report[key] = find_nonfinite(
                torch.zeros_like(fresh[gi]) if g is None else g, key)

    if verbose:
        for k, v in report.items():
            print(f"  {k}: {'OK' if v is None else v}")
    return report


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Capture a torch.profiler trace of the enclosed code (CPU and, where
    present, CUDA activities) as `logdir/trace.json` (chrome://tracing,
    Perfetto; a new temporary directory when `logdir` is None) - the ncu
    analog."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or tempfile.mkdtemp(prefix="fa_trace_")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
