"""Device-level profiling harness on `torch.profiler`: per-kernel device
time straight from the GPU's tracer (CUPTI), free of host noise.

    from flash_attn_v100_tpu_torch.utils.profiling import profile_ops
    ops = profile_ops(fn, *args)     # [(label, total_us, calls)]

The port's own kernels are labeled by their ids (K1 dense forward, K2 dQ,
K3 dK/dV, K4 decode, K4q its quantized pools, K5-K7 varlen, K8 paged
prefill, K8q its quantized pools); every other kernel keeps its CUDA name.
Where the trace has no device events (a CPU run), the CPU ops (`aten::...`)
are counted instead.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flash_attn_v100_tpu_torch.utils.debugging import trace

# chrome-trace categories of the device's own lane (user annotations
# mirrored there would double-count the kernels they enclose)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def capture_trace(fn, *args, iters: int = 3,
                  trace_dir: Optional[str] = None) -> str:
    """Run `fn(*args)` once, then `iters` times under torch.profiler (CPU
    and, where present, CUDA activities; `debugging.trace`).  Returns the
    directory holding the chrome trace (`trace.json`; a new temporary
    directory when `trace_dir` is None)."""
    fn(*args)  # first-call work (builds, allocator growth) outside the trace
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with trace(trace_dir) as d:
        for _ in range(iters):
            fn(*args)
    return d


def complete_events(trace_dir: str) -> List[dict]:
    """Every complete event (ph "X", with a duration) of the newest chrome
    trace under `trace_dir`: CPU ops, user annotations, runtime calls and
    the device lane's events, on one clock (µs)."""
    files = (glob.glob(os.path.join(trace_dir, "**", "*.json"),
                       recursive=True)
             + glob.glob(os.path.join(trace_dir, "**", "*.json.gz"),
                         recursive=True))
    if not files:
        raise FileNotFoundError(f"no chrome trace under {trace_dir}")
    path = max(files, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def trace_events(trace_dir: str) -> List[dict]:
    """The complete events `summarize_trace` counts, from the newest chrome
    trace under `trace_dir`: the device lane's (kernels, copies, fills),
    or, in a trace without one, the CPU ops."""
    done = complete_events(trace_dir)
    device = [e for e in done if e.get("cat") in DEVICE_CATS]
    return device or [e for e in done if e.get("cat") == "cpu_op"]


def summarize_trace(trace_dir: str, top: int = 0
                    ) -> List[Tuple[str, float, int]]:
    """Aggregate the events of `trace_events`: [(label, total_us, count)]
    sorted by total time (`_readable_label` names them)."""
    agg = defaultdict(lambda: [0.0, 0])
    for e in trace_events(trace_dir):
        lab = _readable_label(e)
        agg[lab][0] += float(e["dur"])
        agg[lab][1] += 1
    rows = sorted(((n, v[0], v[1]) for n, v in agg.items()),
                  key=lambda r: -r[1])
    return rows[:top] if top else rows


def _arg(args: Sequence[str], i: int, default: int = 0) -> int:
    """Template argument `i` as an int (`true`/`false`, casts dropped)."""
    if i >= len(args):
        return default
    a = re.sub(r"^\([\w:]+\)", "", args[i].strip())
    if a in ("true", "false"):
        return int(a == "true")
    return int(a)


# CUDA symbol of a port kernel -> its id, from the template arguments that
# tell the instantiations of one body apart (csrc/): fwd_kernel<T, D, MODE,
# EXTRA, KV, TN> with MODE 0 dense / 1 varlen / 2 paged and KV 0 16-bit / 1
# e4m3; dq_kernel / dkv_kernel<T, D, kVarlen, EXTRA, TN> and their head-dim
# 256 kernels dq_split_kernel / dkv_split_kernel<T, D, kVarlen, EXTRA>;
# decode_kernel<T, D, KIND, ROWS, ABL> with KIND 3 a 16-bit pool (a sweep
# library's variant takes its kernel's id); int_kernel<T, D, KIND, EXTRA>
# is K8q's int8/int4 kernel.
_PORT_KERNELS = {
    "fwd_kernel": lambda a: ("K1", "K5", "K8q" if _arg(a, 4) else "K8")[
        _arg(a, 2)],
    "dq_kernel": lambda a: "K6" if _arg(a, 2) else "K2",
    "dkv_kernel": lambda a: "K7" if _arg(a, 2) else "K3",
    "dq_split_kernel": lambda a: "K6" if _arg(a, 2) else "K2",
    "dkv_split_kernel": lambda a: "K7" if _arg(a, 2) else "K3",
    "decode_kernel": lambda a: "K4" if _arg(a, 2) == 3 else "K4q",
    "int_kernel": lambda a: "K8q",
}
# (the template arguments may hold one nested template: the kernels' tile
# parameters, FwdTune<...> / BwdTune<...>, after the ones read here)
_SYMBOL = re.compile(r"(?:^|[\s:])(" + "|".join(_PORT_KERNELS)
                     + r")<((?:[^<>]|<[^<>]*>)*)>")


def kernel_id(name: str) -> Optional[str]:
    """The port's id of a CUDA kernel name (demangled, with its template
    arguments), or None for any other kernel."""
    m = _SYMBOL.search(name)
    if m is None:
        return None
    return _PORT_KERNELS[m.group(1)](m.group(2).split(","))


def kernel_head_dim(name: str) -> Optional[int]:
    """The head dim of a port kernel's CUDA name (its second template
    argument in every body), or None for any other kernel."""
    m = _SYMBOL.search(name)
    return None if m is None else _arg(m.group(2).split(","), 1)


def _readable_label(e) -> str:
    """Label of a trace event: the port kernel's id, else its name."""
    name = e.get("name", "?")
    return kernel_id(name) or name


def kernel_ids(trace_dir: str) -> Dict[str, str]:
    """{CUDA name: id} of the port kernels in the trace, to check the id
    table against the names the compiler emitted."""
    return {e["name"]: kernel_id(e["name"]) for e in trace_events(trace_dir)
            if kernel_id(e.get("name", ""))}


def profile_ops(fn, *args, iters: int = 3, top: int = 20):
    """One-call convenience: capture + summarize the device ops of
    `fn(*args)`."""
    d = capture_trace(fn, *args, iters=iters)
    return summarize_trace(d, top=top)
