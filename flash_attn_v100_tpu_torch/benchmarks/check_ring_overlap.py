"""Check that the ring's KV transfer overlaps its attention: the card's
counterpart of the JAX repository's `benchmarks/check_ring_overlap.py`
(which reads the overlap off the compiled HLO schedule of a TPU mesh).

Here `parallel/ring.py::ring_attention` (contiguous, causal, B 1 x 8192,
4/4 heads x 128, bf16) runs forward on `--ranks` spawned gloo ranks under
`torch.profiler`.  Each ring step s < n - 1 first issues `ring_shift` of
the K/V chunk it holds (`parallel/mesh.py::ring_shift`), then launches its
chunk's K1, then waits for the transfer (`ring.py::_ring_fwd_loop`).  The
script wraps `ring_shift` in annotations: its window opens when
`ring_shift` returns (the chunk is in flight) and closes when the
transfer's wait returns.  A step overlaps when its K1's device interval
starts inside that window; every step that launches a chunk must.

What this can show: gloo's point-to-point takes host buffers only, so
`ring_shift` copies the CUDA chunk to the host synchronously before it
posts the send (`mesh.py::_staged`), and the received chunk goes back to
the card after the wait.  The window is the host-side transfer, so an OK
says K1 runs while gloo moves the chunk between processes; it is not an
NCCL or NVLink result.

A trace that lacks a K1 the rank launched or one of its shift windows
(the profiler recorded no kernel, or dropped an event) cannot show
overlap either way: every rank then traces the call again, together,
up to `TRACE_ATTEMPTS` times, and the verdict is read from the first
traces that hold every rank's K1s and windows; each attempt's counts
are reported.  A complete trace whose K1 misses its window fails; it is
never traced again.

The "quantify" part keeps the JAX script's ratio(B, M, Hq, Hk, D, shards)
arithmetic: a step's K+V chunk over the link against its attention at
K1's causal rate, measured here on the card (B 1 x `--rate-seqlen`, 32/8
heads x 128), with NVLink 4's published 450 GB/s a direction (NVIDIA H100
SXM data sheet: 900 GB/s of NVLink bandwidth, both directions) in place
of ICI's 45 GB/s.

    python -m flash_attn_v100_tpu_torch.benchmarks.check_ring_overlap
        [--ranks 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import re
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import (
    backend, normal, spawn_ranks, sync)
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.parallel import ring as ring_mod
from flash_attn_v100_tpu_torch.parallel.mesh import make_mesh
from flash_attn_v100_tpu_torch.utils.benchmarking import measure
from flash_attn_v100_tpu_torch.utils.debugging import trace
from flash_attn_v100_tpu_torch.utils.profiling import (
    DEVICE_CATS, complete_events, kernel_id)

# NVIDIA H100 SXM data sheet: NVLink 900 GB/s (both directions), so 450 GB/s
# a direction for the ring's one-hop shift
NVLINK_BYTES_PER_S = 450e9
# traced calls a rank makes at most while a rank's trace lacks an event
TRACE_ATTEMPTS = 3
SHIFT = "ring_shift {}"
SHIFT_WAIT = "ring_shift {} wait"
_ANNOTATION = re.compile(r"^ring_shift (\d+)( wait)?$")


def ratio(B: int, M: int, Hq: int, Hk: int, D: int, shards: int,
          link_bytes_per_s: float, kernel_flops_per_s: float):
    """The JAX script's arithmetic: (t_comm / t_comp, t_comm µs, t_comp µs)
    of one ring step: the K+V chunk (bf16) over the link against the
    step's causal attention at the kernel's rate."""
    m_shard = M // shards
    comm_bytes = 2 * B * m_shard * Hk * D * 2          # K+V chunk, bf16
    # per-step per-chip attention flops (causal halves the average)
    flops = 4 * B * m_shard * m_shard * Hq * D / 2
    t_comm = comm_bytes / link_bytes_per_s
    t_comp = flops / kernel_flops_per_s
    return t_comm / t_comp, t_comm * 1e6, t_comp * 1e6


def chunk_steps(rank: int, n: int) -> List[int]:
    """The steps at which a rank of the contiguous causal ring runs a chunk
    kernel: its own chunk, then each earlier rank's (later ranks' chunks
    are wholly masked: `ring.py::_contiguous_step`)."""
    return [s for s in range(n) if s <= rank]


def step_windows(events: List[dict]) -> Dict[int, Tuple[float, float]]:
    """{step: (µs the shift was in flight from, µs its wait returned)} from
    the annotations `annotated_shifts` puts in a trace."""
    ends, waits = {}, {}
    for e in events:
        m = _ANNOTATION.match(e.get("name", ""))
        if e.get("cat") != "user_annotation" or m is None:
            continue
        s, end = int(m.group(1)), float(e["ts"]) + float(e["dur"])
        if m.group(2):
            waits[s] = max(waits.get(s, end), end)
        else:
            ends[s] = end
    return {s: (ends[s], waits[s]) for s in ends if s in waits}


def chunk_kernels(events: List[dict], steps: List[int]
                  ) -> Dict[int, Tuple[float, float]]:
    """{step: (start, end) µs} of the chunk kernels (K1) on the device lane,
    in launch order, matched to the steps that run a chunk."""
    k1 = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e.get("cat") == "kernel"
                and kernel_id(e.get("name", "")) == "K1")
    return dict(zip(steps, k1))


def lane_counts(events: List[dict]) -> Tuple[int, int]:
    """(device-lane events, K1s among them) of a trace."""
    lane = [e for e in events if e.get("cat") in DEVICE_CATS]
    return len(lane), sum(e.get("cat") == "kernel"
                          and kernel_id(e.get("name", "")) == "K1"
                          for e in lane)


def overlapped(windows: Dict[int, Tuple[float, float]],
               kernels: Dict[int, Tuple[float, float]]) -> Dict[int, bool]:
    """{step: whether its chunk kernel ran on the device while its shift
    was in flight}: the kernel's interval meets the shift's window."""
    return {s: kernels[s][0] < w[1] and kernels[s][1] > w[0]
            for s, w in windows.items() if s in kernels}


def verdict(ranks: List[Dict], n: int) -> Tuple[int, int, bool]:
    """(steps with a chunk and a shift, those overlapped, OK): every step
    s < n - 1 that runs a chunk must overlap, and the last rank must show
    all n - 1 of its."""
    steps = [ok for r in ranks for ok in r["overlap"].values()]
    last = ranks[n - 1]["overlap"]
    ok = (all(steps) and len(last) == n - 1
          and all(last.get(s, False) for s in range(n - 1)))
    return len(steps), sum(steps), ok


@contextlib.contextmanager
def annotated_shifts():
    """Wrap the ring's `ring_shift` so a trace shows each shift: a span
    SHIFT over the call (the chunk staged and posted) and SHIFT_WAIT over
    each wait on its transfer."""
    orig = ring_mod.ring_shift
    count = [0]

    class _Timed:
        def __init__(self, work, i):
            self.work, self.i = work, i

        def wait(self):
            with torch.profiler.record_function(SHIFT_WAIT.format(self.i)):
                return self.work.wait()

    def shift(tensors, mesh, axis, tag=0):
        i = count[0]
        count[0] += 1
        with torch.profiler.record_function(SHIFT.format(i)):
            sh = orig(tensors, mesh, axis, tag)
        sh.works = [_Timed(w, i) for w in sh.works]
        return sh

    ring_mod.ring_shift = shift
    try:
        yield
    finally:
        ring_mod.ring_shift = orig


def k1_causal_flops_per_s(seqlen: int, dev) -> float:
    """K1's causal rate on this device at B 1 x seqlen, 32/8 heads x 128."""
    rng = np.random.default_rng(1)
    q = normal(rng, (1, seqlen, 32, 128), dev)
    k, v = (normal(rng, (1, seqlen, 8, 128), dev) for _ in range(2))
    dt = measure(lambda: flash_attn_func(q, k, v, causal=True), device=dev)
    return 4 * seqlen * seqlen * 32 * 128 / 2 / dt


def _rank(rank: int, world: int, cfg: Dict) -> Dict:
    import torch.distributed as dist
    dev = (torch.device("cuda", torch.cuda.current_device())
           if cfg["device"] == "cuda" else torch.device("cpu"))
    mesh = make_mesh(data=1, seq=world, model=1)
    rng = np.random.default_rng(0)
    B, M, H, D = cfg["B"], cfg["M"], cfg["H"], cfg["D"]
    q, k, v = (normal(rng, (B, M, H, D), dev) for _ in range(3))
    steps = chunk_steps(rank, world)
    attempts = []
    with torch.no_grad():
        ring_mod.ring_attention(q, k, v, mesh, causal=True)   # warm-up
        sync(dev)
        for _ in range(TRACE_ATTEMPTS):
            dist.barrier()
            with tempfile.TemporaryDirectory(prefix="fa_ring_") as d:
                with annotated_shifts(), trace(d):
                    ring_mod.ring_attention(q, k, v, mesh, causal=True)
                    sync(dev)
                events = complete_events(d)
            attempts.append(lane_counts(events))
            windows = step_windows(events)
            # every rank traces again while any rank's trace lacks one of
            # its K1s or shift windows
            whole = torch.tensor([int(dev.type != "cuda" or (
                attempts[-1][1] == len(steps)
                and len(windows) == world - 1))])
            dist.all_reduce(whole, op=dist.ReduceOp.MIN)
            if whole.item():
                break
    kernels = chunk_kernels(events, steps)
    res = dict(windows=windows, kernels=kernels, attempts=attempts,
               overlap=overlapped(windows, kernels))
    if rank == 0:
        res["k1_flops_per_s"] = k1_causal_flops_per_s(cfg["rate_seqlen"],
                                                      dev)
    return res


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seqlen", type=int, default=8192)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--rate-seqlen", type=int, default=4096,
                    help="sequence of the K1 causal rate measurement")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev, card = backend(args.device)
    print(f"card: {card}", flush=True)
    n = args.ranks
    B, M, H, D = args.batch, args.seqlen, args.heads, args.head_dim
    ranks = spawn_ranks(_rank, n, dict(
        B=B, M=M, H=H, D=D, rate_seqlen=args.rate_seqlen,
        device=dev.type), dev.type)
    for r, res in enumerate(ranks):
        for i, (lane, k1) in enumerate(res["attempts"]):
            print(f"rank {r} trace {i}: {lane} device-lane events, {k1} "
                  f"of its {len(chunk_steps(r, n))} K1s", flush=True)
        t0 = min((w[0] for w in res["windows"].values()), default=0.0)
        for s, w in sorted(res["windows"].items()):
            kern = res["kernels"].get(s)
            k = ("no K1 on the device lane" if kern is None else
                 f"K1 [{kern[0] - t0:9.1f}, {kern[1] - t0:9.1f}] "
                 f"{'overlapped' if res['overlap'][s] else 'NOT overlapped'}")
            print(f"rank {r} step {s}: shift in flight [{w[0] - t0:9.1f}, "
                  f"{w[1] - t0:9.1f}] us; {k}", flush=True)
    n_steps, n_over, ok = verdict(ranks, n)
    print(f"attention steps with a shift: {n_steps}; with the transfer in "
          f"flight: {n_over}")
    if dev.type == "cuda":
        print("ring overlap check:", "OK" if ok else "FAILED")
    else:
        ok = None
        print("ring overlap check: n/a (a CPU run has no device lane)")

    # ---- quantify: expected exposed-comm fraction per ring step ----
    rate = ranks[0]["k1_flops_per_s"]
    where = "the card" if dev.type == "cuda" else "the CPU"
    print(f"K1 causal rate: {rate / 1e12:.1f} TF/s (B1 S{args.rate_seqlen} "
          f"32/8 x 128, measured on {where})")
    r_toy, c_toy, p_toy = ratio(B, M, H, H, D, 8, NVLINK_BYTES_PER_S, rate)
    print(f"toy shape: comm {c_toy:.0f} us vs compute {p_toy:.0f} us per "
          f"step -> comm/compute = {r_toy:.2f} (B=1 H=4 over 8 shards, "
          f"NVLink 450 GB/s)")
    # realistic long-context shape: llama-70B heads, 32k ctx over 8 cards
    r, c_us, p_us = ratio(1, 32768, 32, 8, 128, 8, NVLINK_BYTES_PER_S, rate)
    print(f"realistic 32k/8-card llama shape: comm {c_us:.0f} us vs "
          f"compute {p_us:.0f} us per step -> comm/compute = {r:.2f} "
          f"(fully hidden while < 1)")
    print("ring overlap quantified:", "OK" if r < 1.0 else "EXPOSED")
    return dict(ranks=ranks, steps=n_steps, overlapped=n_over, ok=ok,
                ratio=r, ratio_toy=r_toy, k1_flops_per_s=rate)


if __name__ == "__main__":
    res = main()
    sys.exit(0 if res["ok"] is not False and res["ratio"] < 1.0 else 1)
