"""What the benchmark scripts share: the card line and the device; for the
probes seeded inputs, a timer and one printed line a variant; for the
oracle suite seeded draws, the gate and the sliced oracle; for the
measurement scripts a chained-call timer (as calls and as a CUDA-graph
replay), the device-busy reader over a trace, the seeded 16-layer d 4096
model and the spawn of gloo ranks; for the tile and unroll sweeps their
rows, timed in turns, and the rows' gates."""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import statistics
import subprocess
import tempfile
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from flash_attn_v100_tpu_torch.config import resolve_device
from flash_attn_v100_tpu_torch.models.transformer import (
    ModelConfig, init_params)
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import probes
from flash_attn_v100_tpu_torch.ops.cuda.decode import (
    paged_decode_attention_merged)
from flash_attn_v100_tpu_torch.ops.quant import dequantize_kv, quantize_kv
from flash_attn_v100_tpu_torch.ops.reference import mha_reference
from flash_attn_v100_tpu_torch.utils.benchmarking import measure
from flash_attn_v100_tpu_torch.utils.profiling import (
    DEVICE_CATS, trace_events)
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


# ------------------------------------------------- the measurement scripts

# the model of the JAX repository's prof_decode_attrib.py and
# prof_ttft_tail.py (their module-level ModelConfig): 16 layers, d 4096,
# 32/8 heads x 128, ffn 11008, bf16
MEASURE_MODEL = dict(vocab_size=32000, dim=4096, n_layers=16, n_heads=32,
                     n_kv_heads=8, head_dim=128, ffn_dim=11008,
                     max_seq_len=2560, dtype="bfloat16")
_MODEL_FLAGS = {"vocab_size": "--vocab-size", "dim": "--dim",
                "n_layers": "--layers", "n_heads": "--heads",
                "n_kv_heads": "--kv-heads", "head_dim": "--head-dim",
                "ffn_dim": "--ffn-dim", "max_seq_len": "--max-seq-len",
                "dtype": "--dtype"}


def add_model_flags(ap: argparse.ArgumentParser) -> None:
    """The model's widths as flags, MEASURE_MODEL's values their defaults."""
    for key, flag in _MODEL_FLAGS.items():
        val = MEASURE_MODEL[key]
        ap.add_argument(flag, type=type(val), default=val)


def measure_model(args: argparse.Namespace, dev: torch.device
                  ) -> Tuple[ModelConfig, Dict]:
    """(cfg, params) of the flags' model, seeded random weights
    (`init_params(cfg, seed=0)`, the JAX scripts' PRNGKey(0)) on `dev`."""
    kw = {key: getattr(args, flag[2:].replace("-", "_"))
          for key, flag in _MODEL_FLAGS.items()}
    kw["dtype"] = getattr(torch, kw["dtype"])
    cfg = ModelConfig(**kw)
    return cfg, init_params(cfg, seed=0, device=dev)


def params_gib(params) -> float:
    """The parameters' bytes, GiB (what a decode step streams once)."""
    leaves = [params[k] for k in params if k != "layers"] + [
        t for layer in params["layers"] for t in layer.values()]
    return sum(t.numel() * t.element_size() for t in leaves) / 2 ** 30


def randn(gen: torch.Generator, shape, dev, dtype=torch.bfloat16
          ) -> torch.Tensor:
    """Seeded normal draws made on `dev` (a pool of 2^28 values drawn on
    the host would take seconds; the values only feed timings)."""
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chained(fn: Callable, q: torch.Tensor, n: int) -> torch.Tensor:
    """`n` calls of fn chained as the JAX scripts' scan chains them: q <- q
    + 1e-6 * fn(q), so each call depends on the one before and none can be
    skipped or hoisted; returns the last q."""
    for _ in range(n):
        q = q + 1e-6 * fn(q).to(q.dtype)
    return q


def graph_seconds(fn: Callable, dev: torch.device, reps: int = 10
                  ) -> float:
    """Median seconds of one replay of `fn` captured in a CUDA graph, CUDA
    events around each replay (chip_smoke.graph_ms): fn's kernels without
    the host time of their Python wrappers."""
    fn()
    torch.cuda.synchronize(dev)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def chain_seconds(fn: Callable, q: torch.Tensor, n: int, dev: torch.device,
                  iters: int = 4) -> Tuple[float, Optional[float]]:
    """(seconds a call of fn in a chain of n, host included: `measure` of
    the chain over n; device seconds a call: a CUDA-graph replay of the
    chain over n, None on the CPU)."""
    def run():
        return chained(fn, q, n)
    call = measure(run, iters=iters, device=dev) / n
    return call, (graph_seconds(run, dev) / n if dev.type == "cuda"
                  else None)


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def device_lane(trace_dir: str, dev: torch.device) -> List[dict]:
    """The trace's events as `utils/profiling.trace_events` reads them
    (the device lane's, or on the CPU the CPU ops); on the card a trace
    with no device lane (the profiler recorded no kernel) raises, so a
    CPU op's time is never read as the device's."""
    events = trace_events(trace_dir)
    if dev.type == "cuda" and not all(e.get("cat") in DEVICE_CATS
                                      for e in events):
        raise RuntimeError(f"the trace under {trace_dir} has no device "
                           f"lane: the profiler recorded no kernel")
    return events


def device_busy_us(events: Iterable[dict]) -> float:
    """µs the device was busy over trace events (utils/profiling.
    trace_events: the device lane's, or a CPU trace's ops): the union of
    their intervals, so overlapping kernels count once."""
    return busy_us((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)


def pct(x: float, peak: float) -> float:
    return 100.0 * x / peak


def rate_line(B: int, dt: float, nbytes: int) -> str:
    """A decode variant's line: tok/s of a B-row step taking dt seconds,
    ms, GB/s over `nbytes` and its share of 3.35 TB/s."""
    bw = nbytes / dt / 1e9
    return (f"{B/dt:7.0f} tok/s  {dt*1e3:7.3f} ms  {bw:6.0f} GB/s  "
            f"({pct(bw * 1e9, HBM_BYTES_PER_S):5.1f}% of 3.35 TB/s)")


ROW_PAD = 8        # the JAX decode scripts' q rows a kv head (group 4, padded)
DECODE_PAGE = 256  # their pools' page; other page sizes are views of it


class DecodeCase:
    """The inputs of the JAX repository's prof_decode_scan.py and
    prof_decode_int8.py: K and V pools of their own, (Hk, B * ctx / 256,
    256, D) bf16 (a pool of ps-token pages is a view of them), GQA-folded q
    rows (B, Hk, 8, D), every row at `ctx` live tokens, and the pools'
    int8 quantization; `core` gives the decode call of a variant."""

    def __init__(self, gen, B: int, Hq: int, Hk: int, D: int, ctx: int,
                 dev):
        self.B, self.Hk, self.D, self.ctx = B, Hk, D, ctx
        self.group = Hq // Hk
        n = B * ctx // DECODE_PAGE
        self.kpool = randn(gen, (Hk, n, DECODE_PAGE, D), dev)
        self.vpool = randn(gen, (Hk, n, DECODE_PAGE, D), dev)
        self.q = randn(gen, (B, Hk, ROW_PAD, D), dev)
        self.cs = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        self.kq, self.ks = quantize_kv(self.kpool, torch.int8)
        self.vq, self.vs = quantize_kv(self.vpool, torch.int8)
        self.params = masklib.MaskParams(causal=False, window_left=-1,
                                         window_right=0)

    def nbytes(self, quant: bool) -> int:
        """The JAX scripts' count: K and V payload (int8: and the fp32
        scales) of every live token, once."""
        per = self.D + 4 if quant else self.D * 2
        return 2 * self.B * self.ctx * self.Hk * per

    def core(self, ps: int, kind: str) -> Callable:
        """q rows -> merged out (B, Hk, 8, D) through K4 (`kind` "bf16"),
        K4q ("int8"), or the int8 pools dequantized to bf16, then K4
        ("int8-deq", the TPU kernel's int8_matmul=False)."""
        Hk, D = self.Hk, self.D
        P_ = self.B * self.ctx // ps
        table = torch.arange(P_, dtype=torch.int32,
                             device=self.q.device).reshape(self.B, -1)

        def view(pool, last=D):
            return pool.reshape(1, Hk, P_, ps, last)
        kw = dict(softmax_scale=D ** -0.5, params=self.params, t_new=1,
                  group=self.group)
        if kind == "bf16":
            a, b = view(self.kpool), view(self.vpool)
            return lambda q: paged_decode_attention_merged(
                q, a, b, table, self.cs, None, **kw)[0]
        a, b = view(self.kq), view(self.vq)
        c, d = view(self.ks, 1), view(self.vs, 1)
        if kind == "int8":
            return lambda q: paged_decode_attention_merged(
                q, a, b, table, self.cs, None, k_scales=c, v_scales=d,
                **kw)[0]

        def deq(q):
            return paged_decode_attention_merged(
                q, dequantize_kv(a, c), dequantize_kv(b, d), table, self.cs,
                None, **kw)[0]
        return deq


SPAWN_TIMEOUT_S = 600


def spawn_ranks(fn: Callable, world: int, payload, device: str,
                timeout_s: float = SPAWN_TIMEOUT_S) -> List:
    """Run fn(rank, world, payload) on `world` spawned processes in one
    gloo process group (a file:// rendezvous in a temporary directory, as
    tests/torch_parallel_cases.py::spawn does); on CUDA rank r takes card
    r % device_count (on a one-card machine every rank shares the card).
    Returns the ranks' results in rank order; a rank that raises fails
    the spawn."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="fa_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(world, tmp, fn, payload, device), nprocs=world,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks took over {timeout_s} s")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(rank: int, world: int, tmp: str, fn: Callable, payload,
               device: str) -> None:
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    try:
        res = fn(rank, world, payload)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# ------------------------------------------------ the tile and unroll sweeps

NEEDS_CARD = ("needs the card (a build variant of the kernel, "
              "benchmarks/variants.py: no plain version of its own)")
TIMING_ONLY = "TIMING ONLY: wrong numbers on purpose, checked finite"


@dataclasses.dataclass
class SweepRow:
    """One row of a sweep script: `fn` maps the chain's q to a tensor of
    q's shape (chained as `chained` chains it); None for a row that does
    not run here (`note` says why).  A variant row names its kernel and
    variant (its registers, spills and shared memory are printed); `check`
    holds its output against the plain twin (or, timing-only, checks it
    finite) once before the timing and returns the gate's text."""
    name: str
    fn: Optional[Callable]
    q: Optional[torch.Tensor] = None
    flops: Optional[int] = None
    nbytes: Optional[int] = None
    batch: Optional[int] = None       # tok/s of a decode row
    kernel: Optional[str] = None
    variant: Optional[str] = None
    check: Optional[Callable[[], str]] = None
    note: str = ""


def sweep_card(device: str) -> Tuple[torch.device, str]:
    """(device, its line) for a sweep script, the line printed."""
    dev, line = backend(device)
    print(f"card: {line}", flush=True)
    return dev, line


def run_sweep(rows: List[SweepRow], dev: torch.device, chain: int,
              rounds: int, iters: int) -> Dict[str, Dict]:
    """Checks first, then every runnable row timed in turns (round r runs
    each row once, A B A B): `chain_seconds` of a chain of `chain` calls,
    the median of the rounds, as a call with its host time and (on the
    card) as a CUDA-graph replay's device time; on the card also one call
    alone as a graph replay (`alone_s`: the kernels without the chain's
    q + 1e-6 o).  Prints one line a row and returns {name: its numbers}."""
    from flash_attn_v100_tpu_torch.benchmarks import variants as var
    checks = {r.name: r.check() for r in rows
              if r.fn is not None and r.check is not None}
    times = {r.name: [] for r in rows if r.fn is not None}
    for _ in range(rounds):
        for r in rows:
            if r.fn is not None:
                times[r.name].append(chain_seconds(r.fn, r.q, chain, dev,
                                                   iters=iters))
    # on the card, one call alone (a CUDA-graph replay, no chain): the
    # kernels' device time without the chain's elementwise step
    alone = {r.name: graph_seconds(lambda r=r: r.fn(r.q), dev)
             for r in rows if r.fn is not None and dev.type == "cuda"}
    out = {}
    for r in rows:
        res = dict(flops=r.flops, nbytes=r.nbytes, kernel=r.kernel,
                   variant=r.variant)
        info = ""
        if r.variant is not None:
            res["timing_only"] = var.timing_only(r.kernel, r.variant)
            info = f"   [{r.kernel} {r.variant}: {var.WHAT[(r.kernel, r.variant)]}"
            if dev.type == "cuda":
                res["occupancy"] = var.occupancy(r.kernel, r.variant)
                info += "; " + var.occupancy_text(res["occupancy"])
            info += "]"
        if r.fn is None:
            print(f"{r.name}: {r.note or NEEDS_CARD}{info}", flush=True)
            out[r.name] = dict(res, skipped=r.note or NEEDS_CARD)
            continue
        runs = times[r.name]
        dt = statistics.median(t[0] for t in runs)
        ddt = (statistics.median(t[1] for t in runs) if dev.type == "cuda"
               else None)
        res.update(call_s=dt, device_s=ddt, runs=[t[0] for t in runs],
                   check=checks.get(r.name), alone_s=alone.get(r.name))
        line = f"{r.name}: " + _rate(r, dt, res, "", dev.type == "cuda")
        line += f"  runs={['%.3f' % (t[0] * 1e3) for t in runs]}"
        if ddt is not None:
            line += "; device " + _rate(r, ddt, res, "device_", True)
            line += f"; one call alone {alone[r.name] * 1e3:.3f} ms"
        if checks.get(r.name):
            line += f"; {checks[r.name]}"
        print(line + info, flush=True)
        out[r.name] = res
    return out


def _rate(r: SweepRow, dt: float, res: Dict, key: str, card: bool) -> str:
    """A row's rate over dt seconds (TF/s against 989, or GB/s against
    3.35 TB/s with tok/s), recorded in res under `key`; off the card no
    share of a device peak."""
    if r.flops is not None:
        tf = r.flops / dt / 1e12
        res[key + "tflops"] = tf
        share = (f" ({pct(tf * 1e12, BF16_FLOPS_PER_S):5.1f}% of 989)"
                 if card else " (cpu)")
        return f"{tf:6.1f} TF/s {dt * 1e3:8.3f} ms" + share
    gb = r.nbytes / dt / 1e9
    res[key + "gbps"] = gb
    if not card:
        return f"{r.batch / dt:7.0f} tok/s {dt * 1e3:8.3f} ms (cpu)"
    return rate_line(r.batch, dt, r.nbytes)


def gate_text(out, ref32, ref_native, mult: float, atol: float, name: str
              ) -> str:
    """Hold `out` to the plain twin at the shipped kernel's gate (error
    against the fp32 twin <= mult x the same-dtype twin's + atol), raising
    where it is missed; the gate's text for the row's line."""
    e, e_nat, ok = gate(out, ref32, ref_native, mult, atol)
    if not ok or not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{name}: err {e:.3e} > gate {mult} x "
                             f"{e_nat:.3e} + {atol:g}")
    return f"{name} err {e:.2e} <= {mult * e_nat + atol:.2e}"


def finite_text(*ts: torch.Tensor) -> str:
    """The timing-only rows' check: finite outputs (raises otherwise)."""
    for t in ts:
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError("a timing-only row gave non-finite values")
    return TIMING_ONLY
