#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout (`nvcc`, sm_90a, one process per
source, all at once) and holds each against its plain PyTorch version at the
shapes its main path gives it, timing the kernel, the plain version and one
PyTorch library call computing the same function:
  * K1 dense forward, K2 dQ and K3 dK/dV at the training shape (B 4,
    S 2048, 32/4 heads x 64, causal, bf16), with and without dropout, the
    dropout keep mask read back from K1 and compared bit for bit, two
    backward calls compared bit for bit, K1 at the headline prefill shape
    (B 4, S 4096, 32/8 heads x 128) against SDPA, and the three kernels'
    registers, spills, shared memory and resident warps a multiprocessor
    at D 64 and 128;
  * K5 varlen forward, K6 dQ and K7 dK/dV (K1's, K2's and K3's bodies
    instantiated for packed sequences) at the same width through
    flash_attn_varlen_func: 4 x 2048 equal lengths bit-equal to
    flash_attn_func, gradients included (with dropout: K5's keep mask read
    back), a padded batch through unpad_input / pad_input, each sequence
    bit-equal to flash_attn_func on it alone, and packed documents, where
    each kernel is held against its plain version; K6/K7's occupancy;
  * K4 decode (its splits merged in the launch) and K8 paged prefill
    (K1/K5's body instantiated for a page pool) at the serving engine's
    shapes, both also per row with a wrong-tile check (K4: one late
    32-key chunk), K4's merged output against merge_partials of its
    partials, K4 at a 32k-context decode against its bound, and
    K4/K4q's and K8/K8q's registers, spills, shared memory and resident
    warps a multiprocessor at D 64 and 128;
  * their quantized variants K4q and K8q over int8, fp8 (e4m3) and int4
    pools at the same shapes, against their plain twins and the fp32
    oracle over the dequantized pool, all eight timed in turns over
    5 x 100 launches (the spread of each), also as CUDA-graph replays
    (their device time without the wrapper's host time);
  * head dim 256 (`d256_checks`, after the dense phase) at Gemma-2B's
    attention, B 4 x 2048, 8 q heads over 1 kv head: K1 and K3 (K2 with
    them) against their plain versions with and without dropout, K5 / K6
    / K7 on equal lengths bit-equal to K1 / K2 / K3 and on packed
    documents against theirs, K8 and K8q fp8 at the prefill wave; each
    D 256 kernel's occupancy, SASS HGMMA count (> 0 for the wgmma ones)
    and local memory (none), and K1-K3 at (a) 1 x 32 x 8192^2 and (b)
    that batch, causal and full, beside SDPA and the bound;
  * head dim 32 (`d32_checks`, after it): K1-K3 at B 4 x 2048, 32/4
    heads against their plain versions, K5 / K6 / K7 on equal lengths
    bit-equal to them, the small encoders' batch (256 sequences of 16-512
    tokens, 12/12 heads) through unpad_input -> flash_attn_varlen_func
    -> pad_input and back (one launch each of K5-K7) against the plain
    versions, K8 and K8q fp8 at the prefill wave; SASS HGMMA (K1, K5, K8,
    K8q fp8, K3, K7), HMMA (K2, K6) and MUFU.EX2 counts, no local memory;
    times beside SDPA / varlen_attn and a bound that counts one ex2 a
    live pair.
Then the drop-in phase: in a fresh process the port takes the canonical
`flash_attn` import name (`utils/distinfo.install_canonical_name`, no JAX
imported) and HF transformers' padded-attention pattern (unpad_input ->
flash_attn_varlen_func -> pad_input, forward and backward), flash_attn_func,
one decode step and one paged prefill run through that name at
TinyLlama-1.1B's width against the fp32 oracle (K5-K7, K1-K3, K4, K8, one
launch each, the plain twins never called); then the hardware oracle
suite (`benchmarks/hw_oracle.py --quick`: the dense, varlen and decode
sweeps, the decode fast-path cases and the fuzz) in this process, every
case within its gate.
Then it trains TinyLlama-1.1B at full width (22 layers, bf16, random weights
from a seed) for three AdamW steps at B 4 x S 2048 through K1-K3, fine-tunes
LoRA adapters on the frozen base at the same shape through K1-K3
(integrations/lora.py), drives the paged serving engine at the same width
through K4 and K8, again from the same weights imported as an HF Llama
checkpoint (integrations/huggingface.py, with TinyLlama's config.json
fields), then once from each quantized pool through K4q and K8q, checking
each path's output and launch counts; the training, LoRA and decode steps
are profiled through utils/profiling.py.  Then the sharded paths
(parallel/) on four gloo processes sharing the card: the 32k-context
decode with its context sharded four ways (bf16 and int8) against the
unsharded call and the fp32 oracle, head-sharded K1 at the headline shape
bit for bit per head, and the sharded serving engine at TinyLlama width
(seq 2 x model 2 from bf16 and int8 pools, model 2 alone) against the
unsharded run, with each rank's K4 / K4q / K8 launch counts.  Last, the
sequence-parallel training path on four more such processes: ring
attention at the headline head shape over seq 4 (contiguous, zigzag, and
with a window; forward and backward) against the fp32 oracle, Ulysses
bit for bit against the unsharded kernels, and make_train_step(mesh=) at
TinyLlama width (cut to 8 layers) on seq 2 x model 2 against the
unsharded run, with each rank's K1-K3 launch counts.  Then the cost probes P1-P4 (`phase_probes`,
run after the quantized kernels): each probe variant's SASS holds the
tensor-core (HGMMA) and exp2 (MUFU.EX2) instructions its stages claim,
P4's kernels integer wgmma (IGMMA .S8.S8) and no mma.sync (IMMA),
the four probe scripts (`python -m flash_attn_v100_tpu_torch.benchmarks.*`)
run as the probes' main path, and every variant is held against its plain
twin at the TPU scripts' shapes and timed in turns beside SDPA (P1-P3) or
torch._int_mm (P4).  Then `phase_fp32`: the fp32 bodies of K1-K8
(csrc/fwd_f32.cu, bwd_f32.cu, decode_f32.cu) at the same shapes in fp32,
each against its plain twin and an fp64 oracle (forward within 2 x the
twin's error + 1e-5, gradients 3 x + 1e-4) and timed beside it and fp32
SDPA; TinyLlama-1.1B's widths in fp32 (8 of its 22 layers) trained for
three AdamW steps through K1-K3 (step 1's loss and every gradient against
the plain path's)
and serving 8 requests through K8 and K4 (logits against the plain
twins', greedy tokens against a plain run's), and the same for
ModelConfig.tiny(); then fp32 q over int8, fp8 and int4 pools on K4q's
and K8q's fp32 instantiations: each against its plain twin and the fp32
oracle over the dequantized pool at the decode step and the prefill wave,
timed beside fp32 SDPA, ModelConfig.tiny() served from each pool with the
tokens of a direct paged_forward loop, and the TinyLlama fp32 serve again
from an int8 pool; the ring phase also takes one
make_lora_train_step(mesh=) step on seq 2 x model 2 against the unsharded
LoRA step, with a planted fault.  After the ring phase, `phase_d256`
runs the repo's Llama body at Gemma-2B's widths (head dim 256; random
weights): two AdamW steps at B 4 x S 2048 cut to 2 layers through K1-K3
(step 1's losses and gradients against the plain attention's), then the
engine runs' traffic at full depth (18 layers) through K8 and K4, every
forward call's logits and greedy tokens against a plain replay of it;
`phase_d32` does the same at all-MiniLM-L6-v2's widths (head dim 32, 6
layers, not cut).
Last, `phase_bench` runs the port's bench
(`python -m flash_attn_v100_tpu_torch.bench`: its headline JSON line must
carry a value > 0) and the three examples as subprocesses on the card
(train_seq_parallel on 2 gloo ranks), and `phase_scripts` the port's
bench scripts (bench_serving, bench_decode, bench_lora_sft at 3 steps; in
this process) and the multi-process dryrun (8 gloo ranks on the card, a
subprocess), each finishing with finite numbers.  Then `phase_measure`
runs the port's measurement and attribution scripts in one fresh process
(prof_calibrate, profile_kernels, the decode timing probes, prof_int4_rmw,
prof_decode_attrib and prof_ttft_tail at the JAX scripts' widths with
fewer rounds, requests and knob sets, bench_scaling and
check_ring_overlap on 2 gloo ranks) and checks what each reports: no rate
past the card's peaks, port kernels on top of each profile, equal int4
append bytes, a decode step's device time within the engine's, TTFT p50
<= p90, the 2-rank outputs within their gates, each ring step's K1 inside
its shift's window; in the same process `phase_sweeps` runs the nine tile
and unroll sweeps (their variant libraries built with the shipped ones)
at the JAX shapes with one round and one or two variants each: no rate
past a peak, every same-function variant within its kernel's gate
against the plain twin, the shipped rows within PERF.md's spread of
profile_kernels' rows of the same kernels.  Prints the card, a `kernels`
JSON line, and as its last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
Any failed phase raises and the script exits non-zero; with no GPU, or
without the package beside it, it exits non-zero and prints no result.

    python3 chip_smoke.py --dense-times TREE

instead times K1-K3 of the port found in the directory TREE (a checkout,
e.g. of a parent commit) at the training shape and at head dim 256 (both
`d256_checks` shapes, causal and full, beside SDPA and the bound) and
prints a digest of each kernel's outputs and the D 256 kernels'
occupancy, to compare two trees on one card in one call;

    python3 chip_smoke.py --varlen-times TREE

does the same for K5-K7 at the varlen phase's packed documents,

    python3 chip_smoke.py --d32-times TREE

for K1-K3 at head dim 32 (B 4 x 2048, 32 / 4 heads, causal and full),
K5 (non-causal) and K6 / K7 (causal) on the small encoders' batch (256
sequences of 16-512 tokens, 12 / 12 heads x 32) and K1 at sweep_dense's
4 x 16 x 1024^2 at D 16 and 32 (a call, and the kernel alone as a graph
replay), each beside SDPA / varlen_attn and a bound that counts the
exponentials at the SM clock measured under load, and

    python3 chip_smoke.py --paged-times TREE

for K8 and K8q (int8, fp8, int4) at the K8 phase's shape and K8 at the
headline head shape (32 / 8 heads x 128), timed in turns;

    python3 chip_smoke.py --decode-times TREE

for K4 and K4q (int8, fp8, int4) through flash_attn_with_kvcache and
paged_decode_attention at the engine's decode step, its short-prompt
prefill and a 32k-context decode, with the SM clock and power around
each round.

    python3 chip_smoke.py --probe-times TREE

for every P1-P3 probe row of the probe phase and both P4 kernels at
4096^3 (three rounds in turns: medians and output digests), with P4's
host time a call.

    python3 chip_smoke.py --fp32-times TREE

for the fp32 bodies: K1-K3 at the training shape, at B 1 x 4096^2,
32 / 32 heads x 128 and at 4 x 2048, 32 / 4 heads x 32 (beside fp32
SDPA with heads repeated on its efficient backend, and with enable_gqa),
K5 / K6 / K7 at the packed documents, K8 at the prefill wave (graph
replays, ms and kcycles under each kernel's own clock, digests) and the
8-layer fp32 TinyLlama AdamW step.

    python3 chip_smoke.py --serve-times ROUNDS

instead serves the engine runs' traffic from a bf16, an int8, an fp8 and
an int4 pool in turns, ROUNDS times each after a warm-up round, and prints
each pool's decode tok/s and TTFT p50 with their medians and quartiles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
SEED = 0
BENCH_TIMEOUT_S = 480         # the port's bench in phase_bench
EXAMPLE_TIMEOUT_S = 180


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of one call, CUDA events around each call; the L2
    is flushed before each timed call when `flush` is given: a tensor
    larger than the L2, zeroed, or a callable, called."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if callable(flush):
            flush()
        elif flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 20, flush=None) -> float:
    """Median device time of one call replayed from a CUDA graph (CUDA
    events around each replay, the L2 flushed before it when `flush` is
    given): the call's kernels without the host's time in its Python
    wrapper, which a short kernel would otherwise wait on."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    return time_ms(torch, g.replay, reps=reps, warmup=1, flush=flush)


def bound_ms(nbytes: float, flops: float, ops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gather_kv(torch, kp, vp, tbl, lens, ps):
    """Each sequence's K/V gathered from (Hk, P, ps, D) pools through its
    block-table row into contiguous (B, Hk, max len, D), zeros past its
    length: the input of the SDPA yardstick (pre-gathered KV)."""
    B, Hk, D = len(lens), kp.shape[0], kp.shape[-1]
    kc = kp.new_zeros((B, Hk, int(max(lens)), D))
    vc = torch.zeros_like(kc)
    for b in range(B):
        n = int(lens[b])
        pages = tbl[b, :-(-n // ps)].long()
        kc[b, :, :n] = kp[:, pages].reshape(Hk, -1, D)[:, :n]
        vc[b, :, :n] = vp[:, pages].reshape(Hk, -1, D)[:, :n]
    return kc, vc


def decode_sdpa(torch, q, kc, vc, lens_d, group):
    """SDPA of the decode step (one new token, q rows (B, Hk, >= group, D))
    over pre-gathered KV, masked to each sequence's length."""
    B, Hk, _, D = q.shape
    qs = q[:, :, :group].reshape(B, Hk * group, 1, D)
    mask = (torch.arange(kc.shape[2], device=q.device)[None, :]
            < lens_d[:, None].long())[:, None, None, :]
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask,
                                                  enable_gqa=True)


def prefill_sdpa(torch, q, kc, vc, prefix, T):
    """SDPA of a paged prefill (B sequences of T new tokens behind cached
    prefixes, packed q (B * T, Hq, D)) over pre-gathered KV, bottom-right
    causal."""
    B, dev = len(prefix), q.device
    qs = q.view(B, T, q.shape[1], q.shape[2]).transpose(1, 2)
    kpos = torch.arange(kc.shape[2], device=dev)[None, None, :]
    qpos = (torch.arange(T, device=dev)[None, :, None]
            + prefix.to(dev)[:, None, None])
    mask = (kpos <= qpos)[:, None]
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask,
                                                  enable_gqa=True)


def make_pool(torch, gen, dev, Hk, n_pages, ps, D, dtype):
    shape = (Hk, n_pages, ps, D)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return k, v


def paged_tables(torch, gen, lens, ps, max_pages, dev):
    """Block tables over a shuffled pool: sequence b owns ceil(len/ps)
    distinct pages; unused slots point at page 0."""
    need = [-(-int(n) // ps) for n in lens]
    perm = torch.randperm(sum(need) + 1, generator=gen, device="cpu")
    perm = perm[perm != 0]
    tbl = torch.zeros((len(lens), max_pages), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        tbl[b, :n] = perm[at:at + n].to(torch.int32)
        at += n
    return tbl.to(dev), sum(need) + 1


# ---------------------------------------------------------------- K4 phase

def gated(torch, out, ref32, ref_native, name, mult=None, atol=None):
    """assert_close_rel against the fp32 plain version; returns the error
    and the gate it was held to (mult x the native plain error + atol)."""
    from flash_attn_v100_tpu_torch.utils import testing as tt
    mult = tt.FWD_MULT if mult is None else mult
    atol = tt.FWD_ATOL if atol is None else atol
    err = tt.assert_close_rel(out, ref32, ref_native, mult, atol, name=name)
    return err, mult * tt.max_abs_err(ref_native, ref32) + atol


# the per-row gate's floors: a bf16 unit roundoff of the row's own RMS (the
# rounding of the kernel's bf16 output alone stays below it) and 1e-3 of
# the whole tensor's RMS (rows whose exact value is ~0)
ROW_REL_FLOOR, ROW_ABS_FLOOR = 2.0 ** -8, 1e-3


def gated_rows(torch, out, ref32, ref_native, name, mult, check=True):
    """The gate that scales with the values, beside `gated`'s max-abs one:
    each row over the head dim (a (b, q row, head) of out or dq, a (b, key,
    kv head) of dk or dv) has its RMS error against the fp32 plain version
    held to mult x the native plain version's RMS error on the same row +
    ROW_REL_FLOOR x the row's RMS + ROW_ABS_FLOOR x the tensor's RMS.
    Returns (worst error / gate over the rows, median |ref|, median gate);
    asserts the worst is at most 1 unless `check` is false."""
    import numpy as np
    ref = ref32.float()
    rms = ref.pow(2).mean(-1).sqrt()
    e_k = (out.float() - ref).pow(2).mean(-1).sqrt()
    e_n = (ref_native.float() - ref).pow(2).mean(-1).sqrt()
    gate = (mult * e_n + ROW_REL_FLOOR * rms
            + ROW_ABS_FLOOR * float(ref.pow(2).mean().sqrt()))
    ratio = (e_k / gate).flatten()
    i = int(ratio.argmax())
    at = tuple(int(x) for x in np.unravel_index(i, tuple(rms.shape)))
    assert not check or float(ratio[i]) <= 1.0, (
        f"{name}: row {at}: RMS err {float(e_k.flatten()[i]):.3e} "
        f"> gate {float(gate.flatten()[i]):.3e} ({mult} x native "
        f"{float(e_n.flatten()[i]):.3e}, row RMS "
        f"{float(rms.flatten()[i]):.3e})")
    return float(ratio[i]), float(ref.abs().median()), float(gate.median())


def check_merged(torch, om, lsem, o, lse, name):
    """The merged entry (one launch) against merge_partials of the same
    kernel's partials: each row's RMS error within 2^-8 of its RMS (the
    rounding to q's 16-bit type) + 1e-6, the LSE within 1e-5."""
    o = o.float()
    err = (om.float() - o).pow(2).mean(-1).sqrt()
    ratio = float((err / (2.0 ** -8 * o.pow(2).mean(-1).sqrt() + 1e-6)).max())
    fin = torch.isfinite(lse)
    assert torch.equal(fin, torch.isfinite(lsem)), f"{name}: -inf rows"
    lse_err = float((lsem[fin] - lse[fin]).abs().max()) if fin.any() else 0.0
    assert ratio <= 1.0 and lse_err <= 1e-5, (name, ratio, lse_err)
    return ratio, lse_err


def k4_occupancy(build) -> dict:
    """K4 (bf16 and fp32 pools) and K4q (each payload kind, bf16 q) at D
    32 / 64 / 128 / 256, in 16-row blocks (Rq <= 16: the warps split the
    keys) and 64-row ones: registers, local memory, dynamic shared memory
    (without the page table), threads and resident blocks a
    multiprocessor, from `fa_decode_occupancy` /
    `fa_decode_f32_occupancy` / `fa_decode_quant_occupancy`.  Asserts no
    local memory but for DECODE_SPILLS, and >= 8 resident warps at 16 rows
    but for DECODE_ONE_BLOCK (as
    tests/test_torch_gpu.py::test_decode_kernels_use_no_local_memory)."""
    import ctypes
    from flash_attn_v100_tpu_torch.ops.cuda.decode import KIND_CODE
    res = {}
    for name in ("K4", "K4 fp32") + tuple(f"K4q {kind}"
                                          for kind in QUANT_KINDS):
        for D in (32, 64, 128, 256):
            for rows in (16, 64):
                out = (ctypes.c_int * 5)()
                at = ctypes.addressof(out)
                if name == "K4":
                    rc = build.load("decode").fa_decode_occupancy(0, D, rows,
                                                                  at)
                elif name == "K4 fp32":
                    rc = build.load("decode_f32").fa_decode_f32_occupancy(
                        2, D, rows, at)
                else:
                    rc = build.load("decode_quant").fa_decode_quant_occupancy(
                        KIND_CODE[name.split()[1]], 0, D, rows, at)
                build.check(rc, f"{name} occupancy")
                blocks, smem, threads, regs, local = out
                o = res[(name, D, rows)] = dict(
                    registers=regs, local_bytes=local, smem_bytes=smem,
                    threads=threads, blocks_per_sm=blocks,
                    warps_per_sm=blocks * threads // 32)
                print(f"{name} occupancy ({'fp32' if 'fp32' in name else 'bf16'}"
                      f", D {D}, {rows}-row blocks): "
                      f"{regs} registers, local memory {local} B, {smem} B "
                      f"dynamic shared memory and {threads} threads a block, "
                      f"{blocks} blocks = {o['warps_per_sm']} warps resident "
                      f"a multiprocessor", flush=True)
                assert local == 0 or (name, D) in DECODE_SPILLS, \
                    f"{name} D {D} rows {rows} spills"
                assert rows > 16 or o["warps_per_sm"] >= 8 or \
                    (name, D) in DECODE_ONE_BLOCK, \
                    f"{name} D {D}: under 8 warps/SM"
    return res


def wrong_chunk_pool(torch, vp, tbl, lens, ps, b):
    """V's pool with sequence b's last whole 32-key group read one token off
    (each of its rows takes the row before): one late chunk made wrong."""
    j0 = (int(lens[b]) // 32 - 1) * 32
    page, off = int(tbl[b, j0 // ps]), j0 % ps
    vw = vp.clone()
    vw[:, page, off:off + 32] = torch.roll(vp[:, page, off:off + 32], 1, 1)
    return vw


def phase_k4(torch, flush):
    from flash_attn_v100_tpu_torch.ops import kvcache as kv
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ggen = torch.Generator(device=dev).manual_seed(SEED)
    B, Hk, group, D, ps, max_pages = 8, 4, 8, 64, 128, 16
    lens = torch.randint(600, 2001, (B,), generator=gen)
    tbl, n_pages = paged_tables(torch, gen, lens, ps, max_pages, dev)
    kp, vp = make_pool(torch, ggen, dev, Hk, n_pages, ps, D, torch.bfloat16)
    kview, vview = kp[None], vp[None]
    causal0 = masklib.MaskParams(window_right=0)
    prefill = masklib.MaskParams(causal=True, window_right=0)

    cases = {
        # the engine's decode step: T_new = 1, causal -> window_right 0
        "decode": dict(t_new=1, params=causal0, num_splits=0, lens=lens),
        "decode_splits1": dict(t_new=1, params=causal0, num_splits=1,
                               lens=lens),
        "tnew4_window_softcap_alibi": dict(
            t_new=4, params=masklib.MaskParams(
                causal=True, window_left=256, window_right=0, softcap=30.0,
                has_alibi=True), num_splits=0, lens=lens),
        # the engine's short-prompt prefill: 2 rows bucketed to T = 64 from
        # cache length 0 (Rq = 512, causal among the new tokens) ...
        "prefill_tnew64": dict(t_new=64, params=prefill, num_splits=0,
                               lens=torch.tensor([64, 64])),
        # ... and the same behind cached prefixes of 0 and 300 tokens
        "prefill_tnew64_prefix": dict(t_new=64, params=prefill, num_splits=0,
                                      lens=torch.tensor([64, 364])),
    }
    res = {}
    for name, c in cases.items():
        t_new, params = c["t_new"], c["params"]
        n_b = len(c["lens"])
        lens_d = c["lens"].to(dev, torch.int32)
        tbl_c = tbl if c["lens"] is lens else paged_tables(
            torch, gen, c["lens"], ps, max_pages, dev)[0]
        Rq = max(-(-group * t_new // 8) * 8, 8)
        q = torch.randn((n_b, Hk, Rq, D), generator=ggen, device=dev).to(
            torch.bfloat16)
        q[:, :, group * t_new:] = 0
        slopes = None
        if params.has_alibi:
            slopes = torch.rand((n_b, Hk, Rq, 1), generator=ggen,
                                device=dev) * 0.1
        kw = dict(qpos_vec=lens_d - t_new, softmax_scale=D ** -0.5,
                  params=params, t_new=t_new, group=group,
                  num_splits=c["num_splits"], alibi_slopes_rows=slopes)
        lp = torch.zeros(n_b, dtype=torch.int32, device=dev)
        args = (q, kview, vview, tbl_c, lens_d, lp)
        o, lse = dec.merge_partials(*dec.paged_decode_attention(*args, **kw))
        om, lsem = dec.paged_decode_attention_merged(*args, **kw)
        torch.cuda.synchronize()
        o32, lse32 = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, **kw))
        onat, lsenat = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, upcast=False, **kw))
        err, gate = gated(torch, o, o32, onat, f"K4 {name} out")
        ratio = gated_rows(torch, o, o32, onat, f"K4 {name} out", 2.0)[0]
        fin = torch.isfinite(lse32)
        assert torch.equal(fin, torch.isfinite(lse)), f"K4 {name}: lse -inf rows"
        lse_err, lse_gate = gated(torch, lse[fin], lse32[fin], lsenat[fin],
                                  f"K4 {name} lse")
        m_ratio, m_lse = check_merged(torch, om, lsem, o, lse,
                                      f"K4 {name} merged")
        res[name] = dict(max_abs_err=err, gate=gate, row_ratio=ratio)
        line = ""
        if name == "decode":
            # the last sequence's last whole 32-key group with V read one
            # token off
            vw = wrong_chunk_pool(torch, vp, tbl, lens, ps, B - 1)
            o_w = dec.merge_partials(*dec.paged_decode_attention(
                q, kview, vw[None], *args[3:], **kw))[0]
            wrong = o.clone()
            wrong[B - 1] = o_w[B - 1]
            w_ratio = gated_rows(torch, wrong, o32, onat, "K4 wrong", 2.0,
                                 check=False)[0]
            assert w_ratio > 1.0, "the per-row gate passed a wrong K4"
            res[name]["wrong_ratio"] = w_ratio
            del vw, o_w, wrong
            line = (f"; a late 32-key chunk with V read one token off: row "
                    f"err/gate {w_ratio:.2f}")
        print(f"K4 {name} (B={n_b}, T_new={t_new}, Rq={Rq}, lens="
              f"{c['lens'].tolist() if n_b <= 2 else 'as decode'}): out "
              f"max_abs_err {err:.3e} <= gate {gate:.3e}, worst row err/gate "
              f"{ratio:.3f}, lse {lse_err:.3e} <= {lse_gate:.3e} (gate: 2 x "
              f"bf16 plain err vs fp32 plain + 1e-5, and per row (gated_rows, "
              f"mult 2)); merged in the launch vs merge_partials: worst row "
              f"err / 2^-8 row RMS {m_ratio:.3f}, lse {m_lse:.1e}{line}",
              flush=True)
    occ = k4_occupancy(build)

    # timings at the engine decode shape, through the route's merged entry
    c = cases["decode"]
    Rq = 8
    lens_d = lens.to(dev, torch.int32)
    lp = torch.zeros(B, dtype=torch.int32, device=dev)
    q = torch.randn((B, Hk, Rq, D), generator=ggen, device=dev).to(
        torch.bfloat16)
    kw = dict(qpos_vec=lens_d - 1, softmax_scale=D ** -0.5,
              params=c["params"], t_new=1, group=group, num_splits=0)
    args = (q, kview, vview, tbl, lens_d, lp)

    def call():
        return dec.paged_decode_attention_merged(*args, **kw)
    kernel_ms = time_ms(torch, call, flush=flush)
    graph = graph_ms(torch, call, flush=flush)
    plain_ms = time_ms(torch, lambda: dec.merge_partials(
        *dec.paged_decode_attention_ref(*args, **kw)), reps=5, flush=flush)
    # library yardstick: SDPA over the K/V already gathered to contiguous
    kc, vc = gather_kv(torch, kp, vp, tbl, lens, ps)
    library_ms = time_ms(torch, decode_sdpa(torch, q, kc, vc, lens_d, group),
                         flush=flush)
    S = dec.resolve_num_splits(0, B, Hk, Rq, max_pages, dev)
    live = int(lens.sum())
    # inputs once, the merged output (bf16) and its LSE once
    nbytes = (q.numel() * 2 + 2 * live * Hk * D * 2 + tbl.numel() * 4 + B * 12
              + B * Hk * Rq * (2 * D + 4))
    flops = 4 * live * Hk * group * D
    bms, by = bound_ms(nbytes, flops)
    print(f"K4 decode B={B} Hk={Hk} group={group} D={D} ps={ps} "
          f"lens={lens.tolist()} splits={S}: kernel {kernel_ms:.4f} ms a "
          f"call, {graph:.4f} ms device (graph replay), plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bms:.5f} ms "
          f"({by})", flush=True)
    del kc, vc
    # (L) the 32k-context decode, bf16, once, through the public call
    lq, lk, lv, lkw, lbytes = long_decode_case(torch, ggen)

    def long_call():
        return kv.flash_attn_with_kvcache(lq, lk, lv, **lkw)
    long_res = dict(ms=time_ms(torch, long_call, flush=flush),
                    graph_ms=graph_ms(torch, long_call, flush=flush),
                    bound_ms=lbytes / HBM_BYTES_PER_S * 1e3)
    print(f"K4 32k-context decode (B {LONG_B}, {LONG_HQ}/{LONG_HK} heads x "
          f"{LONG_D}, page 512, bf16, flash_attn_with_kvcache): "
          f"{long_res['ms']:.4f} ms a call, {long_res['graph_ms']:.4f} ms "
          f"device, bound {long_res['bound_ms']:.4f} ms (bytes): "
          f"{long_res['bound_ms'] / long_res['graph_ms']:.1%} of 3.35 TB/s",
          flush=True)
    del lq, lk, lv, lkw
    worst = max(res.values(), key=lambda r: r["max_abs_err"])
    return dict(max_abs_err=worst["max_abs_err"], gate=worst["gate"],
                ms=kernel_ms, graph_ms=graph, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bms, bound_by=by,
                row_ratio=max(r["row_ratio"] for r in res.values()),
                wrong_ratio=res["decode"]["wrong_ratio"],
                occupancy=occ[("K4", D, 16)],
                quant_occupancy={kind: occ[(f"K4q {kind}", D, 16)]
                                 for kind in QUANT_KINDS},
                long_context=long_res)


# ---------------------------------------------------------------- K8 phase

def k8_case(torch, dtype=None, Hq=32, Hk=4, D=64, T=512,
            prefix=(0, 300, 0, 300)):
    """The engine's prefill wave as K8 sees it: 4 sequences of 512 new
    tokens behind cached prefixes 0/300/0/300, 32/4 heads x 64 (or Hq / Hk
    x D, `T` new tokens behind each of `prefix`), page 128, bf16 (or
    `dtype`), from fixed seeds.  Returns (sizes
    (B, T, Hq, Hk, D, ps), prefix, seqlens, q, kp, vp, the call's arguments
    after the pools, the CUDA generator for more inputs)."""
    from flash_attn_v100_tpu_torch.ops import masks as masklib

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    ggen = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, ps = len(prefix), 128
    prefix = torch.tensor(prefix)
    seqlens = prefix + T
    max_k = int(seqlens.max())
    tbl, n_pages = paged_tables(torch, gen, seqlens, ps, -(-max_k // ps),
                                dev)
    dtype = dtype or torch.bfloat16
    kp, vp = make_pool(torch, ggen, dev, Hk, n_pages, ps, D, dtype)
    q = torch.randn((B * T, Hq, D), generator=ggen, device=dev).to(dtype)
    cu_q = torch.arange(B + 1, dtype=torch.int32, device=dev) * T
    params = masklib.MaskParams(causal=True, window_right=0)
    tail = (tbl, cu_q, seqlens.to(dev, torch.int32), T, max_k, D ** -0.5,
            params)
    return (B, T, Hq, Hk, D, ps), prefix, seqlens, q, kp, vp, tail, ggen


def phase_k8(torch, flush):
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl

    (B, T, Hq, Hk, D, ps), prefix, seqlens, q, kp, vp, tail, _ = k8_case(
        torch)
    tbl = tail[0]
    args = (q, kp, vp) + tail
    out, lse = vl.flash_attn_varlen_fwd_paged(*args)
    torch.cuda.synchronize()
    o32, lse32 = vl.flash_attn_varlen_fwd_paged_ref(*args)
    onat, lsenat = vl.flash_attn_varlen_fwd_paged_ref(*args, upcast=False)
    err, gate = gated(torch, out, o32, onat, "K8 out")
    lse_err, lse_gate = gated(torch, lse, lse32, lsenat, "K8 lse")
    ratio = gated_rows(torch, out, o32, onat, "K8 out", 2.0)[0]
    # the last sequence's last 64-row q tile from a call with V's pages
    # read one token off
    o_w = vl.flash_attn_varlen_fwd_paged(
        q, kp, torch.roll(vp, 1, dims=2), *args[3:])[0]
    w_ratio = gated_rows(torch, spliced0(out, o_w, B * T - 64), o32, onat,
                         "K8 wrong", 2.0, check=False)[0]
    assert w_ratio > 1.0, "the per-row gate passed a wrong K8"
    del o_w
    print(f"K8 prefill: out max_abs_err {err:.3e} <= gate {gate:.3e}, worst "
          f"row err/gate {ratio:.3f}, lse {lse_err:.3e} <= {lse_gate:.3e} "
          f"(gate: 2 x bf16 plain err vs fp32 plain + 1e-5, and per row "
          f"(gated_rows, mult 2)); a late tile with V read one token off: "
          f"row err/gate {w_ratio:.2f}")
    from flash_attn_v100_tpu_torch.ops.cuda import build
    names = ("K8",) + tuple(f"K8q {kind}" for kind in QUANT_KINDS)
    occ_res = {name: {} for name in names}
    print_occupancy(occ_res, occupancy(build, names), D)

    kernel_ms = time_ms(torch, lambda: vl.flash_attn_varlen_fwd_paged(*args),
                        flush=flush)
    plain_ms = time_ms(torch, lambda: vl.flash_attn_varlen_fwd_paged_ref(
        *args), reps=5, flush=flush)
    kc, vc = gather_kv(torch, kp, vp, tbl, seqlens, ps)
    library_ms = time_ms(torch, prefill_sdpa(torch, q, kc, vc, prefix, T),
                         flush=flush)
    live_pairs = sum(T * int(p) + T * (T + 1) // 2 for p in prefix)
    flops = 4 * live_pairs * Hq * D
    nbytes = (2 * q.numel() * 2 + Hq * B * T * 4
              + 2 * int(seqlens.sum()) * Hk * D * 2 + tbl.numel() * 4)
    bms, by = bound_ms(nbytes, flops)
    print(f"K8 prefill B={B} T={T} prefixes={prefix.tolist()} Hq={Hq} "
          f"Hk={Hk} D={D} ps={ps}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bms:.5f} ms "
          f"({by})")
    return dict(max_abs_err=err, gate=gate, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bms, bound_by=by,
                row_ratio=ratio, wrong_ratio=w_ratio,
                occupancy=occ_res["K8"]["occupancy"],
                quant_occupancy={kind: occ_res[f"K8q {kind}"]["occupancy"]
                                 for kind in QUANT_KINDS})


# ------------------------------------------- K4q, K8q (quantized pools)

QUANT_KINDS = ("int8", "fp8", "int4")
# decode variants (name, D) left out of k4_occupancy's checks, as
# tests/test_torch_gpu.py leaves them out: K4q int8 / int4 keep local
# memory at D 256; K4 fp32's 16-row block at D 256 holds one block an SM
DECODE_SPILLS = {("K4q int8", 256), ("K4q int4", 256)}
DECODE_ONE_BLOCK = {("K4 fp32", 256)}
# the fp32 oracle over the dequantized pool: the JAX package's gates
# (tests/test_quant.py: 0.1 for int8 / fp8, int4's resolution bound 0.3)
QUANT_ORACLE_GATE = {"int8": 0.1, "fp8": 0.1, "int4": 0.3}
# kernel vs plain twin LSE: the same fp32 scores summed in another order
# with other exp ulps (P's rounding does not reach the LSE)
QUANT_LSE_ATOL = 1e-4
QUANT_GATE = ("out vs the plain twin at the kernel's P grouping: max abs <= "
              "2 x the error P's rounding makes (twin with P unrounded) + "
              "1e-5, and per row (gated_rows, mult 2); LSE within 1e-4; vs "
              "the fp32 oracle over the dequantized pool within 0.1 "
              "(int8, fp8) / 0.3 (int4)")
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core peak
# the 16-bit and quantized kernels timed in turns: repeats x launches each
SPREAD_REPEATS, SPREAD_REPS = 5, 100


def quant_dtype(torch, kind):
    return {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
            "int4": "int4"}[kind]


def quant_pools(torch, kp, vp, kind):
    """bf16 HND pools -> the quantized (k, v, k_scales, v_scales) and the
    dequantized pools in fp32 (the oracle's K/V) and bf16 (SDPA's)."""
    from flash_attn_v100_tpu_torch.ops import quant
    pools, deq = [], []
    for x in (kp, vp):
        p, s = quant.quantize_kv(x, quant_dtype(torch, kind))
        pools.append((p, s))
        deq.append(quant.dequantize_kv(p, s, torch.float32,
                                       int4=kind == "int4"))
    (kq, ks), (vq, vs) = pools
    return (kq, vq, ks, vs), deq


def quant_ops_per_s(kind):
    # fp8's products stay 16-bit (K converted to q's type, P to bf16)
    return BF16_FLOPS_PER_S if kind == "fp8" else INT8_OPS_PER_S


def gate_quant(torch, name, kind, out, lse, twin, twin_unrounded, lse_twin,
               oracle, wrong):
    """`out` (and `lse`) of K4q/K8q against QUANT_GATE; `wrong` is the same
    output made wrong on one late tile, which the per-row gate must
    reject."""
    from flash_attn_v100_tpu_torch.utils import testing as tt
    err, gate = gated(torch, out, twin, twin_unrounded, f"{name} out")
    ratio = gated_rows(torch, out, twin, twin_unrounded, f"{name} out", 2.0)[0]
    fin = torch.isfinite(lse_twin)
    assert torch.equal(fin, torch.isfinite(lse)), f"{name}: -inf rows differ"
    lse_err = tt.max_abs_err(lse[fin], lse_twin[fin])
    assert lse_err <= QUANT_LSE_ATOL, f"{name} lse err {lse_err:.3e}"
    o_err = tt.max_abs_err(out, oracle)
    assert o_err <= QUANT_ORACLE_GATE[kind], (
        f"{name}: err vs the fp32 oracle {o_err:.3e} > "
        f"{QUANT_ORACLE_GATE[kind]}")
    w_ratio = gated_rows(torch, wrong, twin, twin_unrounded, f"{name} wrong",
                         2.0, check=False)[0]
    assert w_ratio > 1.0, f"the per-row gate passed a wrong {name}"
    print(f"{name}: out max_abs_err {err:.3e} <= gate {gate:.3e}, worst row "
          f"err/gate {ratio:.3f}, lse {lse_err:.3e} <= {QUANT_LSE_ATOL}, vs "
          f"fp32 oracle {o_err:.3e} <= {QUANT_ORACLE_GATE[kind]}; a late "
          f"tile with V's scales shifted by one token: row err/gate "
          f"{w_ratio:.2f}", flush=True)
    return dict(max_abs_err=err, gate=gate, row_ratio=ratio, lse_err=lse_err,
                oracle_err=o_err, wrong_ratio=w_ratio)


def quant_k4(torch, flush):
    """K4q at phase_k4's engine decode case (the same lens, table, pool and
    q rows: same seeds), once per payload kind, beside the 16-bit K4.
    Returns ({kind: result}, {name: timed call})."""
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ggen = torch.Generator(device=dev).manual_seed(SEED)
    B, Hk, group, D, ps, max_pages = 8, 4, 8, 64, 128, 16
    lens = torch.randint(600, 2001, (B,), generator=gen)
    tbl, n_pages = paged_tables(torch, gen, lens, ps, max_pages, dev)
    kp, vp = make_pool(torch, ggen, dev, Hk, n_pages, ps, D, torch.bfloat16)
    Rq = 8
    q = torch.randn((B, Hk, Rq, D), generator=ggen, device=dev).to(
        torch.bfloat16)
    lens_d = lens.to(dev, torch.int32)
    lp = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(qpos_vec=lens_d - 1, softmax_scale=D ** -0.5,
              params=masklib.MaskParams(window_right=0), t_new=1,
              group=group, num_splits=0)
    S = dec.resolve_num_splits(0, B, Hk, Rq, max_pages, dev)
    live = int(lens.sum())
    # timed: the route's merged entry (one launch)
    timed = {"K4 (bf16)": lambda: dec.paged_decode_attention_merged(
        q, kp[None], vp[None], tbl, lens_d, lp, **kw)}
    res = {}
    for kind in QUANT_KINDS:
        (kq, vq, ks, vs), (kd, vd) = quant_pools(torch, kp, vp, kind)
        args = (q, kq[None], vq[None], tbl, lens_d, lp)
        qkw = dict(kw, k_scales=ks[None], v_scales=vs[None],
                   int4=kind == "int4")

        def run(qkw=qkw, args=args):
            return dec.paged_decode_attention_merged(*args, **qkw)
        o, lse = dec.merge_partials(*dec.paged_decode_attention(*args, **qkw))
        om, lsem = run()
        torch.cuda.synchronize()
        m_ratio, m_lse = check_merged(torch, om, lsem, o, lse,
                                      f"K4q {kind} merged")
        print(f"K4q {kind} decode merged in the launch vs merge_partials: "
              f"worst row err / 2^-8 row RMS {m_ratio:.3f}, lse {m_lse:.1e}",
              flush=True)
        twin, lse_twin = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, **qkw))
        unr = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, round_p=False, **qkw))[0]
        oracle = dec.merge_partials(*dec.paged_decode_attention_ref(
            q, kd[None], vd[None], tbl, lens_d, lp, **kw))[0]
        # the last batch row's last whole 32-key group ("one late tile")
        # with V's scales read one token off
        vsw = wrong_chunk_pool(torch, vs, tbl, lens, ps, B - 1)
        o_w = dec.merge_partials(*dec.paged_decode_attention(
            *args, **dict(qkw, v_scales=vsw[None])))[0]
        wrong = o.clone()
        wrong[B - 1] = o_w[B - 1]
        r = gate_quant(torch, f"K4q {kind} decode", kind, o, lse, twin, unr,
                       lse_twin, oracle, wrong)
        del twin, unr, oracle, o_w, wrong
        r["plain_ms"] = time_ms(torch, lambda: dec.paged_decode_attention_ref(
            *args, **qkw), reps=5, flush=flush)
        kc, vc = gather_kv(torch, kd.to(torch.bfloat16),
                           vd.to(torch.bfloat16), tbl, lens, ps)
        r["library_ms"] = time_ms(
            torch, decode_sdpa(torch, q, kc, vc, lens_d, group), flush=flush)
        del kc, vc
        row_bytes = D // 2 if kind == "int4" else D
        nbytes = (q.numel() * 2 + 2 * live * Hk * (row_bytes + 4)
                  + tbl.numel() * 4 + B * 12 + B * Hk * Rq * (2 * D + 4))
        r["bound_ms"], r["bound_by"] = bound_ms(
            nbytes, 4 * live * Hk * group * D, quant_ops_per_s(kind))
        res[kind] = r
        timed[f"K4q {kind}"] = run
    print(f"K4q decode B={B} Hk={Hk} group={group} D={D} ps={ps} "
          f"lens={lens.tolist()} splits={S} ({QUANT_GATE})", flush=True)
    return res, timed


def quant_k8(torch, flush):
    """K8q at phase_k8's shape (the same tables, pool and q: same seeds),
    once per payload kind, beside the 16-bit K8.  Returns ({kind: result},
    {name: timed call})."""
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl

    (B, T, Hq, Hk, D, ps), prefix, seqlens, q, kp, vp, tail, _ = k8_case(
        torch)
    tbl = tail[0]
    timed = {"K8 (bf16)": lambda: vl.flash_attn_varlen_fwd_paged(
        q, kp, vp, *tail)}
    live_pairs = sum(T * int(p) + T * (T + 1) // 2 for p in prefix)
    res = {}
    for kind in QUANT_KINDS:
        (kq, vq, ks, vs), (kd, vd) = quant_pools(torch, kp, vp, kind)
        args = (q, kq, vq, *tail)
        skw = dict(k_scales=ks, v_scales=vs)

        def run(args=args, skw=skw):
            return vl.flash_attn_varlen_fwd_paged(*args, **skw)
        out, lse = run()
        torch.cuda.synchronize()
        twin, lse_twin = vl.flash_attn_varlen_fwd_paged_ref(*args, **skw)
        unr = vl.flash_attn_varlen_fwd_paged_ref(*args, round_p=False,
                                                 **skw)[0]
        oracle = vl.flash_attn_varlen_fwd_paged_ref(q, kd, vd, *tail)[0]
        # the last sequence's last 64-row q tile with V's scales read one
        # token off
        o_w = vl.flash_attn_varlen_fwd_paged(
            *args, k_scales=ks, v_scales=torch.roll(vs, 1, dims=2))[0]
        wrong = spliced0(out, o_w, B * T - 64)
        r = gate_quant(torch, f"K8q {kind} prefill", kind, out, lse, twin,
                       unr, lse_twin, oracle, wrong)
        del twin, unr, oracle, o_w, wrong
        r["plain_ms"] = time_ms(
            torch, lambda: vl.flash_attn_varlen_fwd_paged_ref(*args, **skw),
            reps=5, flush=flush)
        kc, vc = gather_kv(torch, kd.to(torch.bfloat16),
                           vd.to(torch.bfloat16), tbl, seqlens, ps)
        r["library_ms"] = time_ms(
            torch, prefill_sdpa(torch, q, kc, vc, prefix, T), flush=flush)
        del kc, vc
        row_bytes = D // 2 if kind == "int4" else D
        nbytes = (2 * q.numel() * 2 + Hq * B * T * 4
                  + 2 * int(seqlens.sum()) * Hk * (row_bytes + 4)
                  + tbl.numel() * 4)
        r["bound_ms"], r["bound_by"] = bound_ms(
            nbytes, 4 * live_pairs * Hq * D, quant_ops_per_s(kind))
        res[kind] = r
        timed[f"K8q {kind}"] = run
    print(f"K8q prefill B={B} T={T} prefixes={prefix.tolist()} Hq={Hq} "
          f"Hk={Hk} D={D} ps={ps} ({QUANT_GATE})", flush=True)
    return res, timed


def phase_quant(torch, flush):
    """K4q and K8q for each payload kind against their plain twins and the
    oracle, then every variant and the 16-bit K4 / K8 at the same inputs
    timed in turns (SPREAD_REPEATS x SPREAD_REPS launches each).  Returns
    {"K4q": {kind: result}, "K8q": {kind: result}, "spread": {name: [ms of
    each repeat]}}; a result's `ms` is the median of its repeats."""
    k4q, timed = quant_k4(torch, flush)
    k8q, timed8 = quant_k8(torch, flush)
    timed.update(timed8)
    spread = {name: [] for name in timed}
    # also as CUDA-graph replays: the kernels' device time without the
    # wrapper's host time, which these short kernels wait on
    graph = {name: [] for name in timed}
    for _ in range(SPREAD_REPEATS):
        for name, fn in timed.items():
            spread[name].append(time_ms(torch, fn, reps=SPREAD_REPS,
                                        flush=flush))
            if name in graph:
                graph[name].append(graph_ms(torch, fn, reps=SPREAD_REPS,
                                            flush=flush))
    for name, times in spread.items():
        med = statistics.median(times)
        line = (f"{name}: {med:.4f} ms (median of {SPREAD_REPEATS} repeats "
                f"of {SPREAD_REPS} launches; repeats {min(times):.4f}-"
                f"{max(times):.4f})")
        if name in graph:
            line += (f", device (graph replay) "
                     f"{statistics.median(graph[name]):.4f} ms")
        kid, kind = name.split()
        if kid in ("K4q", "K8q"):
            r = (k4q if kid == "K4q" else k8q)[kind]
            r["ms"], r["ms_repeats"] = med, times
            if name in graph:
                r["graph_ms"] = statistics.median(graph[name])
            line += (f", plain {r['plain_ms']:.4f} ms, SDPA over the "
                     f"dequantized pre-gathered KV {r['library_ms']:.4f} ms, "
                     f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
        print(line, flush=True)
    return {"K4q": k4q, "K8q": k8q, "spread": spread,
            "graph": {n: statistics.median(t) for n, t in graph.items()}}

# the training shape: TinyLlama-1.1B attention at B 4 x S 2048
DENSE_B, DENSE_S, DENSE_HQ, DENSE_HK, DENSE_D = 4, 2048, 32, 4, 64
DENSE_DROPOUT = 0.1
# the dropout seed of the gate check's wrong tiles
SENS_SEED = (0x2468ACE0, 0x7FFFFFFF)


def spliced(x, y, lo, n=64):
    """x with sequence positions [lo, lo + n) (dim 1) taken from y."""
    z = x.clone()
    z[:, lo:lo + n] = y[:, lo:lo + n]
    return z


def dense_work(B, S, Hq, Hk, D, esize=2, causal=True):
    """(flops, bytes) of K1, K2 and K3 for a causal (or full) B x S x Hq x
    D call: 4, 6 and 8 flops x D per live (q row, key) pair (2, 3 and 4
    products), each input read once and each output written once (`esize`
    bytes an element)."""
    pairs = B * Hq * S * (S + 1) // 2 if causal else B * Hq * S * S
    q_bytes, kv_bytes, row_bytes = B * S * Hq * D * esize, \
        B * S * Hk * D * esize, B * Hq * S * 4
    return {
        "K1": (4 * D * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        "K2": (6 * D * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        "K3": (8 * D * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
    }


def occupancy(build, names=("K1", "K2", "K3"), dims=(64, 128)) -> dict:
    """K1, K2 and K3 (or K6 and K7, the varlen instantiation of K2/K3; or
    K8 and "K8q <kind>", the paged kernels) in bf16 at the head dims
    `dims`, in the variant without bias or dropout (extra 0, the training
    path's) and with (extra 1): registers, local memory (spills and stack),
    dynamic shared memory, threads and resident blocks a multiprocessor,
    from the libraries' `fa_fwd_occupancy`, `fa_bwd_occupancy`,
    `fa_varlen_bwd_occupancy`, `fa_varlen_paged_occupancy` and
    `fa_varlen_paged_quant_occupancy` (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import ctypes
    from flash_attn_v100_tpu_torch.ops.cuda.decode import KIND_CODE

    def query(name, D, extra, at):
        dkv = int(name in ("K3", "K7"))
        if name == "K1":
            return build.load("fwd").fa_fwd_occupancy(0, D, extra, at)
        if name in ("K2", "K3"):
            return build.load("bwd").fa_bwd_occupancy(dkv, 0, D, extra, at)
        if name in ("K6", "K7"):
            return build.load("bwd").fa_varlen_bwd_occupancy(dkv, 0, D,
                                                             extra, at)
        if name == "K8":
            return build.load("varlen_paged").fa_varlen_paged_occupancy(
                0, D, extra, at)
        return build.load("varlen_paged_quant") \
            .fa_varlen_paged_quant_occupancy(KIND_CODE[name.split()[1]], 0,
                                             D, extra, at)

    res = {}
    for name in names:
        for D in dims:
            for extra in (0, 1):
                out = (ctypes.c_int * 5)()
                rc = query(name, D, extra, ctypes.addressof(out))
                build.check(rc, f"{name} occupancy")
                blocks, smem, threads, regs, local = out
                res[(name, D, extra)] = dict(
                    registers=regs, local_bytes=local, smem_bytes=smem,
                    threads=threads, blocks_per_sm=blocks,
                    warps_per_sm=blocks * threads // 32)
    return res


def read_dropout_mask(torch, dfwd, B, S, Hq, Hk, seed, p):
    """K1's dropout keep mask (B, Hq, S, S), read back 64 keys at a time:
    with q = 0 every score is 0, so with v = I (64 keys = head_dim 64) and
    the keys shifted by pos_base, out[b, i, h, j] = keep / (64 (1 - p))."""
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    dev = torch.device("cuda")
    n = 64
    q = torch.zeros((B, S, Hq, n), device=dev, dtype=torch.bfloat16)
    k = torch.zeros((B, n, Hk, n), device=dev, dtype=torch.bfloat16)
    eye = torch.eye(n, device=dev, dtype=torch.bfloat16)
    v = eye[None, :, None, :].expand(B, n, Hk, n).contiguous()
    keep = torch.empty((B, Hq, S, S), dtype=torch.bool, device=dev)
    for k0 in range(0, S, n):
        out, _ = dfwd.flash_attn_dense_fwd(
            q, k, v, 0.125, masklib.MaskParams(), dropout_p=p,
            dropout_seed=seed, pos_base=(0, k0, 0, 0))
        keep[..., k0:k0 + n] = out.permute(0, 2, 1, 3) > 0
    return keep


def gate_sensitivity(torch, tt, cases, phase="dense"):
    """Each (name, wrong, ref32, ref_native, mult, atol) is a kernel output
    made wrong on one late tile only: the per-row gate must reject it; the
    max-abs gate's verdict is printed beside."""
    seen = []
    for name, wrong, r32, r16, mult, atol in cases:
        ratio = gated_rows(torch, wrong, r32, r16, name, mult, check=False)[0]
        assert ratio > 1.0, f"the per-row gate passed a wrong {name}"
        err = tt.max_abs_err(wrong, r32)
        gate = mult * tt.max_abs_err(r16, r32) + atol
        seen.append(f"{name} row err/gate {ratio:.2f}, max abs {err:.3e} "
                    f"{'>' if err > gate else '<='} {gate:.3e}")
    print(f"{phase} gate check (one late tile keyed with another dropout "
          "seed; the per-row gate must reject each): " + "; ".join(seen),
          flush=True)


def phase_dense(torch, flush):
    """K1, K2 and K3 at the training shape against their plain versions;
    returns the per-kernel results of the `kernels` line."""
    import numpy as np
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
    from flash_attn_v100_tpu_torch.utils import testing as tt

    dev = torch.device("cuda")
    B, S, Hq, Hk, D = DENSE_B, DENSE_S, DENSE_HQ, DENSE_HK, DENSE_D
    ggen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def rnd(*shape):
        return torch.randn(shape, generator=ggen, device=dev).to(
            torch.bfloat16)

    q, k, v, do = rnd(B, S, Hq, D), rnd(B, S, Hk, D), rnd(B, S, Hk, D), \
        rnd(B, S, Hq, D)
    params = masklib.MaskParams(causal=True)
    scale = D ** -0.5
    seed = torch.tensor([0x13579BDF, 0x80000001], dtype=torch.int64)
    errs = {}
    for p in (0.0, DENSE_DROPOUT):
        kw = dict(dropout_p=p, dropout_seed=seed if p else None)
        tag = f"p={p}"
        out, lse = dfwd.flash_attn_dense_fwd(q, k, v, scale, params, **kw)
        dq, dk, dv = dbwd.flash_attn_dense_bwd(q, k, v, out, do, lse, scale,
                                               params, **kw)
        torch.cuda.synchronize()
        o32, l32 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params, **kw)
        o16, l16 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params,
                                                 upcast=False, **kw)
        rows = {}
        errs[("K1", p)] = gated(torch, out, o32, o16, f"K1 {tag} out")
        rows["K1 out"] = gated_rows(torch, out, o32, o16, f"K1 {tag} out",
                                    tt.FWD_MULT)
        lse_err = gated(torch, lse, l32, l16, f"K1 {tag} lse")
        if p:
            wrong_kw = dict(dropout_p=p, dropout_seed=SENS_SEED)
            o_wrong = dfwd.flash_attn_dense_fwd(q, k, v, scale, params,
                                                **wrong_kw)[0]
            wrong = [("K1 out", spliced(out, o_wrong, S - 64), o32, o16,
                      tt.FWD_MULT, tt.FWD_ATOL)]
            del o_wrong
        del o32, o16, l32, l16
        g32 = dbwd.flash_attn_dense_bwd_ref(q, k, v, out, do, lse, scale,
                                            params, **kw)
        g16 = dbwd.flash_attn_dense_bwd_ref(q, k, v, out, do, lse, scale,
                                            params, upcast=False, **kw)
        for name, key, g, r32, r16 in (("K2", "dq", dq, g32[0], g16[0]),
                                       ("K3", "dk", dk, g32[1], g16[1]),
                                       ("K3", "dv", dv, g32[2], g16[2])):
            errs[(name, p, key)] = gated(torch, g, r32, r16,
                                         f"{name} {tag} {key}",
                                         tt.BWD_MULT, tt.BWD_ATOL)
            rows[f"{name} {key}"] = gated_rows(
                torch, g, r32, r16, f"{name} {tag} {key}", tt.BWD_MULT)
        if p:
            g_wrong = dbwd.flash_attn_dense_bwd(q, k, v, out, do, lse, scale,
                                                params, **wrong_kw)
            for (key, lo), g, gw, r32, r16 in zip(
                    (("K2 dq", S - 64), ("K3 dk", S // 2),
                     ("K3 dv", S - 128)), (dq, dk, dv), g_wrong, g32, g16):
                wrong.append((key, spliced(g, gw, lo), r32, r16,
                              tt.BWD_MULT, tt.BWD_ATOL))
            gate_sensitivity(torch, tt, wrong)
            del wrong, g_wrong
        del g32, g16
        again = dbwd.flash_attn_dense_bwd(q, k, v, out, do, lse, scale,
                                          params, **kw)
        assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)), \
            "two backward calls differ"
        print(f"dense {tag} (B={B}, S={S}, Hq={Hq}, Hk={Hk}, D={D}, causal, "
              f"bf16): max abs err vs fp32 plain <= gate (2x / 3x the bf16 "
              f"plain error + 1e-5 / 1e-4): K1 out "
              f"{errs[('K1', p)][0]:.3e} <= {errs[('K1', p)][1]:.3e}, lse "
              f"{lse_err[0]:.3e} <= {lse_err[1]:.3e}; K2 dq "
              f"{errs[('K2', p, 'dq')][0]:.3e} <= "
              f"{errs[('K2', p, 'dq')][1]:.3e}; K3 dk "
              f"{errs[('K3', p, 'dk')][0]:.3e} <= "
              f"{errs[('K3', p, 'dk')][1]:.3e}, dv "
              f"{errs[('K3', p, 'dv')][0]:.3e} <= "
              f"{errs[('K3', p, 'dv')][1]:.3e}; two backward calls "
              f"bit-equal", flush=True)
        print(f"dense {tag}: per-row RMS err vs fp32 plain <= 2x / 3x the "
              f"bf16 plain row's + 2^-8 x row RMS + 1e-3 x tensor RMS "
              f"(worst err/gate; median |ref|, median row gate): " + ", ".join(
                  f"{key} {r:.3f} ({med:.3e}, {g:.3e})"
                  for key, (r, med, g) in rows.items()), flush=True)
        del out, lse, dq, dk, dv, again

    # the dropout mask: K1's, read back, against flash_attn_func's dmask
    _, _, dmask = flash_attn_func(q, k, v, dropout_p=DENSE_DROPOUT,
                                  causal=True, return_attn_probs=True,
                                  dropout_seed=seed)
    kernel_keep = read_dropout_mask(torch, dfwd, B, S, Hq, Hk, seed,
                                    DENSE_DROPOUT)
    assert torch.equal(kernel_keep, dmask > 0), "K1's dropout mask differs"
    rate = float(kernel_keep.float().mean())
    print(f"dense dropout: K1's keep mask over {kernel_keep.numel()} "
          f"positions bit-equal to flash_attn_func's dmask (keep rate "
          f"{rate:.5f}, 1 - p = {1 - DENSE_DROPOUT})", flush=True)
    del dmask, kernel_keep

    # times at the training shape, no dropout
    kw = dict(dropout_p=0.0, dropout_seed=None)
    out, lse = dfwd.flash_attn_dense_fwd(q, k, v, scale, params, **kw)
    delta = dbwd.softmax_delta(out, do)
    lse_c = lse.clamp_min(NEG_INF).contiguous()
    kargs = (q, k, v, do, lse_c, delta, None, scale, params, 0.0, None, 0,
             None, Hq)
    ms = {"K1": time_ms(torch, lambda: dfwd.flash_attn_dense_fwd(
              q, k, v, scale, params, **kw), flush=flush),
          "K2": time_ms(torch, lambda: dbwd.dq_kernel(*kargs), flush=flush),
          "K3": time_ms(torch, lambda: dbwd.dkv_kernel(*kargs), flush=flush)}
    plain_fwd = time_ms(torch, lambda: dfwd.flash_attn_dense_fwd_ref(
        q, k, v, scale, params, **kw), reps=3, warmup=1, flush=flush)
    plain_bwd = time_ms(torch, lambda: dbwd.flash_attn_dense_bwd_ref(
        q, k, v, out, do, lse, scale, params, **kw), reps=3, warmup=1,
        flush=flush)
    F = torch.nn.functional
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), flush=flush)
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
    do_s = do.transpose(1, 2).contiguous()
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qs, ks, vs), do_s, retain_graph=True), flush=flush)
    work = dense_work(B, S, Hq, Hk, D)
    res = {}
    for name, plain, lib in (("K1", plain_fwd, lib_fwd),
                             ("K2", plain_bwd, lib_bwd),
                             ("K3", plain_bwd, lib_bwd)):
        flops, nbytes = work[name]
        bms, by = bound_ms(nbytes, flops)
        worst = max((e for key, e in errs.items() if key[0] == name),
                    key=lambda e: e[0])
        res[name] = dict(max_abs_err=worst[0], gate=worst[1], ms=ms[name],
                         plain_ms=plain, library_ms=lib, bound_ms=bms,
                         bound_by=by)
        print(f"{name} B={B} S={S} Hq={Hq} Hk={Hk} D={D} causal: kernel "
              f"{ms[name]:.4f} ms, plain {plain:.4f} ms"
              f"{' (dq, dk, dv together)' if name != 'K1' else ''}, sdpa "
              f"{'fwd' if name == 'K1' else 'bwd (K2 + K3)'} {lib:.4f} ms, "
              f"bound {bms:.4f} ms ({by}, {flops:.3e} flop), "
              f"{flops / ms[name] / 1e9:.1f} TFLOP/s = "
              f"{100 * bms / ms[name]:.1f}% of the bound", flush=True)

    # K1 at the repo's headline prefill shape (head_dim 128), against the
    # plain version's gate and SDPA's time
    res["K1"]["bench_shape"] = k1_bench_shape(torch, flush)

    # K1-K3: what a block holds and how many fit on a multiprocessor
    from flash_attn_v100_tpu_torch.ops.cuda import build
    print_occupancy(res, occupancy(build), D)
    return res


def print_occupancy(res, occ, D):
    """Prints each kernel variant's occupancy and asserts no local memory
    and >= 8 resident warps a multiprocessor; the D, no-bias variant goes
    into the kernel's result."""
    for (name, d, extra), o in occ.items():
        print(f"{name} occupancy (bf16, D {d}, "
              f"{'bias/dropout' if extra else 'no bias/dropout'} variant): "
              f"{o['registers']} registers, local memory (spills, stack) "
              f"{o['local_bytes']} B, {o['smem_bytes']} B dynamic "
              f"shared memory and {o['threads']} threads a block, "
              f"{o['blocks_per_sm']} blocks = {o['warps_per_sm']} warps "
              f"resident a multiprocessor", flush=True)
        assert o["local_bytes"] == 0, f"{name} D {d} extra {extra} spills"
        assert o["warps_per_sm"] >= 8, \
            f"{name} D {d} extra {extra}: under 8 warps/SM"
        if d == D and not extra:
            res[name]["occupancy"] = o


# the repo's headline prefill shape (bench.py:71-78): B 4 x 4096, 32 / 8
# heads x 128, causal, bf16
BENCH_B, BENCH_S, BENCH_HQ, BENCH_HK, BENCH_D = 4, 4096, 32, 8, 128


def k1_bench_shape(torch, flush):
    """K1 at the headline prefill shape: out and LSE against the plain
    version's max-abs gate, then K1's and SDPA's forward times and the
    bound."""
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd

    dev = torch.device("cuda")
    B, S, Hq, Hk, D = BENCH_B, BENCH_S, BENCH_HQ, BENCH_HK, BENCH_D
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               for s in ((B, S, Hq, D), (B, S, Hk, D), (B, S, Hk, D)))
    params = masklib.MaskParams(causal=True)
    scale = D ** -0.5
    out, lse = dfwd.flash_attn_dense_fwd(q, k, v, scale, params)
    torch.cuda.synchronize()
    o32, l32 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params)
    o16, l16 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params,
                                             upcast=False)
    err, gate = gated(torch, out, o32, o16, "K1 D 128 out")
    lse_err, lse_gate = gated(torch, lse, l32, l16, "K1 D 128 lse")
    del o32, o16, l32, l16, out, lse
    ms = time_ms(torch, lambda: dfwd.flash_attn_dense_fwd(q, k, v, scale,
                                                          params), flush=flush)
    F = torch.nn.functional
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), flush=flush)
    flops, nbytes = dense_work(B, S, Hq, Hk, D)["K1"]
    bms, by = bound_ms(nbytes, flops)
    print(f"K1 B={B} S={S} Hq={Hq} Hk={Hk} D={D} causal (the headline "
          f"prefill shape): out err {err:.3e} <= {gate:.3e}, lse {lse_err:.3e}"
          f" <= {lse_gate:.3e}; kernel {ms:.4f} ms, sdpa fwd {lib:.4f} ms, "
          f"bound {bms:.4f} ms ({by}, {flops:.3e} flop), "
          f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return dict(shape=[B, S, Hq, Hk, D], max_abs_err=err, gate=gate, ms=ms,
                library_ms=lib, bound_ms=bms, bound_by=by)


# head dim 256: (a) sweep_dense's 1 x 32 x 8192^2 (benchmarks/
# sweep_dense.py:53), (b) Gemma-2B's attention at a training batch, B 4 x
# 2048, 8 q heads over 1 kv head (google/gemma-2b config.json): (B, S, Hq,
# Hk, D)
D256_SHAPES = {"a": (1, 8192, 32, 32, 256), "b": (4, 2048, 8, 1, 256)}


def plain_fwd16(torch, dfwd, q, k, v, scale, params, **kw):
    """The plain forward's out and LSE with both products in q's dtype
    (upcast=False), 4 kv heads (and their q heads) at a time: at 1 x 32 x
    8192^2 one call's fp32 scores would take 8.6 GB a tensor.  Dropout
    keys on the head, so a call with dropout takes all heads."""
    Hq, Hk = q.shape[2], k.shape[2]
    g = Hq // Hk
    step = Hk if kw.get("dropout_p") else 4
    outs, lses = [], []
    for h0 in range(0, Hk, step):
        h1 = min(Hk, h0 + step)
        o, l = dfwd.flash_attn_dense_fwd_ref(
            q[:, :, h0 * g:h1 * g], k[:, :, h0:h1], v[:, :, h0:h1], scale,
            params, upcast=False, **kw)
        outs.append(o)
        lses.append(l)
    return torch.cat(outs, 2), torch.cat(lses, 1)


def d256_rows(torch, flush, digests=None, cases=None) -> dict:
    """K1, K2 and K3 alone at head dim 256 (`D256_SHAPES`), bf16, causal
    and full (or only the rows named in `cases`, as "D 256 b causal"):
    each kernel's device time from CUDA-graph replays, SDPA's
    forward and backward (`enable_gqa`; CUDA events around one call) and
    the bound.  K2 and K3 take the plain forward's out and LSE in bf16, so
    their inputs are the same in every tree (without `digests`, K1's: the
    time is the same).  With a dict `digests`, adds a digest of each
    kernel's outputs to it (and, at (b), causal, of the dropout p 0.1
    calls: the bias / dropout variants)."""
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd

    dev = torch.device("cuda")
    F = torch.nn.functional
    seed = torch.tensor([0x2468ACE1, 0x10000001], dtype=torch.int64)
    rows = {}
    for tag, (B, S, Hq, Hk, D) in D256_SHAPES.items():
        masks = [c for c in (True, False) if cases is None or
                 f"D 256 {tag} {'causal' if c else 'full'}" in cases]
        if not masks:
            continue
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(
            torch.bfloat16) for s in ((B, S, Hq, D), (B, S, Hk, D),
                                      (B, S, Hk, D), (B, S, Hq, D)))
        scale = D ** -0.5
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        do_s = do.transpose(1, 2).contiguous()
        for causal in masks:
            name = f"D 256 {tag} {'causal' if causal else 'full'}"
            params = masklib.MaskParams(causal=causal)
            # digests need inputs that are the same in every tree; a time
            # does not, and K1's out and LSE are cheaper at (a)
            o16, l16 = (plain_fwd16(torch, dfwd, q, k, v, scale, params)
                        if digests is not None else
                        dfwd.flash_attn_dense_fwd(q, k, v, scale, params))
            kargs = (q, k, v, do, l16.clamp_min(NEG_INF).contiguous(),
                     dbwd.softmax_delta(o16, do), None, scale, params, 0.0,
                     None, 0, None, Hq)
            del o16, l16
            if digests is not None:
                digests[f"K1 {name}"] = digest(
                    torch, *dfwd.flash_attn_dense_fwd(q, k, v, scale, params))
                digests[f"K2 {name}"] = digest(torch, dbwd.dq_kernel(*kargs))
                digests[f"K3 {name}"] = digest(torch,
                                               *dbwd.dkv_kernel(*kargs))
            ms = {"K1": graph_ms(torch, lambda: dfwd.flash_attn_dense_fwd(
                      q, k, v, scale, params), flush=flush),
                  "K2": graph_ms(torch, lambda: dbwd.dq_kernel(*kargs),
                                 flush=flush),
                  "K3": graph_ms(torch, lambda: dbwd.dkv_kernel(*kargs),
                                 flush=flush)}
            del kargs
            lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=True), flush=flush)
            o_lib = F.scaled_dot_product_attention(qs, ks, vs,
                                                   is_causal=causal,
                                                   enable_gqa=True)
            lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qs, ks, vs), do_s, retain_graph=True), flush=flush)
            del o_lib
            work = dense_work(B, S, Hq, Hk, D, causal=causal)
            row = dict(shape=[B, S, Hq, Hk, D], causal=causal,
                       sdpa_fwd_ms=lib_fwd, sdpa_bwd_ms=lib_bwd)
            for kid in ("K1", "K2", "K3"):
                flops, nbytes = work[kid]
                bms, by = bound_ms(nbytes, flops)
                row[kid] = dict(ms=ms[kid], bound_ms=bms, bound_by=by,
                                tflops=flops / ms[kid] / 1e9)
            rows[name] = row
            print(f"{name} (B={B} S={S} Hq={Hq} Hk={Hk}, bf16, graph "
                  f"replays): " + ", ".join(
                      f"{kid} {row[kid]['ms']:.4f} ms (bound "
                      f"{row[kid]['bound_ms']:.4f}, "
                      f"{row[kid]['tflops']:.1f} TFLOP/s)"
                      for kid in ("K1", "K2", "K3")) +
                  f"; sdpa fwd {lib_fwd:.4f} ms, bwd {lib_bwd:.4f} ms "
                  f"(K2 + K3 {row['K2']['ms'] + row['K3']['ms']:.4f})",
                  flush=True)
        if digests is not None and tag == "b":
            params = masklib.MaskParams(causal=True)
            kw = dict(dropout_p=DENSE_DROPOUT, dropout_seed=seed)
            name = "D 256 b causal p=0.1"
            digests[f"K1 {name}"] = digest(torch, *dfwd.flash_attn_dense_fwd(
                q, k, v, scale, params, **kw))
            o16, l16 = plain_fwd16(torch, dfwd, q, k, v, scale, params, **kw)
            dq, dk, dv = dbwd.flash_attn_dense_bwd(q, k, v, o16, do, l16,
                                                   scale, params, **kw)
            digests[f"K2 {name}"] = digest(torch, dq)
            digests[f"K3 {name}"] = digest(torch, dk, dv)
            del o16, l16, dq, dk, dv
        del q, k, v, do, qs, ks, vs, do_s
        torch.cuda.empty_cache()
    return rows


# each kernel's library and product path by head dim: (id, library, on
# wgmma); every one runs wgmma at D 32 and 256
SASS_KERNELS = {
    256: (("K1", "fwd", True), ("K5", "fwd", True),
          ("K8", "varlen_paged", True), ("K8q", "varlen_paged_quant", True),
          ("K2", "bwd", True), ("K6", "bwd", True), ("K3", "bwd", True),
          ("K7", "bwd", True)),
    32: (("K1", "fwd", True), ("K5", "fwd", True),
         ("K8", "varlen_paged", True), ("K8q", "varlen_paged_quant", True),
         ("K3", "bwd", True), ("K7", "bwd", True), ("K2", "bwd", True),
         ("K6", "bwd", True)),
}


def kernel_sass(build) -> dict:
    """Starts `build.sass_counts` of each library of SASS_KERNELS, one
    thread (cuobjdump, cu++filt) a library, and returns {library: future}:
    host work that main() starts after the build, beside the card's
    phases."""
    from concurrent.futures import ThreadPoolExecutor

    libs = list(dict.fromkeys(lib for table in SASS_KERNELS.values()
                              for _, lib, _ in table))
    pool = ThreadPoolExecutor(len(libs))
    futures = {lib: pool.submit(build.sass_counts, lib) for lib in libs}
    pool.shutdown(wait=False)
    return futures


def sass_report(build, head_dim, sass=None) -> dict:
    """Each `head_dim` instantiation of SASS_KERNELS[head_dim] (both 16-bit
    types, both variants; K8q: its e4m3 pool on the forward body): its SASS
    HGMMA / HMMA / MUFU.EX2 counts (`build.sass_counts`, from `sass`,
    kernel_sass's futures, when given) and its ptxas registers and local
    bytes (`build.ptxas_usage`), keyed by its CUDA name.  Asserts HGMMA > 0
    and no HMMA (mma.sync) in each wgmma kernel, HMMA > 0 and no HGMMA in
    the others, and no local memory in any."""
    from flash_attn_v100_tpu_torch.utils import profiling as tprof

    table = SASS_KERNELS[head_dim]
    sass = sass or kernel_sass(build)
    paths = {(kid, lib): wg for kid, lib, wg in table}
    res = {}
    for lib in dict.fromkeys(lib for _, lib, _ in table):
        usage = build.ptxas_usage(lib)
        for name, c in sass[lib].result().items():
            kid = tprof.kernel_id(name)
            if (tprof.kernel_head_dim(name) != head_dim
                    or (kid, lib) not in paths
                    or (kid == "K8q" and "fwd_kernel" not in name)):
                continue
            u = usage[name]
            res[name] = dict(id=kid, hgmma=c["hgmma"], hmma=c["hmma"],
                             mufu_ex2=c["mufu_ex2"],
                             registers=u["registers"],
                             local_bytes=u["stack"] + u["spill_stores"])
            if paths[(kid, lib)]:
                assert c["hgmma"] > 0, f"{name}: no HGMMA in its SASS"
                assert c["hmma"] == 0, f"{name}: mma.sync (HMMA) in its SASS"
            else:
                assert c["hmma"] > 0 and c["hgmma"] == 0, f"{name}: {c}"
            assert res[name]["local_bytes"] == 0, f"{name}: local memory"
    for kid, _, _ in table:
        rows = [r for r in res.values() if r["id"] == kid]
        assert len(rows) == 4, f"{kid}: {len(rows)} D {head_dim} " \
            "instantiations"
        print(f"{kid} D {head_dim} SASS (bf16 / fp16 x no bias / bias "
              f"variants): HGMMA {[r['hgmma'] for r in rows]}, HMMA "
              f"{[r['hmma'] for r in rows]}, MUFU.EX2 "
              f"{[r['mufu_ex2'] for r in rows]}, registers "
              f"{[r['registers'] for r in rows]}, local bytes "
              f"{[r['local_bytes'] for r in rows]}", flush=True)
    return res


def d256_checks(torch, flush, sass=None) -> dict:
    """Head dim 256 at Gemma-2B's attention (D256_SHAPES (b): B 4 x 2048, 8
    q heads over 1 kv head, causal, bf16): K1, K2 and K3 against their
    plain versions at p 0 and 0.1, two backward calls bit-equal; K5, K6
    and K7 (through the varlen wrappers) on the same batch as equal-length
    sequences bit-equal to K1, K2 and K3 (one body each), and on
    `phase_varlen`'s ragged packed documents (`packed_doc_lengths`: lengths
    drawn from 37-2048 tokens) against their plain versions, each
    document's out, dq, dk and dv bit-equal to K1's, K2's and K3's on that
    document alone; K8 and K8q fp8 at the engine's prefill wave (k8_case,
    8/1 heads x 256) against theirs; the D 256 kernels' occupancy and
    `sass_report` (on `sass`, kernel_sass's futures, when given); then
    `d256_rows`' times at (b), causal.  Returns the K1, K2, K3 and K8 rows
    of the `kernels` line ((b), causal)."""
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    from flash_attn_v100_tpu_torch.utils import testing as tt

    dev = torch.device("cuda")
    B, S, Hq, Hk, D = D256_SHAPES["b"]
    ggen = torch.Generator(device=dev).manual_seed(SEED + 13)
    q, k, v, do = (torch.randn(sh, generator=ggen, device=dev).to(
        torch.bfloat16) for sh in ((B, S, Hq, D), (B, S, Hk, D),
                                   (B, S, Hk, D), (B, S, Hq, D)))
    params = masklib.MaskParams(causal=True)
    scale = D ** -0.5
    seed = torch.tensor([0x3C2D1E0F, 0x78695A4B], dtype=torch.int64)
    errs, rows = {}, {}
    laps = [time.perf_counter()]
    for p in (0.0, DENSE_DROPOUT):
        kw = dict(dropout_p=p, dropout_seed=seed if p else None)
        tag = f"D 256 p={p}"
        out, lse = dfwd.flash_attn_dense_fwd(q, k, v, scale, params, **kw)
        dq, dk, dv = dbwd.flash_attn_dense_bwd(q, k, v, out, do, lse, scale,
                                               params, **kw)
        torch.cuda.synchronize()
        o32, l32 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params, **kw)
        o16, l16 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params,
                                                 upcast=False, **kw)
        errs[("K1", p)] = gated(torch, out, o32, o16, f"K1 {tag} out")
        errs[("K1", p, "lse")] = gated(torch, lse, l32, l16, f"K1 {tag} lse")
        rows[f"K1 {tag} out"] = gated_rows(torch, out, o32, o16,
                                           f"K1 {tag} out", tt.FWD_MULT)[0]
        del o32, o16, l32, l16
        g32 = dbwd.flash_attn_dense_bwd_ref(q, k, v, out, do, lse, scale,
                                            params, **kw)
        g16 = dbwd.flash_attn_dense_bwd_ref(q, k, v, out, do, lse, scale,
                                            params, upcast=False, **kw)
        for name, key, g, r32, r16 in (("K2", "dq", dq, g32[0], g16[0]),
                                       ("K3", "dk", dk, g32[1], g16[1]),
                                       ("K3", "dv", dv, g32[2], g16[2])):
            errs[(name, p, key)] = gated(torch, g, r32, r16,
                                         f"{name} {tag} {key}", tt.BWD_MULT,
                                         tt.BWD_ATOL)
            rows[f"{name} {tag} {key}"] = gated_rows(
                torch, g, r32, r16, f"{name} {tag} {key}", tt.BWD_MULT)[0]
        del g32, g16
        again = dbwd.flash_attn_dense_bwd(q, k, v, out, do, lse, scale,
                                          params, **kw)
        assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)), \
            f"{tag}: two backward calls differ"
        del again
        if not p:
            # K5 / K6 / K7 on the batch as 4 equal-length sequences: K1's,
            # K2's and K3's bits
            cu = torch.arange(B + 1, dtype=torch.int32, device=dev) * S
            pk = [t.reshape(B * S, *t.shape[2:]) for t in (q, k, v, do)]
            o_v, lse_v = vl.flash_attn_varlen_fwd(pk[0], pk[1], pk[2], cu, cu,
                                                  S, S, scale, params)
            assert torch.equal(o_v, out.reshape(B * S, Hq, D)), "K5 != K1"
            assert torch.equal(lse_v, lse.permute(1, 0, 2).reshape(
                Hq, B * S)), "K5 lse != K1's"
            g_v = vl.flash_attn_varlen_bwd(pk[0], pk[1], pk[2], o_v, pk[3],
                                           lse_v, cu, cu, S, S, scale, params)
            for a, b, what in zip(g_v, (dq, dk, dv), ("dq", "dk", "dv")):
                assert torch.equal(a, b.reshape(a.shape)), \
                    f"equal lengths: varlen {what} != dense"
            del o_v, lse_v, g_v
        print(f"dense {tag} (B={B}, S={S}, Hq={Hq}, Hk={Hk}, D={D}, causal, "
              f"bf16): max abs err vs fp32 plain <= gate: " + ", ".join(
                  f"{' '.join(str(x) for x in key if x != p)} "
                  f"{e[0]:.3e} <= {e[1]:.3e}" for key, e in errs.items()
                  if key[1] == p) + "; per-row err/gate " + ", ".join(
                  f"{key.split(' ', 3)[0]} {key.split()[-1]} {r:.3f}"
                  for key, r in rows.items() if tag in key) +
              "; two backward calls bit-equal" +
              ("; K5 / K6 / K7 on 4 equal-length sequences bit-equal to K1 /"
               " K2 / K3" if not p else ""), flush=True)
        del out, lse, dq, dk, dv

    laps.append(time.perf_counter())
    # K5 / K7 on packed documents of 37-2048 tokens in the 4 rows
    docs = [n for d in packed_doc_lengths(B, S, SEED) for n in d]
    cu = torch.tensor([0] + docs, device=dev).cumsum(0).to(torch.int32)
    ms = max(docs)
    pk = [t.reshape(B * S, *t.shape[2:]) for t in (q, k, v, do)]
    o_v, lse_v = vl.flash_attn_varlen_fwd(pk[0], pk[1], pk[2], cu, cu, ms,
                                          ms, scale, params)
    g_v = vl.flash_attn_varlen_bwd(pk[0], pk[1], pk[2], o_v, pk[3], lse_v,
                                   cu, cu, ms, ms, scale, params)
    torch.cuda.synchronize()
    vargs = (pk[0], pk[1], pk[2], cu, cu, ms, ms, scale, params)
    o32 = vl.flash_attn_varlen_fwd_ref(*vargs)[0]
    o16 = vl.flash_attn_varlen_fwd_ref(*vargs, upcast=False)[0]
    e5 = gated(torch, o_v, o32, o16, "K5 D 256 out")
    bargs = (pk[0], pk[1], pk[2], o_v, pk[3], lse_v, cu, cu, ms, ms, scale,
             params)
    g32 = vl.flash_attn_varlen_bwd_ref(*bargs)
    g16 = vl.flash_attn_varlen_bwd_ref(*bargs, upcast=False)
    e67 = [gated(torch, g, r32, r16, f"{kid} D 256 {what}", tt.BWD_MULT,
                 tt.BWD_ATOL)
           for g, r32, r16, kid, what in zip(g_v, g32, g16,
                                             ("K6", "K7", "K7"),
                                             ("dq", "dk", "dv"))]
    # each document alone through K1, K2 and K3: K5's, K6's and K7's bits
    for i, (a, n) in enumerate(zip(cu[:-1].tolist(), docs)):
        one = [t[None, a:a + n] for t in pk]
        o1, l1 = dfwd.flash_attn_dense_fwd(one[0], one[1], one[2], scale,
                                           params)
        assert torch.equal(o1[0], o_v[a:a + n]), f"document {i}: K5 != K1"
        g1 = dbwd.flash_attn_dense_bwd(one[0], one[1], one[2], o1, one[3],
                                       l1, scale, params)
        for g, gv, what in zip(g1, g_v, ("dq", "dk", "dv")):
            assert torch.equal(g[0], gv[a:a + n]), \
                f"document {i} ({n} tokens): varlen {what} != dense alone"
        del one, o1, l1, g1
    print(f"varlen D 256 ({len(docs)} packed documents of {min(docs)}-"
          f"{max(docs)} tokens, {Hq}/{Hk} heads, causal, bf16): K5 out "
          f"{e5[0]:.3e} <= {e5[1]:.3e}; K6 dq {e67[0][0]:.3e} <= "
          f"{e67[0][1]:.3e}; K7 dk {e67[1][0]:.3e} <= {e67[1][1]:.3e}, dv "
          f"{e67[2][0]:.3e} <= {e67[2][1]:.3e}; each document's out, dq, dk, "
          f"dv bit-equal to K1, K2, K3 on it alone", flush=True)
    del o_v, lse_v, g_v, o32, o16, g32, g16, pk

    laps.append(time.perf_counter())
    # K8 and K8q fp8 at the engine's prefill wave, 8/1 heads x 256
    (Bp, T, _, _, _, ps), prefix, seqlens, qp, kp, vp, tail, _ = k8_case(
        torch, Hq=Hq, Hk=Hk, D=D)
    args = (qp, kp, vp) + tail
    out8, lse8 = vl.flash_attn_varlen_fwd_paged(*args)
    torch.cuda.synchronize()
    o32, l32 = vl.flash_attn_varlen_fwd_paged_ref(*args)
    o16, l16 = vl.flash_attn_varlen_fwd_paged_ref(*args, upcast=False)
    e8 = gated(torch, out8, o32, o16, "K8 D 256 out")
    e8l = gated(torch, lse8, l32, l16, "K8 D 256 lse")
    r8 = gated_rows(torch, out8, o32, o16, "K8 D 256 out", 2.0)[0]
    (kq, vq, ks, vs), (kd, vd) = quant_pools(torch, kp, vp, "fp8")
    qargs = (qp, kq, vq, *tail)
    skw = dict(k_scales=ks, v_scales=vs)
    outq, lseq = vl.flash_attn_varlen_fwd_paged(*qargs, **skw)
    twin, lse_twin = vl.flash_attn_varlen_fwd_paged_ref(*qargs, **skw)
    unr = vl.flash_attn_varlen_fwd_paged_ref(*qargs, round_p=False, **skw)[0]
    oracle = vl.flash_attn_varlen_fwd_paged_ref(qp, kd, vd, *tail)[0]
    o_w = vl.flash_attn_varlen_fwd_paged(
        *qargs, k_scales=ks, v_scales=torch.roll(vs, 1, dims=2))[0]
    eq = gate_quant(torch, "K8q fp8 D 256 prefill", "fp8", outq, lseq, twin,
                    unr, lse_twin, oracle, spliced0(outq, o_w, Bp * T - 64))
    print(f"K8 D 256 prefill (B={Bp} x T={T} behind prefixes "
          f"{prefix.tolist()}, {Hq}/{Hk} heads, ps={ps}): out {e8[0]:.3e} <= "
          f"{e8[1]:.3e}, worst row err/gate {r8:.3f}, lse {e8l[0]:.3e} <= "
          f"{e8l[1]:.3e}", flush=True)
    k8_ms = graph_ms(torch, lambda: vl.flash_attn_varlen_fwd_paged(*args),
                     flush=flush)
    k8_plain = time_ms(torch, lambda: vl.flash_attn_varlen_fwd_paged_ref(
        *args), reps=5, flush=flush)
    kc, vc = gather_kv(torch, kp, vp, tail[0], seqlens, ps)
    k8_lib = time_ms(torch, prefill_sdpa(torch, qp, kc, vc, prefix, T),
                     flush=flush)
    live = sum(T * int(x) + T * (T + 1) // 2 for x in prefix)
    k8_bound = bound_ms(2 * qp.numel() * 2 + Hq * Bp * T * 4
                        + 2 * int(seqlens.sum()) * Hk * D * 2
                        + tail[0].numel() * 4, 4 * live * Hq * D)
    del args, qargs, out8, lse8, o32, o16, l32, l16, outq, lseq, twin, unr, \
        oracle, o_w, kc, vc, kp, vp, kq, vq, kd, vd

    laps.append(time.perf_counter())
    # what each D 256 kernel holds, and its SASS
    occ_names = ("K1", "K2", "K3", "K6", "K7", "K8", "K8q fp8")
    occ = occupancy(build, occ_names, dims=(256,))
    occ_res = {n: {} for n in occ_names}
    print_occupancy(occ_res, occ, 256)
    report = sass_report(build, 256, sass)

    laps.append(time.perf_counter())
    # the kernels line's rows: times at (b), causal (the other shapes and
    # masks are timed by --dense-times)
    d256 = d256_rows(torch, flush, cases=("D 256 b causal",))
    tb = d256["D 256 b causal"]
    kw = dict(dropout_p=0.0, dropout_seed=None)
    plain_fwd = time_ms(torch, lambda: dfwd.flash_attn_dense_fwd_ref(
        q, k, v, scale, params, **kw), reps=3, warmup=1, flush=flush)
    out, lse = dfwd.flash_attn_dense_fwd(q, k, v, scale, params)
    plain_bwd = time_ms(torch, lambda: dbwd.flash_attn_dense_bwd_ref(
        q, k, v, out, do, lse, scale, params, **kw), reps=3, warmup=1,
        flush=flush)
    res = {}
    for name, plain, lib in (("K1", plain_fwd, tb["sdpa_fwd_ms"]),
                             ("K2", plain_bwd, tb["sdpa_bwd_ms"]),
                             ("K3", plain_bwd, tb["sdpa_bwd_ms"])):
        worst = max((e for key, e in errs.items() if key[0] == name),
                    key=lambda e: e[0] / e[1])
        res[name] = dict(max_abs_err=worst[0], gate=worst[1],
                         ms=tb[name]["ms"], plain_ms=plain, library_ms=lib,
                         bound_ms=tb[name]["bound_ms"],
                         bound_by=tb[name]["bound_by"])
        if name in occ_res:
            res[name]["occupancy"] = occ_res[name]["occupancy"]
    res["K8"] = dict(max_abs_err=e8[0], gate=e8[1], ms=k8_ms,
                     plain_ms=k8_plain, library_ms=k8_lib,
                     bound_ms=k8_bound[0], bound_by=k8_bound[1],
                     occupancy=occ_res["K8"]["occupancy"])
    res["hgmma"] = {r["id"]: r["hgmma"] for r in report.values()}
    laps.append(time.perf_counter())
    print(f"K8 D 256 prefill: kernel {k8_ms:.4f} ms (graph replays), plain "
          f"{k8_plain:.4f} ms, sdpa {k8_lib:.4f} ms, bound "
          f"{k8_bound[0]:.5f} ms ({k8_bound[1]})", flush=True)
    print("d256 checks, s: " + ", ".join(
        f"{name} {b - a:.1f}" for name, a, b in zip(
            ("dense", "varlen", "paged", "occupancy + SASS", "times"),
            laps, laps[1:])), flush=True)
    return res


def timed_ms(torch, fn):
    """(fn(), its device time in ms): CUDA events around this one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def max_sm_mhz() -> float:
    """The card's maximum SM clock (MHz), as nvidia-smi reads it: the
    clock of the exponentials' least time."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def d32_checks(torch, flush, sass) -> dict:
    """Head dim 32.  (d32a), causal, bf16: K1, K2 and K3 against their
    plain versions (whole-tensor and per-row gates), two backward calls
    bit-equal, K5 / K6 / K7 on the batch as equal-length sequences
    bit-equal to K1 / K2 / K3.  (d32b): the encoders' path, a padded batch
    through unpad_input -> flash_attn_varlen_func (non-causal) -> pad_input
    and its backward, from the launch counters at 0: one launch each of
    K5, K6, K7 and none of the plain versions; the packed out and
    gradients against the plain versions'.  (d16): K1 and K5 at head dim
    16 read the rows unpadded (one launch each, no F.pad) within the
    forward gate, K5 bit-equal to K1.  K8 and K8q fp8 at the engine's
    prefill wave at 12/12 heads x 32 against theirs.  The SASS report
    (`sass_report` on `sass`).  The `kernels` line's D 32 rows: each
    kernel's graph-replay time on the inputs it was checked on, the plain
    versions' times from their one call in the checks, one library call,
    and the bound (bytes or operations; the exponentials' term at the
    card's maximum SM clock beside it).  The rounds in turns with a parent
    tree are `--d32-times`'."""
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops import padding as padlib
    from flash_attn_v100_tpu_torch.ops import varlen as varlen_mod
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    from flash_attn_v100_tpu_torch.utils import testing as tt

    dev = torch.device("cuda")
    F = torch.nn.functional
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_mhz()
    laps = [time.perf_counter()]
    B, S, Hq, Hk, D = D32A_SHAPE
    ggen = torch.Generator(device=dev).manual_seed(SEED + 31)
    q, k, v, do = (torch.randn(sh, generator=ggen, device=dev).to(
        torch.bfloat16) for sh in ((B, S, Hq, D), (B, S, Hk, D),
                                   (B, S, Hk, D), (B, S, Hq, D)))
    params = masklib.MaskParams(causal=True)
    scale = D ** -0.5
    errs, rows, res = {}, {}, {}
    out, lse = dfwd.flash_attn_dense_fwd(q, k, v, scale, params)
    dq, dk, dv = dbwd.flash_attn_dense_bwd(q, k, v, out, do, lse, scale,
                                           params)
    torch.cuda.synchronize()
    (o32, l32), plain_fwd = timed_ms(
        torch, lambda: dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params))
    o16, l16 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params,
                                             upcast=False)
    errs[("K1", "out")] = gated(torch, out, o32, o16, "K1 D 32 out")
    errs[("K1", "lse")] = gated(torch, lse, l32, l16, "K1 D 32 lse")
    rows["K1 out"] = gated_rows(torch, out, o32, o16, "K1 D 32 out",
                                tt.FWD_MULT)[0]
    del o32, o16, l32, l16
    g32, plain_bwd = timed_ms(torch, lambda: dbwd.flash_attn_dense_bwd_ref(
        q, k, v, out, do, lse, scale, params))
    g16 = dbwd.flash_attn_dense_bwd_ref(q, k, v, out, do, lse, scale, params,
                                        upcast=False)
    for kid, key, g, r32, r16 in (("K2", "dq", dq, g32[0], g16[0]),
                                  ("K3", "dk", dk, g32[1], g16[1]),
                                  ("K3", "dv", dv, g32[2], g16[2])):
        errs[(kid, key)] = gated(torch, g, r32, r16, f"{kid} D 32 {key}",
                                 tt.BWD_MULT, tt.BWD_ATOL)
        rows[f"{kid} {key}"] = gated_rows(torch, g, r32, r16,
                                          f"{kid} D 32 {key}",
                                          tt.BWD_MULT)[0]
    del g32, g16
    again = dbwd.flash_attn_dense_bwd(q, k, v, out, do, lse, scale, params)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)), \
        "D 32: two backward calls differ"
    cu = torch.arange(B + 1, dtype=torch.int32, device=dev) * S
    pk = [t.reshape(B * S, *t.shape[2:]) for t in (q, k, v, do)]
    o_v, lse_v = vl.flash_attn_varlen_fwd(pk[0], pk[1], pk[2], cu, cu, S, S,
                                          scale, params)
    assert torch.equal(o_v, out.reshape(B * S, Hq, D)), "D 32: K5 != K1"
    assert torch.equal(lse_v, lse.permute(1, 0, 2).reshape(Hq, B * S)), \
        "D 32: K5 lse != K1's"
    g_v = vl.flash_attn_varlen_bwd(pk[0], pk[1], pk[2], o_v, pk[3], lse_v,
                                   cu, cu, S, S, scale, params)
    for a, b, what in zip(g_v, (dq, dk, dv), ("dq", "dk", "dv")):
        assert torch.equal(a, b.reshape(a.shape)), \
            f"D 32 equal lengths: varlen {what} != dense"
    print(f"dense D 32 (B={B}, S={S}, Hq={Hq}, Hk={Hk}, causal, bf16): max "
          f"abs err vs fp32 plain <= gate: " + ", ".join(
              f"{kid} {key} {e[0]:.3e} <= {e[1]:.3e}"
              for (kid, key), e in errs.items()) + "; per-row err/gate " +
          ", ".join(f"{key} {r:.3f}" for key, r in rows.items()) +
          "; two backward calls bit-equal; K5 / K6 / K7 on 4 equal-length "
          "sequences bit-equal to K1 / K2 / K3", flush=True)
    del again, o_v, lse_v, g_v, pk
    # the kernels line's (d32a) rows: each kernel alone on these inputs
    kargs = (q, k, v, do, lse.clamp_min(NEG_INF).contiguous(),
             dbwd.softmax_delta(out, do), None, scale, params, 0.0, None, 0,
             None, Hq)
    ms = {"K1": graph_ms(torch, lambda: dfwd.flash_attn_dense_fwd(
              q, k, v, scale, params), reps=5, flush=flush),
          "K2": graph_ms(torch, lambda: dbwd.dq_kernel(*kargs), reps=5,
                         flush=flush),
          "K3": graph_ms(torch, lambda: dbwd.dkv_kernel(*kargs), reps=5,
                         flush=flush)}
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), reps=3, warmup=1,
        flush=flush)
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
    do_s = do.transpose(1, 2).contiguous()
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qs, ks, vs), do_s, retain_graph=True), reps=3, warmup=1,
        flush=flush)
    work = dense_work(B, S, Hq, Hk, D, causal=True)
    pairs = B * Hq * S * (S + 1) // 2
    for kid in ("K1", "K2", "K3"):
        worst = max((e for key, e in errs.items() if key[0] == kid),
                    key=lambda e: e[0] / e[1])
        flops, nbytes = work[kid]
        res[kid] = dict(max_abs_err=worst[0], gate=worst[1], ms=ms[kid],
                        plain_ms=plain_fwd if kid == "K1" else plain_bwd,
                        library_ms=lib_fwd if kid == "K1" else lib_bwd,
                        bound3=bound3(nbytes, flops, pairs, mhz, sms))
    print(f"dense D 32 times (graph replays): " + ", ".join(
        f"{kid} {ms[kid]:.4f} ms" for kid in ms) + f"; plain fwd "
        f"{plain_fwd:.4f}, bwd {plain_bwd:.4f} ms (one call); sdpa fwd "
        f"{lib_fwd:.4f}, bwd {lib_bwd:.4f} ms", flush=True)
    del out, lse, dq, dk, dv, q, k, v, do, kargs, qs, ks, vs, o_lib, do_s

    laps.append(time.perf_counter())
    # (d32b): the encoders' padded batch through the drop-in's pattern
    lens = d32b_lengths()
    H, n, S_pad = D32B_HEADS, len(lens), D32B_LENS[1]
    mask = (torch.arange(S_pad, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])
    xq, xk, xv, xdo = (torch.randn((n, S_pad, H, D), generator=ggen,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(4))
    full = masklib.MaskParams()
    reset_kernel_counts()
    leaves = [t.clone().requires_grad_() for t in (xq, xk, xv)]
    uq, idx, cu_b, ml, _ = padlib.unpad_input(leaves[0], mask)
    uk, uv = (padlib.unpad_input(t, mask)[0] for t in leaves[1:])
    o_b = varlen_mod.flash_attn_varlen_func(uq, uk, uv, cu_b, cu_b, ml, ml,
                                            causal=False)
    padlib.pad_input(o_b, idx, n, S_pad).backward(xdo)
    torch.cuda.synchronize()
    launches, twins = kernel_counts()
    assert (launches["K5"], launches["K6"], launches["K7"]) == (1, 1, 1), \
        launches
    assert not any(twins.values()), twins
    grads = [t.grad[mask] for t in leaves]
    pq, pk_, pv, pdo = (t[mask] for t in (xq, xk, xv, xdo))
    bargs = (pq, pk_, pv, cu_b, cu_b, ml, ml, scale, full)
    (o32, l32), plain5 = timed_ms(
        torch, lambda: vl.flash_attn_varlen_fwd_ref(*bargs))
    o16, _ = vl.flash_attn_varlen_fwd_ref(*bargs, upcast=False)
    e5 = gated(torch, o_b.detach(), o32, o16, "K5 D 32 b out")
    r5 = gated_rows(torch, o_b.detach(), o32, o16, "K5 D 32 b out",
                    tt.FWD_MULT)[0]
    rargs = (pq, pk_, pv, o_b.detach(), pdo, l32, cu_b, cu_b, ml, ml, scale,
             full)
    g32, plain67 = timed_ms(torch,
                            lambda: vl.flash_attn_varlen_bwd_ref(*rargs))
    g16 = vl.flash_attn_varlen_bwd_ref(*rargs, upcast=False)
    e67 = [gated(torch, g, r32, r16, f"{kid} D 32 b {what}", tt.BWD_MULT,
                 tt.BWD_ATOL)
           for g, r32, r16, kid, what in zip(grads, g32, g16,
                                             ("K6", "K7", "K7"),
                                             ("dq", "dk", "dv"))]
    print(f"varlen D 32 b (the encoders' batch: {n} sequences of "
          f"{min(lens)}-{max(lens)} tokens padded to {S_pad}, {H}/{H} heads, "
          f"non-causal, bf16, unpad_input -> flash_attn_varlen_func -> "
          f"pad_input and back): launches K5 {launches['K5']}, K6 "
          f"{launches['K6']}, K7 {launches['K7']}, plain twins "
          f"{sum(twins.values())}; K5 out {e5[0]:.3e} <= {e5[1]:.3e} (worst row err/gate "
          f"{r5:.3f}); K6 dq {e67[0][0]:.3e} <= {e67[0][1]:.3e}; K7 dk "
          f"{e67[1][0]:.3e} <= {e67[1][1]:.3e}, dv {e67[2][0]:.3e} <= "
          f"{e67[2][1]:.3e}", flush=True)
    del leaves, o_b, grads, g32, g16, o32, o16, l32, xq, xk, xv, xdo
    # the kernels line's (d32b) rows: each kernel alone on these inputs
    fargs = (pq, pk_, pv, cu_b, cu_b, ml, ml, scale, full)
    o5, lse5 = vl.flash_attn_varlen_fwd(*fargs)
    kargs = (pq, pk_, pv, pdo, lse5.clamp_min(NEG_INF).contiguous(),
             vl.varlen_delta(o5, pdo), None, cu_b, cu_b, None, None, ml, ml,
             scale, full, 0.0, None)
    ms = {"K5": graph_ms(torch, lambda: vl.flash_attn_varlen_fwd(*fargs),
                         reps=5, flush=flush),
          "K6": graph_ms(torch, lambda: vl.varlen_dq_kernel(*kargs), reps=5,
                         flush=flush),
          "K7": graph_ms(torch, lambda: vl.varlen_dkv_kernel(*kargs),
                         reps=5, flush=flush)}
    ql, kl, vl_ = (t.clone().requires_grad_() for t in (pq, pk_, pv))
    label, lib_fn, o_lib = varlen_library(torch, ql, kl, vl_, cu_b, ml,
                                          causal=False)
    lib5 = time_ms(torch, lib_fn, reps=3, warmup=1, flush=flush)
    o_lib = o_lib[0] if isinstance(o_lib, tuple) else o_lib
    do_lib = pdo if o_lib.dim() == 3 else pdo.transpose(0, 1)[None]
    lib67 = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (ql, kl, vl_), do_lib, retain_graph=True), reps=3, warmup=1,
        flush=flush)
    work = varlen_work(lens, H, H, D, causal=False)
    for kid, e in (("K5", e5), ("K6", e67[0]),
                   ("K7", max(e67[1:], key=lambda x: x[0] / x[1]))):
        flops, nbytes = work[kid]
        pairs = flops // ({"K5": 4, "K6": 6, "K7": 8}[kid] * D)
        res[kid] = dict(max_abs_err=e[0], gate=e[1], ms=ms[kid],
                        plain_ms=plain5 if kid == "K5" else plain67,
                        library_ms=lib5 if kid == "K5" else lib67,
                        library=f"{label} {'fwd' if kid == 'K5' else 'bwd'}",
                        bound3=bound3(nbytes, flops, pairs, mhz, sms))
    print(f"varlen D 32 b times (graph replays): " + ", ".join(
        f"{kid} {ms[kid]:.4f} ms" for kid in ms) + f"; plain fwd "
        f"{plain5:.4f}, bwd {plain67:.4f} ms (one call); {label} fwd "
        f"{lib5:.4f}, bwd {lib67:.4f} ms", flush=True)
    del pq, pk_, pv, pdo, o5, lse5, kargs, ql, kl, vl_, o_lib, do_lib

    laps.append(time.perf_counter())
    # (d16): K1 and K5 at head dim 16 read the rows as they are
    Bn, Sn, Hn = D16_SHAPE
    Dn = 16
    q, k, v = (torch.randn((Bn, Sn, Hn, Dn), generator=ggen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    scale16 = Dn ** -0.5
    cu16 = torch.arange(Bn + 1, dtype=torch.int32, device=dev) * Sn
    pk = [t.reshape(Bn * Sn, Hn, Dn) for t in (q, k, v)]
    pads = []
    real_pad = F.pad
    reset_kernel_counts()
    F.pad = lambda *a, **kw: pads.append(1) or real_pad(*a, **kw)
    try:
        o1, l1 = dfwd.flash_attn_dense_fwd(q, k, v, scale16, params)
        o5, l5 = vl.flash_attn_varlen_fwd(*pk, cu16, cu16, Sn, Sn, scale16,
                                          params)
        torch.cuda.synchronize()
    finally:
        F.pad = real_pad
    launches16, twins16 = kernel_counts()
    assert (launches16["K1"], launches16["K5"]) == (1, 1), launches16
    assert not any(twins16.values()), twins16
    assert not pads, f"D 16: {len(pads)} F.pad calls"
    assert o1.shape == q.shape and o5.shape == pk[0].shape
    assert torch.equal(o5, o1.reshape(o5.shape)), "D 16: K5 != K1"
    assert torch.equal(l5, l1.permute(1, 0, 2).reshape(Hn, Bn * Sn)), \
        "D 16: K5 lse != K1's"
    o32, l32 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale16, params)
    o16, l16 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale16, params,
                                             upcast=False)
    e16 = gated(torch, o1, o32, o16, "K1 D 16 out")
    e16l = gated(torch, l1, l32, l16, "K1 D 16 lse")
    print(f"d16 (B={Bn}, S={Sn}, {Hn}/{Hn} heads x 16, causal, bf16): one "
          f"launch each of K1 and K5, no F.pad, no plain twin; K1 out "
          f"{e16[0]:.3e} <= {e16[1]:.3e}, lse {e16l[0]:.3e} <= "
          f"{e16l[1]:.3e}; K5 on 4 equal-length sequences bit-equal to K1",
          flush=True)
    res["d16"] = dict(out=e16, lse=e16l, launches=dict(
        K1=launches16["K1"], K5=launches16["K5"]))
    del q, k, v, pk, o1, l1, o5, l5, o32, l32, o16, l16

    laps.append(time.perf_counter())
    # K8 and K8q fp8 at the engine's prefill wave, 12/12 heads x 32
    (Bp, T, _, _, _, ps), prefix, seqlens, qp, kp, vp, tail, _ = k8_case(
        torch, Hq=H, Hk=H, D=D)
    args = (qp, kp, vp) + tail
    out8, lse8 = vl.flash_attn_varlen_fwd_paged(*args)
    torch.cuda.synchronize()
    (o32, l32), k8_plain = timed_ms(
        torch, lambda: vl.flash_attn_varlen_fwd_paged_ref(*args))
    o16, l16 = vl.flash_attn_varlen_fwd_paged_ref(*args, upcast=False)
    e8 = gated(torch, out8, o32, o16, "K8 D 32 out")
    e8l = gated(torch, lse8, l32, l16, "K8 D 32 lse")
    (kq, vq, ks, vs), (kd, vd) = quant_pools(torch, kp, vp, "fp8")
    qargs = (qp, kq, vq, *tail)
    skw = dict(k_scales=ks, v_scales=vs)
    outq, lseq = vl.flash_attn_varlen_fwd_paged(*qargs, **skw)
    (twin, lse_twin), k8q_plain = timed_ms(
        torch, lambda: vl.flash_attn_varlen_fwd_paged_ref(*qargs, **skw))
    unr = vl.flash_attn_varlen_fwd_paged_ref(*qargs, round_p=False, **skw)[0]
    oracle = vl.flash_attn_varlen_fwd_paged_ref(qp, kd, vd, *tail)[0]
    o_w = vl.flash_attn_varlen_fwd_paged(
        *qargs, k_scales=ks, v_scales=torch.roll(vs, 1, dims=2))[0]
    eq = gate_quant(torch, "K8q fp8 D 32 prefill", "fp8", outq, lseq, twin,
                    unr, lse_twin, oracle, spliced0(outq, o_w, Bp * T - 64))
    k8_ms = graph_ms(torch, lambda: vl.flash_attn_varlen_fwd_paged(*args),
                     flush=flush)
    k8q_ms = graph_ms(torch, lambda: vl.flash_attn_varlen_fwd_paged(
        *qargs, **skw), flush=flush)
    kc, vc = gather_kv(torch, kp, vp, tail[0], seqlens, ps)
    k8_lib = time_ms(torch, prefill_sdpa(torch, qp, kc, vc, prefix, T),
                     reps=5, warmup=1, flush=flush)
    live = sum(T * int(x) + T * (T + 1) // 2 for x in prefix)
    kv_tok = int(seqlens.sum())
    k8_bound = bound_ms(2 * qp.numel() * 2 + H * Bp * T * 4
                        + 2 * kv_tok * H * D * 2 + tail[0].numel() * 4,
                        4 * live * H * D)
    k8q_bound = bound_ms(2 * qp.numel() * 2 + H * Bp * T * 4
                         + 2 * kv_tok * H * (D + 4) + tail[0].numel() * 4,
                         4 * live * H * D)
    print(f"K8 / K8q fp8 D 32 prefill (B={Bp} x T={T} behind prefixes "
          f"{prefix.tolist()}, {H}/{H} heads, ps={ps}): K8 out {e8[0]:.3e} <="
          f" {e8[1]:.3e}, lse {e8l[0]:.3e} <= {e8l[1]:.3e}; graph replays "
          f"K8 {k8_ms:.4f} ms, K8q fp8 {k8q_ms:.4f} ms; plain {k8_plain:.4f} /"
          f" {k8q_plain:.4f} ms (one call); sdpa {k8_lib:.4f} ms; bounds "
          f"{k8_bound[0]:.5f} / {k8q_bound[0]:.5f} ms", flush=True)
    del args, qargs, out8, lse8, o32, o16, l32, l16, outq, lseq, twin, unr, \
        oracle, o_w, kc, vc, kp, vp, kq, vq, kd, vd

    laps.append(time.perf_counter())
    report = sass_report(build, 32, sass)
    res["K8"] = dict(max_abs_err=e8[0], gate=e8[1], ms=k8_ms,
                     plain_ms=k8_plain, library_ms=k8_lib,
                     bound_ms=k8_bound[0], bound_by=k8_bound[1])
    res["K8q"] = dict(max_abs_err=eq["max_abs_err"], gate=eq["gate"],
                      ms=k8q_ms, plain_ms=k8q_plain, library_ms=None,
                      bound_ms=k8q_bound[0], bound_by=k8q_bound[1])
    for kid in ("K1", "K2", "K3", "K5", "K6", "K7"):
        # the kernels line's bound: bytes or tensor-core operations, the
        # exponentials' term beside it
        t = res[kid]["bound3"]["terms"]
        res[kid]["bound_ms"] = max(t["bytes"], t["operations"])
        res[kid]["bound_by"] = ("bytes" if t["bytes"] >= t["operations"]
                                else "operations")
        res[kid]["bound3_clock_mhz"] = mhz
    res["sass"] = report
    res["launches_b"] = launches
    laps.append(time.perf_counter())
    print("d32 checks, s: " + ", ".join(
        f"{name} {b - a:.1f}" for name, a, b in zip(
            ("dense", "varlen", "d16", "paged", "SASS"), laps, laps[1:])),
        flush=True)
    return res


def minilm_config(torch):
    """sentence-transformers/all-MiniLM-L6-v2's widths (config.json: hidden
    384, 6 layers, 12 heads x 32, intermediate 1536, vocab 30522;
    BAAI/bge-small-en-v1.5 has the same heads and widths at 12 layers) on
    the repo's Llama body, bf16; max_seq_len 2048 (the encoders' 512
    positions raised to the repo's training batch)."""
    from flash_attn_v100_tpu_torch import ModelConfig
    return ModelConfig(vocab_size=30522, dim=384, n_layers=6, n_heads=12,
                       n_kv_heads=12, head_dim=32, ffn_dim=1536,
                       rope_theta=10000.0, max_seq_len=2048,
                       dtype=torch.bfloat16)


def phase_d32(torch):
    """The repo's Llama body at the small encoders' widths (head dim 32,
    `minilm_config`, not cut): training (head_dim_train) through K1-K3 at D
    32, then serving (head_dim_serve) through K8 and K4 at D 32."""
    cfg = minilm_config(torch)
    train = head_dim_train(torch, cfg, "d32")
    gc.collect()
    torch.cuda.empty_cache()
    # at group 1 a prefill takes the K8 route from 1024 rows
    # (ops/kvcache.py VARLEN_PREFILL_MIN_ROWS): 1024-token prompts
    serve = head_dim_serve(torch, cfg, "d32", long_len=1024)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(train=train, serve=serve)


# ------------------------------------------------- K5-K7 (varlen phase)

# TinyLlama-1.1B attention at B 4 x S 2048, as the dense phase; the padded
# batch's real lengths (4621 tokens) and the packed documents' length range
VARLEN_PAD_LENS = (2048, 1536, 1000, 37)
VARLEN_DOC_LENS = (37, 2048)


def packed_doc_lengths(rows: int, S: int, seed: int = 0):
    """Per row, document lengths drawn uniform in VARLEN_DOC_LENS until the
    row is full, the last document taking the remainder."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rows):
        left, docs = S, []
        while left > 0:
            n = int(rng.integers(VARLEN_DOC_LENS[0], VARLEN_DOC_LENS[1] + 1))
            docs.append(min(n, left))
            left -= docs[-1]
        out.append(docs)
    return out


def varlen_work(lens, Hq, Hk, D, esize=2, causal=True):
    """(flops, bytes) of K5, K6 and K7 for causal (or full) self-attention
    over sequences of `lens`: dense_work's rule per sequence (4, 6 and 8
    flops x D per live (q row, key) pair), each input read once and each
    output written once."""
    pairs = Hq * sum(n * (n + 1) // 2 if causal else n * n for n in lens)
    T = sum(lens)
    q_bytes, kv_bytes, row_bytes = (T * Hq * D * esize, T * Hk * D * esize,
                                    T * Hq * 4)
    return {
        "K5": (4 * D * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        "K6": (6 * D * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        "K7": (8 * D * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
    }


def spliced0(x, y, lo, n=64):
    """x with packed rows [lo, lo + n) (dim 0) taken from y."""
    z = x.clone()
    z[lo:lo + n] = y[lo:lo + n]
    return z


def varlen_library(torch, q, k, v, cu, max_len, causal=True):
    """The library yardstick for causal (or full) varlen attention: one
    call of torch.nn.attention.varlen.varlen_attn where the installed torch
    has it, else SDPA (`enable_gqa`) with a boolean block-diagonal (causal)
    mask over the packed sequence.  Returns (label, forward fn, output)."""
    import inspect
    F = torch.nn.functional
    try:
        from torch.nn.attention.varlen import varlen_attn
        sig = inspect.signature(varlen_attn).parameters
        kw = {}
        kk, vv, label = k, v, "varlen_attn"
        if "enable_gqa" in sig:
            kw["enable_gqa"] = True
        else:
            g = q.shape[1] // k.shape[1]
            kk, vv = (t.repeat_interleave(g, dim=1) for t in (k, v))
            label += " (k/v heads repeated)"
        if "window_size" in sig:
            kw["window_size"] = (-1, 0) if causal else (-1, -1)
        else:
            kw["is_causal"] = causal

        def fn():
            return varlen_attn(q, kk, vv, cu, cu, max_len, max_len, **kw)
        out = fn()
        torch.cuda.synchronize()
        return label, fn, out
    except (ImportError, RuntimeError, TypeError, ValueError) as e:
        print(f"varlen: varlen_attn unusable here ({type(e).__name__}: "
              f"{str(e)[:120]}); SDPA with a block-diagonal mask instead",
              flush=True)
    T = q.shape[0]
    seg = torch.repeat_interleave(
        torch.arange(cu.numel() - 1, device=q.device),
        (cu[1:] - cu[:-1]).long(), output_size=T)
    pos = torch.arange(T, device=q.device)
    mask = (seg[:, None] == seg[None, :]) & (
        (pos[None, :] <= pos[:, None]) | (not causal))
    qs, ks, vs = (t.transpose(0, 1)[None] for t in (q, k, v))

    def fn():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)
    return "sdpa (block-diagonal causal mask)", fn, fn()


def _varlen_counts(vl):
    return {"K5": vl.flash_attn_varlen_fwd.launches,
            "K6": vl.varlen_dq_kernel.launches,
            "K7": vl.varlen_dkv_kernel.launches,
            "plain_fwd": vl.flash_attn_varlen_fwd_ref.calls,
            "plain_bwd": vl.flash_attn_varlen_bwd_ref.calls}


def phase_varlen(torch, flush):
    """flash_attn_varlen_func forward and backward at TinyLlama-1.1B
    attention width (32/4 heads x 64, causal, bf16) through the public
    entry points: (a) 4 x 2048 equal lengths against flash_attn_func, with
    and without dropout; (b) a padded batch through unpad_input ->
    flash_attn_varlen_func -> pad_input; (c) packed documents through
    unpad_input_for_concatenated_sequences.  Then K5, K6 and K7 against
    their plain versions at (c), and their times.  Returns the per-kernel
    results of the `kernels` line."""
    import numpy as np
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops import padding as padlib
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
    from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func
    from flash_attn_v100_tpu_torch.utils import testing as tt

    dev = torch.device("cuda")
    B, S, Hq, Hk, D = DENSE_B, DENSE_S, DENSE_HQ, DENSE_HK, DENSE_D
    ggen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def rnd(*shape):
        return torch.randn(shape, generator=ggen, device=dev).to(
            torch.bfloat16)

    scale = D ** -0.5
    params = masklib.MaskParams(causal=True)
    seed = torch.tensor([0x0F1E2D3C, 0x4B5A6978], dtype=torch.int64)
    x = {n: rnd(B, S, h, D) for n, h in (("q", Hq), ("k", Hk), ("v", Hk),
                                          ("do", Hq))}
    cu_a = torch.arange(B + 1, dtype=torch.int32, device=dev) * S
    mask_b = (torch.arange(S, device=dev)[None, :]
              < torch.tensor(VARLEN_PAD_LENS, device=dev)[:, None])
    docs = packed_doc_lengths(B, S, SEED)
    aml = torch.zeros((B, S), dtype=torch.int32)
    for r, d in enumerate(docs):
        aml[r, :len(d)] = torch.tensor(d, dtype=torch.int32)
    aml = aml.to(dev)

    def leaves(packed=True):
        return [(x[n].reshape(B * S, *x[n].shape[2:]) if packed else x[n])
                .clone().requires_grad_() for n in ("q", "k", "v")]

    # ---- the main path, through the public entry points, counted
    torch.cuda.synchronize()
    vl.flash_attn_varlen_fwd.launches = 0
    vl.varlen_dq_kernel.launches = vl.varlen_dkv_kernel.launches = 0
    vl.flash_attn_varlen_fwd_ref.calls = vl.flash_attn_varlen_bwd_ref.calls = 0
    t0 = time.perf_counter()
    run_a = {}
    for p in (0.0, DENSE_DROPOUT):                          # (a)
        lv = leaves()
        out, lse, dmask = flash_attn_varlen_func(
            *lv, cu_a, cu_a, S, S, dropout_p=p, dropout_seed=seed,
            causal=True, return_attn_probs=True)
        out.backward(x["do"].reshape(B * S, Hq, D))
        run_a[p] = (out.detach(), lse.detach(), dmask,
                    *(t.grad for t in lv))
    lv_b = leaves(packed=False)                             # (b)
    un = [padlib.unpad_input(t, mask_b) for t in lv_b]
    idx_b, cu_b, ms_b = un[0][1], un[0][2], un[0][3]
    out_b = padlib.pad_input(flash_attn_varlen_func(
        un[0][0], un[1][0], un[2][0], cu_b, cu_b, ms_b, ms_b, causal=True),
        idx_b, B, S)
    out_b.backward(x["do"])
    lv_c = leaves(packed=False)                             # (c)
    un = [padlib.unpad_input_for_concatenated_sequences(t, aml)
          for t in lv_c]
    cu_c, ms_c = un[0][2], un[0][3]
    out_c = flash_attn_varlen_func(un[0][0], un[1][0], un[2][0], cu_c, cu_c,
                                   ms_c, ms_c, causal=True)
    out_c.backward(padlib.index_first_axis(
        x["do"].reshape(B * S, Hq, D), un[0][1]))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = _varlen_counts(vl)
    for name in ("K5", "K6", "K7"):
        assert counts[name] == 4, counts       # (a) twice, (b), (c)
    assert counts["plain_fwd"] == 0 and counts["plain_bwd"] == 0, counts
    lens_c = [n for d in docs for n in d]
    print(f"varlen main path (flash_attn_varlen_func fwd + bwd, Hq={Hq}, "
          f"Hk={Hk}, D={D}, causal, bf16; (a) {B} x {S} with p 0 and "
          f"{DENSE_DROPOUT}, (b) padded lengths {list(VARLEN_PAD_LENS)} = "
          f"{sum(VARLEN_PAD_LENS)} tokens, (c) {len(lens_c)} packed "
          f"documents of {min(lens_c)}-{max(lens_c)} tokens in {B} rows of "
          f"{S}): {main_s:.3f} s, launches K5 {counts['K5']}, K6 "
          f"{counts['K6']}, K7 {counts['K7']}; plain calls "
          f"{counts['plain_fwd']} / {counts['plain_bwd']}", flush=True)

    # ---- (a): against flash_attn_func on the same tensors: out, LSE,
    # dmask and the gradients bit for bit (K5 is K1's body, K6/K7 K2/K3's);
    # both paths' gradients also within the plain backward's gate
    n_exact = 0
    for p, (out, lse, dmask, dq, dk, dv) in run_a.items():
        ld = [x[n].clone().requires_grad_() for n in ("q", "k", "v")]
        out_d, lse_d, dmask_d = flash_attn_func(
            *ld, dropout_p=p, dropout_seed=seed, causal=True,
            return_attn_probs=True)
        out_d.backward(x["do"])
        assert torch.equal(out, out_d.reshape(B * S, Hq, D)), f"(a) p={p} out"
        assert torch.equal(lse, lse_d.permute(1, 0, 2).reshape(Hq, B * S)), \
            f"(a) p={p} lse"
        if p:
            assert torch.equal(dmask, dmask_d.permute(0, 2, 1, 3).reshape(
                B * S, Hq, S)), "(a) dmask"
        bw = (*(x[n].reshape(B * S, *x[n].shape[2:]) for n in ("q", "k", "v")),
              out, x["do"].reshape(B * S, Hq, D), lse, cu_a, cu_a, S, S,
              scale, params)
        pkw = dict(dropout_p=p, dropout_seed=seed)
        g32 = vl.flash_attn_varlen_bwd_ref(*bw, **pkw)
        g16 = vl.flash_attn_varlen_bwd_ref(*bw, upcast=False, **pkw)
        for g, gd, r32, r16, what in zip((dq, dk, dv), ld, g32, g16,
                                         ("dq", "dk", "dv")):
            gd = gd.grad.reshape(g.shape)
            gated(torch, g, r32, r16, f"(a) p={p} varlen {what}",
                  tt.BWD_MULT, tt.BWD_ATOL)
            gated(torch, gd, r32, r16, f"(a) p={p} flash_attn_func {what}",
                  tt.BWD_MULT, tt.BWD_ATOL)
            assert torch.equal(g, gd), (
                f"(a) p={p} {what}: varlen differs from flash_attn_func, max "
                f"|diff| {float((g.float() - gd.float()).abs().max()):.3e}")
            n_exact += 1
        del out_d, lse_d, dmask_d, ld, g32, g16
    # K5's keep mask read back: q = k = 0 and v one-hot on 64 keys at a time
    q0 = torch.zeros((B * S, Hq, D), device=dev, dtype=torch.bfloat16)
    k0 = torch.zeros((B * S, Hk, D), device=dev, dtype=torch.bfloat16)
    v1 = torch.zeros_like(k0)
    eye = torch.eye(D, device=dev, dtype=torch.bfloat16)
    keep = torch.empty((B * S, Hq, S), dtype=torch.bool, device=dev)
    for c0 in range(0, S, D):
        v1.zero_()
        v1.view(B, S, Hk, D)[:, c0:c0 + D] = eye[:, None, :]
        o, _ = vl.flash_attn_varlen_fwd(
            q0, k0, v1, cu_a, cu_a, S, S, 0.125, masklib.MaskParams(),
            dropout_p=DENSE_DROPOUT, dropout_seed=seed)
        keep[..., c0:c0 + D] = o > 0
    assert torch.equal(keep, run_a[DENSE_DROPOUT][2] > 0), "K5's mask"
    rate = float(keep.float().mean())
    print(f"varlen (a): out, LSE bit-equal to flash_attn_func at p 0 and "
          f"{DENSE_DROPOUT}, dmask too; dq, dk, dv bit-equal in {n_exact} "
          f"of 6 and both paths' within the plain backward's gate; K5's keep "
          f"mask read back over {keep.numel()} positions bit-equal to the "
          f"dmask (keep rate {rate:.5f})", flush=True)
    del run_a, keep, q0, k0, v1

    # ---- (b): each sequence against flash_attn_func on it alone: out and
    # the gradients bit for bit, the gradients also within the gate of the
    # plain backward on that sequence alone
    assert not out_b[mask_b.logical_not()].any()
    for t in lv_b:
        assert not t.grad[mask_b.logical_not()].any()
    n_exact = 0
    for r, n in enumerate(VARLEN_PAD_LENS):
        ld = [x[nm][r:r + 1, :n].clone().requires_grad_()
              for nm in ("q", "k", "v")]
        o = flash_attn_func(*ld, causal=True)
        o.backward(x["do"][r:r + 1, :n])
        assert torch.equal(o[0], out_b[r, :n]), f"(b) row {r} out"
        sq = [t.detach() for t in ld]
        o_r, l_r = dfwd.flash_attn_dense_fwd(*sq, scale, params)
        bw = (*sq, o_r, x["do"][r:r + 1, :n], l_r, scale, params)
        g32 = dbwd.flash_attn_dense_bwd_ref(*bw)
        g16 = dbwd.flash_attn_dense_bwd_ref(*bw, upcast=False)
        for t, td, r32, r16, what in zip(lv_b, ld, g32, g16,
                                         ("dq", "dk", "dv")):
            g = t.grad[r:r + 1, :n]
            gated(torch, g, r32, r16, f"(b) row {r} {what}", tt.BWD_MULT,
                  tt.BWD_ATOL)
            assert torch.equal(g, td.grad), (
                f"(b) row {r} {what}: varlen differs from flash_attn_func on "
                f"the sequence alone, max |diff| "
                f"{float((g.float() - td.grad.float()).abs().max()):.3e}")
            n_exact += 1
    print(f"varlen (b): padded rows and their gradients 0; each sequence's "
          f"out and dq/dk/dv bit-equal to flash_attn_func on it alone "
          f"({n_exact} of {3 * len(VARLEN_PAD_LENS)} gradients), the "
          f"gradients within the plain backward's gate on it alone",
          flush=True)
    del out_b, lv_b

    # ---- (c): K5, K6, K7 against their plain versions
    qc, kc, vc = (u[0].detach() for u in un)
    doc = padlib.index_first_axis(x["do"].reshape(B * S, Hq, D), un[0][1])
    args = (qc, kc, vc, cu_c, cu_c, ms_c, ms_c, scale, params)
    out, lse = vl.flash_attn_varlen_fwd(*args)
    bargs = (qc, kc, vc, out, doc, lse, cu_c, cu_c, ms_c, ms_c, scale,
             params)
    grads = vl.flash_attn_varlen_bwd(*bargs)
    torch.cuda.synchronize()
    assert torch.equal(out, out_c.detach()), "(c) out differs from the path"
    for g, t in zip(grads, lv_c):
        assert torch.equal(padlib.pad_input(g, un[0][1], B, S), t.grad)
    o32, l32 = vl.flash_attn_varlen_fwd_ref(*args)
    o16, l16 = vl.flash_attn_varlen_fwd_ref(*args, upcast=False)
    errs, rows = {}, {}
    errs["K5"] = gated(torch, out, o32, o16, "K5 out")
    rows["K5 out"] = gated_rows(torch, out, o32, o16, "K5 out", tt.FWD_MULT)
    lse_err = gated(torch, lse, l32, l16, "K5 lse")
    # one late tile made wrong: the kernels' outputs under dropout
    big = int(np.argmax(lens_c))
    q_first = int(sum(lens_c[:big]))
    late = q_first + max(lens_c[big] - 64, 0)
    mid = q_first + lens_c[big] // 2
    wkw = dict(dropout_p=DENSE_DROPOUT, dropout_seed=SENS_SEED)
    o_w = vl.flash_attn_varlen_fwd(*args, **wkw)[0]
    wrong = [("K5 out", spliced0(out, o_w, late), o32, o16, tt.FWD_MULT,
              tt.FWD_ATOL)]
    del o32, o16, l32, l16, o_w
    g32 = vl.flash_attn_varlen_bwd_ref(*bargs)
    g16 = vl.flash_attn_varlen_bwd_ref(*bargs, upcast=False)
    for name, key, g, r32, r16 in (("K6", "dq", grads[0], g32[0], g16[0]),
                                   ("K7", "dk", grads[1], g32[1], g16[1]),
                                   ("K7", "dv", grads[2], g32[2], g16[2])):
        errs[(name, key)] = gated(torch, g, r32, r16, f"{name} {key}",
                                  tt.BWD_MULT, tt.BWD_ATOL)
        rows[f"{name} {key}"] = gated_rows(torch, g, r32, r16,
                                           f"{name} {key}", tt.BWD_MULT)
    g_w = vl.flash_attn_varlen_bwd(*bargs, **wkw)
    for (key, lo), g, gw, r32, r16 in zip(
            (("K6 dq", late), ("K7 dk", mid), ("K7 dv", late)), grads, g_w,
            g32, g16):
        wrong.append((key, spliced0(g, gw, lo), r32, r16, tt.BWD_MULT,
                      tt.BWD_ATOL))
    gate_sensitivity(torch, tt, wrong, "varlen (c)")
    del g32, g16, g_w, wrong
    again = vl.flash_attn_varlen_bwd(*bargs)
    assert all(torch.equal(a, b) for a, b in zip(grads, again)), \
        "two varlen backward calls differ"
    print(f"varlen (c) ({len(lens_c)} documents, {sum(lens_c)} tokens): max "
          f"abs err vs fp32 plain <= gate (2x / 3x the bf16 plain error + "
          f"1e-5 / 1e-4): K5 out {errs['K5'][0]:.3e} <= {errs['K5'][1]:.3e}"
          f", lse {lse_err[0]:.3e} <= {lse_err[1]:.3e}; K6 dq "
          f"{errs[('K6', 'dq')][0]:.3e} <= {errs[('K6', 'dq')][1]:.3e}; K7 "
          f"dk {errs[('K7', 'dk')][0]:.3e} <= {errs[('K7', 'dk')][1]:.3e}, "
          f"dv {errs[('K7', 'dv')][0]:.3e} <= {errs[('K7', 'dv')][1]:.3e}; "
          f"two backward calls bit-equal", flush=True)
    print("varlen (c): per-row RMS err vs fp32 plain (worst err/gate; "
          "median |ref|, median row gate): " + ", ".join(
              f"{key} {r:.3f} ({med:.3e}, {g:.3e})"
              for key, (r, med, g) in rows.items()), flush=True)
    del again, grads

    # ---- times: kernel, plain, library at (c), and at (b)
    res = {}
    for case, lens_w, qw, kw_, vw, cu_w, ms_w in (
            ("c", lens_c, qc, kc, vc, cu_c, ms_c),
            ("b", list(VARLEN_PAD_LENS), *(
                padlib.unpad_input(x[n], mask_b)[0] for n in ("q", "k", "v")),
             cu_b, ms_b)):
        args = (qw, kw_, vw, cu_w, cu_w, ms_w, ms_w, scale, params)
        out, lse = vl.flash_attn_varlen_fwd(*args)
        dow = torch.randn(qw.shape, generator=ggen, device=dev).to(qw.dtype)
        delta = vl.varlen_delta(out, dow)
        lse_c = lse.clamp_min(NEG_INF).contiguous()
        kargs = (qw, kw_, vw, dow, lse_c, delta, None, cu_w, cu_w, None,
                 None, ms_w, ms_w, scale, params, 0.0, None)
        ms = {"K5": time_ms(torch, lambda: vl.flash_attn_varlen_fwd(*args),
                            flush=flush),
              "K6": time_ms(torch, lambda: vl.varlen_dq_kernel(*kargs),
                            flush=flush),
              "K7": time_ms(torch, lambda: vl.varlen_dkv_kernel(*kargs),
                            flush=flush)}
        plain_f = plain_b = None
        if case == "c":
            plain_f = time_ms(torch, lambda: vl.flash_attn_varlen_fwd_ref(
                *args), reps=3, warmup=1, flush=flush)
            plain_b = time_ms(torch, lambda: vl.flash_attn_varlen_bwd_ref(
                qw, kw_, vw, out, dow, lse, cu_w, cu_w, ms_w, ms_w, scale,
                params), reps=3, warmup=1, flush=flush)
        ql, kl, vl_ = (t.clone().requires_grad_() for t in (qw, kw_, vw))
        label, lib_fn, o_lib = varlen_library(torch, ql, kl, vl_, cu_w, ms_w)
        lib_f = time_ms(torch, lib_fn, flush=flush)
        o_lib = o_lib[0] if isinstance(o_lib, tuple) else o_lib
        do_lib = dow if o_lib.dim() == 3 else dow.transpose(0, 1)[None]
        lib_b = time_ms(torch, lambda: torch.autograd.grad(
            o_lib, (ql, kl, vl_), do_lib, retain_graph=True), flush=flush)
        work = varlen_work(lens_w, Hq, Hk, D)
        for name, plain, lib in (("K5", plain_f, lib_f), ("K6", plain_b,
                                                          lib_b),
                                 ("K7", plain_b, lib_b)):
            flops, nbytes = work[name]
            bms, by = bound_ms(nbytes, flops)
            print(f"{name} ({case}) {len(lens_w)} sequences, {sum(lens_w)} "
                  f"tokens, {flops // (4 * D * Hq) if name == 'K5' else ''}"
                  f"{' live pairs a head, ' if name == 'K5' else ''}"
                  f"Hq={Hq} Hk={Hk} D={D} causal: kernel {ms[name]:.4f} ms"
                  f"{'' if plain is None else f', plain {plain:.4f} ms'}"
                  f"{' (dq, dk, dv together)' if name != 'K5' and plain else ''}"
                  f", {label} {'fwd' if name == 'K5' else 'bwd (K6 + K7)'} "
                  f"{lib:.4f} ms, bound {bms:.4f} ms ({by}, {flops:.3e} flop)",
                  flush=True)
            if case == "c":
                worst = max((e for k_, e in errs.items()
                             if (k_ if isinstance(k_, str) else k_[0])
                             == name), key=lambda e: e[0])
                res[name] = dict(max_abs_err=worst[0], gate=worst[1],
                                 ms=ms[name], plain_ms=plain,
                                 library_ms=lib, library=label,
                                 bound_ms=bms, bound_by=by)
            else:
                res[name]["case_b"] = dict(ms=ms[name], library_ms=lib,
                                           bound_ms=bms, bound_by=by)
        # the max_seqlen grids: blocks, and blocks that leave at once (their
        # tile lies past their sequence); 128 q rows a tile in K5, 64 in
        # K6, 64 keys in K7 (D 64)
        grids = []
        for name, rows, heads in (("K5", 128, Hq), ("K6", 64, Hq),
                                  ("K7", 64, Hk)):
            total = len(lens_w) * -(-ms_w // rows) * heads
            live = sum(-(-n // rows) for n in lens_w) * heads
            grids.append(f"{name} {total} / {total - live}")
        print(f"varlen ({case}) grids (blocks / leaving at once): "
              + ", ".join(grids), flush=True)
        del ql, kl, vl_, o_lib
    res["launches"] = counts

    # K6/K7: what a block holds and how many fit on a multiprocessor
    from flash_attn_v100_tpu_torch.ops.cuda import build
    print_occupancy(res, occupancy(build, ("K6", "K7")), D)
    return res


# ------------------------------------------------------- drop-in phase

DROPIN_TIMEOUT_S = 300
# the engine's decode step (phase_k4) and prefill wave (k8_case)
DROPIN_DECODE = dict(B=8, Hk=4, group=8, D=64, ps=128, max_pages=16)
DROPIN_PREFILL = dict(prefix=(0, 300, 0, 300), T=512, Hk=4, group=8, D=64,
                      ps=128)


def kernel_counts():
    """({K1 .. K8, "K4q kind", "K8q kind": launches}, {plain twin: calls})
    of every kernel wrapper and every plain twin."""
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    dk, pk = dec.paged_decode_attention, vl.flash_attn_varlen_fwd_paged
    launches = {"K1": dfwd.flash_attn_dense_fwd.launches,
                "K2": dbwd.dq_kernel.launches,
                "K3": dbwd.dkv_kernel.launches, "K4": dk.launches,
                "K5": vl.flash_attn_varlen_fwd.launches,
                "K6": vl.varlen_dq_kernel.launches,
                "K7": vl.varlen_dkv_kernel.launches, "K8": pk.launches}
    for kind in QUANT_KINDS:
        launches[f"K4q {kind}"] = dk.quant_launches[kind]
        launches[f"K8q {kind}"] = pk.quant_launches[kind]
    twins = {fn.__name__: fn.calls for fn in (
        dfwd.flash_attn_dense_fwd_ref, dbwd.flash_attn_dense_bwd_ref,
        dec.paged_decode_attention_ref, vl.flash_attn_varlen_fwd_ref,
        vl.flash_attn_varlen_bwd_ref, vl.flash_attn_varlen_fwd_paged_ref)}
    return launches, twins


def reset_kernel_counts():
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    for fn in (dfwd.flash_attn_dense_fwd, dbwd.dq_kernel, dbwd.dkv_kernel,
               dec.paged_decode_attention, vl.flash_attn_varlen_fwd,
               vl.varlen_dq_kernel, vl.varlen_dkv_kernel,
               vl.flash_attn_varlen_fwd_paged):
        fn.launches = 0
    for fn in (dec.paged_decode_attention, vl.flash_attn_varlen_fwd_paged):
        fn.quant_launches = {k: 0 for k in fn.quant_launches}
    for fn in (dfwd.flash_attn_dense_fwd_ref, dbwd.flash_attn_dense_bwd_ref,
               dec.paged_decode_attention_ref, vl.flash_attn_varlen_fwd_ref,
               vl.flash_attn_varlen_bwd_ref,
               vl.flash_attn_varlen_fwd_paged_ref):
        fn.calls = 0


def dropin_cache(torch, gen, ggen, B, Hk, D, ps, max_pages):
    """A contiguous bf16 cache (B, max_pages * ps, Hk, D) pair and the same
    rows as HND pools (Hk, pages, ps, D) through shuffled block tables
    (page 0 unused)."""
    dev = torch.device("cuda")
    N = max_pages * ps
    kc, vc = (torch.randn((B, N, Hk, D), generator=ggen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    n_pages = B * max_pages + 1
    perm = torch.randperm(n_pages - 1, generator=gen)[None] + 1
    tbl = perm.view(B, max_pages).to(dev, torch.int32)
    kp, vp = (x.new_zeros((Hk, n_pages, ps, D)) for x in (kc, vc))
    for pool, c in ((kp, kc), (vp, vc)):
        pool[:, tbl.reshape(-1).long()] = c.reshape(
            B * max_pages, ps, Hk, D).permute(2, 0, 1, 3)
    return kc, vc, kp, vp, tbl


def dropin_child(torch, tmp: str) -> dict:
    """Phase (a), in a fresh process: the port takes the `flash_attn` name
    and HF transformers' padded-attention pattern, flash_attn_func, one
    decode step and one paged prefill run through it at TinyLlama-1.1B's
    width, each against the fp32 oracle; returns the errors, gates and
    every kernel's launches."""
    import importlib
    import importlib.metadata
    import importlib.util

    from flash_attn_v100_tpu_torch.utils.distinfo import (
        install_canonical_name)
    install_canonical_name(tmp)
    # `import flash_attn` and `from flash_attn.bert_padding import ...`
    # through the import system: the names installed just above, which the
    # asserts below hold to the port's objects
    flash_attn = importlib.import_module("flash_attn")
    bert_padding = importlib.import_module("flash_attn.bert_padding")
    pad_input, unpad_input = bert_padding.pad_input, bert_padding.unpad_input

    from flash_attn_v100_tpu_torch.benchmarks.common import oracle
    from flash_attn_v100_tpu_torch.benchmarks.sweep_varlen import (
        packed_oracle)
    from flash_attn_v100_tpu_torch.ops import flash_attention, kvcache
    from flash_attn_v100_tpu_torch.ops import padding, varlen
    from flash_attn_v100_tpu_torch.ops.reference import (
        mha_reference_kvcache)
    from flash_attn_v100_tpu_torch.utils import testing as tt

    spec = importlib.util.find_spec("flash_attn")
    assert spec.name == "flash_attn" and spec.origin == flash_attn.__file__
    assert importlib.metadata.version("flash_attn") == "2.8.3"
    assert flash_attn.flash_attn_func is flash_attention.flash_attn_func
    assert flash_attn.flash_attn_varlen_func is varlen.flash_attn_varlen_func
    assert flash_attn.flash_attn_with_kvcache is (
        kvcache.flash_attn_with_kvcache)
    assert unpad_input is padding.unpad_input
    assert pad_input is padding.pad_input
    assert "jax" not in sys.modules, "jax imported"
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 15)
    ggen = torch.Generator(device=dev).manual_seed(SEED + 15)
    budget = torch.cuda.mem_get_info()[0] // 2
    B, S, Hq, Hk, D = DENSE_B, DENSE_S, DENSE_HQ, DENSE_HK, DENSE_D
    x = {n: torch.randn((B, S, h, D), generator=ggen, device=dev).to(
        torch.bfloat16) for n, h in (("q", Hq), ("k", Hk), ("v", Hk),
                                     ("do", Hq))}
    mask = (torch.arange(S, device=dev)[None, :]
            < torch.tensor(VARLEN_PAD_LENS, device=dev)[:, None])
    res, steps = {}, {}

    def gate_all(name, outs, refs32, refsnat, mults):
        errs = []
        for what, o, r32, rn, (mult, atol) in zip(("out", "dq", "dk", "dv"),
                                                   outs, refs32, refsnat,
                                                   mults):
            errs.append(gated(torch, o, r32, rn, f"{name} {what}", mult,
                              atol))
        res[name] = errs

    def counted(name, fn):
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches, twins = kernel_counts()
        steps[name] = dict(s=time.perf_counter() - t0, twins=twins,
                           launches={k: n for k, n in launches.items() if n})
        assert not any(twins.values()), (name, twins)
        return out

    fb = [(tt.FWD_MULT, tt.FWD_ATOL)] + [(tt.BWD_MULT, tt.BWD_ATOL)] * 3

    # HF transformers' padded pattern: unpad q, k, v -> varlen -> pad
    def hf():
        leaves = [x[n].clone().requires_grad_() for n in ("q", "k", "v")]
        qu, idx, cu, ms, _ = unpad_input(leaves[0], mask)
        ku, vu = (unpad_input(t, mask)[0] for t in leaves[1:])
        out = pad_input(flash_attn.flash_attn_varlen_func(
            qu, ku, vu, cu, cu, ms, ms, causal=True), idx, B, S)
        out.backward(x["do"])
        return out.detach(), [t.grad for t in leaves], idx
    out, grads, idx = counted("hf_padded", hf)
    assert steps["hf_padded"]["launches"] == {"K5": 1, "K6": 1, "K7": 1}
    assert not out[~mask].any() and not any(g[~mask].any() for g in grads)
    packed = [padding.index_first_axis(x[n].reshape(B * S, *x[n].shape[2:]),
                                       idx) for n in ("q", "k", "v", "do")]
    lens = list(VARLEN_PAD_LENS)
    o32, g32 = packed_oracle(*packed, lens, lens, True, budget, causal=True)
    onat, gnat = packed_oracle(*packed, lens, lens, False, budget,
                               causal=True)
    got = [padding.index_first_axis(t.reshape(B * S, *t.shape[2:]), idx)
           for t in (out, *grads)]
    gate_all("hf_padded", got, [o32, *g32], [onat, *gnat], fb)
    del o32, g32, onat, gnat, packed, got, out, grads

    # flash_attn_func at the training shape
    def dense():
        leaves = [x[n].clone().requires_grad_() for n in ("q", "k", "v")]
        out = flash_attn.flash_attn_func(*leaves, causal=True)
        out.backward(x["do"])
        return out.detach(), [t.grad for t in leaves]
    out, grads = counted("dense", dense)
    assert steps["dense"]["launches"] == {"K1": 1, "K2": 1, "K3": 1}
    o32, g32 = oracle(x["q"], x["k"], x["v"], x["do"], True, budget,
                      causal=True)
    onat, gnat = oracle(x["q"], x["k"], x["v"], x["do"], False, budget,
                        causal=True)
    gate_all("dense", [out, *grads], [o32, *g32], [onat, *gnat], fb)
    del o32, g32, onat, gnat, out, grads, x

    # one decode step from a bf16 page pool (K4), then one paged prefill of
    # 512 new tokens a row (K8): both append their new k / v
    for name, c in (("decode", DROPIN_DECODE), ("prefill", DROPIN_PREFILL)):
        Hk_, D_, ps = c["Hk"], c["D"], c["ps"]
        Hq_ = Hk_ * c["group"]
        if name == "decode":
            T, n_b = 1, c["B"]
            lens_c = torch.randint(600, 2001, (n_b,), generator=gen)
            max_pages = c["max_pages"]
        else:
            T, n_b = c["T"], len(c["prefix"])
            lens_c = torch.tensor(c["prefix"])
            max_pages = -(-(int(lens_c.max()) + T) // ps)
        kc, vc, kp, vp, tbl = dropin_cache(torch, gen, ggen, n_b, Hk_, D_,
                                           ps, max_pages)
        q, kn, vn = (torch.randn((n_b, T, h, D_), generator=ggen,
                                 device=dev).to(torch.bfloat16)
                     for h in (Hq_, Hk_, Hk_))
        cs = lens_c.to(dev, torch.int32)
        kw = dict(k_new=kn, v_new=vn, cache_seqlens=cs, causal=True)
        o32 = mha_reference_kvcache(q, kc, vc, upcast=True, **kw)[0]
        onat = mha_reference_kvcache(q, kc, vc, upcast=False, **kw)[0]
        out, (kp2, _) = counted(name, lambda: flash_attn.flash_attn_with_kvcache(
            q, kp, vp, k=kn, v=vn, cache_seqlens=cs, block_table=tbl,
            causal=True, kv_cache_layout="HND"))
        want = "K4" if name == "decode" else "K8"
        assert kvcache.uses_varlen_route(True, c["group"], T, ps) == (
            want == "K8")
        assert steps[name]["launches"] == {want: 1}, steps[name]
        assert kp2 is kp
        res[name] = [gated(torch, out, o32, onat, f"{name} out")]
    return dict(gates=res, steps=steps)


def phase_dropin(torch) -> dict:
    """(a) `dropin_child` in a fresh process (the `flash_attn` name must
    not leak into later phases; no JAX there either); (b) the hardware
    oracle suite, `hw_oracle --quick`, in this process.  Returns each
    kernel's launches over (a) and (b) together."""
    import tempfile

    from flash_attn_v100_tpu_torch.benchmarks import hw_oracle

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([sys.executable, __file__, "--dropin-child", tmp],
                           capture_output=True, text=True,
                           timeout=DROPIN_TIMEOUT_S)
    print(r.stdout, end="", flush=True)
    if r.returncode != 0:
        print(r.stderr, end="", file=sys.stderr, flush=True)
        raise RuntimeError(f"dropin (a): the child exited {r.returncode}")
    child = json.loads(r.stdout.splitlines()[-1][len("dropin-child: "):])
    t_a = time.perf_counter() - t0
    for name, errs in child["gates"].items():
        print(f"dropin (a) {name}: max abs err vs fp32 oracle <= gate: "
              + ", ".join(f"{w} {e:.3e} <= {g:.3e}" for w, (e, g) in zip(
                  ("out", "dq", "dk", "dv"), errs))
              + f"; launches {child['steps'][name]['launches']}, "
              f"plain twins {sum(child['steps'][name]['twins'].values())}, "
              f"{child['steps'][name]['s']:.3f} s", flush=True)

    torch.cuda.synchronize()
    reset_kernel_counts()
    t1 = time.perf_counter()
    fails = hw_oracle.main(quick=True)
    torch.cuda.synchronize()
    launches, twins = kernel_counts()
    assert not sum(fails.values()), f"hw_oracle --quick failed: {fails}"
    assert not any(twins.values()), twins
    total = dict(launches)
    for step in child["steps"].values():
        for k, n in step["launches"].items():
            total[k] += n
    print(f"dropin: (a) {t_a:.1f} s, (b) hw_oracle --quick "
          f"{time.perf_counter() - t1:.1f} s, every case passed; launches "
          f"over (a) and (b): {total}", flush=True)
    missing = [k for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")
               if not total[k]]
    assert not missing, f"not launched in the drop-in phase: {missing}"
    return total


# ------------------------------------------------------- training phase

TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 3
TRAIN_CHECK_B, TRAIN_CHECK_S = 1, 512
TRAIN_LOSS_GATE = ("assert_close_rel(mult=2, atol=1e-5) over the tokens: "
                   "each kernel-path token loss vs fp32-plain-attention's "
                   "within 2x the bf16-plain-attention token losses' largest "
                   "distance; the mean loss within max(2x the bf16 mean's "
                   "distance + 1e-5, 3 x std(bf16 token errors) / sqrt(n))")


def _kernel_counts(dfwd, dbwd):
    return {"K1": dfwd.flash_attn_dense_fwd.launches,
            "K2": dbwd.dq_kernel.launches, "K3": dbwd.dkv_kernel.launches,
            "plain_fwd": dfwd.flash_attn_dense_fwd_ref.calls,
            "plain_bwd": dbwd.flash_attn_dense_bwd_ref.calls}


def _reset_counts(dfwd, dbwd):
    dfwd.flash_attn_dense_fwd.launches = 0
    dbwd.dq_kernel.launches = dbwd.dkv_kernel.launches = 0
    dfwd.flash_attn_dense_fwd_ref.calls = dbwd.flash_attn_dense_bwd_ref.calls = 0


def _plain_attention(fa_mod, dfwd, dbwd, upcast):
    """Point flash_attn_func at the plain versions (fp32 or native)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = fa_mod.flash_attn_dense_fwd, fa_mod.flash_attn_dense_bwd
        fa_mod.flash_attn_dense_fwd = lambda *a, **k: \
            dfwd.flash_attn_dense_fwd_ref(*a, upcast=upcast, **k)
        fa_mod.flash_attn_dense_bwd = lambda *a, **k: \
            dbwd.flash_attn_dense_bwd_ref(*a, upcast=upcast, **k)
        try:
            yield
        finally:
            fa_mod.flash_attn_dense_fwd, fa_mod.flash_attn_dense_bwd = saved
    return ctx()


def train_tokens(torch, cfg, dev):
    """The training runs' batch: B TRAIN_B x TRAIN_S + 1 random tokens."""
    gen = torch.Generator().manual_seed(SEED)
    return torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                         generator=gen).to(dev)


def phase_train(torch, cfg):
    """Three AdamW steps of TinyLlama-1.1B at B 4 x S 2048 through K1-K3."""
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops import flash_attention as fa_mod
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.utils import testing as tt

    dev = torch.device("cuda")
    params = tm.init_params(cfg, seed=SEED, device=dev, lm_head=True)
    for t in tm.param_leaves(params):
        t.requires_grad_(True)
    tokens = train_tokens(torch, cfg, dev)
    step, init_opt = tm.make_train_step(cfg)
    opt = init_opt(params)
    n_params = sum(t.numel() for t in tm.param_leaves(params))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(dfwd, dbwd)
    losses, secs = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, tokens)
        losses.append(float(loss))            # syncs
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = _kernel_counts(dfwd, dbwd)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    L = cfg.n_layers
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
    for name in ("K1", "K2", "K3"):
        assert counts[name] == L * TRAIN_STEPS, counts
    assert counts["plain_fwd"] == 0 and counts["plain_bwd"] == 0, counts
    step_ms = statistics.median(secs[1:]) * 1e3
    tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    print(f"train: {L} layers, dim {cfg.dim}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads x {cfg.head_dim}, ffn {cfg.ffn_dim}, vocab {cfg.vocab_size}, "
          f"untied lm_head, {cfg.dtype}, {n_params / 1e9:.3f} B params; "
          f"AdamW(lr 3e-4, wd 0.01); B {TRAIN_B} x S {TRAIN_S} tokens",
          flush=True)
    print(f"train: losses {[round(x, 5) for x in losses]}, step times "
          f"{[round(x * 1e3, 1) for x in secs]} ms; step {step_ms:.1f} ms "
          f"(median of steps 2-{TRAIN_STEPS}), {tok_s:.0f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB; launches per step K1 "
          f"{counts['K1'] // TRAIN_STEPS}, K2 {counts['K2'] // TRAIN_STEPS}, "
          f"K3 {counts['K3'] // TRAIN_STEPS}; plain calls "
          f"{counts['plain_fwd']} / {counts['plain_bwd']}", flush=True)

    prof = profile_train(torch, lambda: step(params, opt, tokens))

    # layer 0's attention, captured from a forward/backward at the training
    # shape, replayed through the plain versions
    cap = replay_layer0(torch, tm, dfwd, dbwd, tt, params, tokens, cfg)

    # a small batch at full depth: each token's loss (loss_fn's terms) on
    # the kernel path against the same through the plain attention
    # versions; per token, since one bf16 reading of the mean loss is a
    # yardstick that can fall near 0 by chance
    small = tokens[:TRAIN_CHECK_B, :TRAIN_CHECK_S + 1]

    def token_losses():
        logp = torch.log_softmax(tm.forward(params, small[:, :-1], cfg),
                                 dim=-1)
        return -logp.gather(-1, small[:, 1:, None].to(torch.long))[..., 0]

    with torch.no_grad():
        loss_k = token_losses()
        with _plain_attention(fa_mod, dfwd, dbwd, True):
            loss32 = token_losses()
        with _plain_attention(fa_mod, dfwd, dbwd, False):
            loss16 = token_losses()
    err, gate = gated(torch, loss_k, loss32, loss16,
                      f"B {TRAIN_CHECK_B} x S {TRAIN_CHECK_S} token losses",
                      2.0, 1e-5)
    # the mean loss too, against a shift of every token: its gate has a
    # floor of 3 standard errors of the mean of the bf16 token errors, since
    # the bf16 mean's own distance can fall near 0 by chance
    means = [float(x.double().mean()) for x in (loss_k, loss32, loss16)]
    e16 = (loss16 - loss32).double()
    spread = 3.0 * float(e16.std()) / e16.numel() ** 0.5
    mean_err = abs(means[0] - means[1])
    mean_gate = max(2.0 * abs(means[2] - means[1]) + 1e-5, spread)
    assert mean_err <= mean_gate, (
        f"mean loss: err {mean_err:.3e} > gate {mean_gate:.3e}")
    print(f"train: B {TRAIN_CHECK_B} x S {TRAIN_CHECK_S} token losses (full "
          f"depth): max err {err:.3e} <= gate {gate:.3e}; mean kernel "
          f"{means[0]:.6f}, plain fp32 {means[1]:.6f}, plain bf16 "
          f"{means[2]:.6f}: err {mean_err:.3e} <= gate {mean_gate:.3e} "
          f"(bf16 mean's distance {abs(means[2] - means[1]):.3e}, std "
          f"{float(e16.std()):.3e} of {e16.numel()} bf16 token errors, "
          f"floor {spread:.3e}) ({TRAIN_LOSS_GATE})", flush=True)
    return dict(launches=counts, step_ms=step_ms, tokens_s=tok_s,
                peak_gb=peak_gb, losses=losses, profile=prof, replay=cap)


def replay_layer0(torch, tm, dfwd, dbwd, tt, params, tokens, cfg):
    """One forward/backward at the training shape with layer 0's attention
    inputs, output and gradients captured; the kernel results against the
    plain fp32 and bf16 versions on the same inputs."""
    real = tm.flash_attn_func
    cap = {}

    def spy(q, k, v, **kw):
        if cap:
            return real(q, k, v, **kw)
        for name, t in (("q", q), ("k", k), ("v", v)):
            cap[name] = t.detach().clone()
            t.register_hook(lambda g, name=name: cap.__setitem__(
                "d" + name, g.detach().clone()))
        out = real(q, k, v, **kw)
        cap["out"] = out.detach().clone()
        out.register_hook(lambda g: cap.__setitem__("dout",
                                                     g.detach().clone()))
        return out

    tm.flash_attn_func = spy
    try:
        tm.loss_fn(params, tokens, cfg).backward()
    finally:
        tm.flash_attn_func = real
    for t in tm.param_leaves(params):
        t.grad = None
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    scale = cfg.head_dim ** -0.5
    mp = masklib.MaskParams(causal=True)
    q, k, v, dout = cap["q"], cap["k"], cap["v"], cap["dout"]
    o32, lse32 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, mp)
    o16, lse16 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, mp,
                                               upcast=False)
    # K2 and K3 took K1's out and lse: K1 again on the captured inputs
    # gives them bit for bit (it is deterministic), and the plain backward
    # versions take the same, as in phase_dense; with each its own out, the
    # delta = rowsum(O dO) of a short row cancels to a different rounding
    out_k, lse_k = dfwd.flash_attn_dense_fwd(q, k, v, scale, mp)
    assert torch.equal(out_k, cap["out"]), "K1 is not deterministic"
    g32 = dbwd.flash_attn_dense_bwd_ref(q, k, v, out_k, dout, lse_k, scale,
                                        mp)
    g16 = dbwd.flash_attn_dense_bwd_ref(q, k, v, out_k, dout, lse_k, scale,
                                        mp, upcast=False)
    del out_k, lse_k, lse32, lse16
    # the gradients of a loss averaged over B x S tokens are tiny: the atol
    # is scaled by the largest |ref| where that is below 1 (as if dout were
    # scaled up, the check being linear in dout), and the per-row gate
    # scales with each row
    res, rows = {}, {}
    for name, r32, r16, mult, atol in (
            ("out", o32, o16, tt.FWD_MULT, tt.FWD_ATOL),
            *((n, a, b, tt.BWD_MULT, tt.BWD_ATOL)
              for n, a, b in zip(("dq", "dk", "dv"), g32, g16))):
        ref_max = float(r32.float().abs().max())
        assert ref_max > 0, f"layer 0 attention {name}: all-zero reference"
        res[name] = gated(torch, cap[name], r32, r16,
                          f"layer 0 attention {name}", mult,
                          atol * min(1.0, ref_max))
        rows[name] = gated_rows(torch, cap[name], r32, r16,
                                f"layer 0 attention {name}", mult)
    print("train: layer 0 attention replayed (q/k/v/dout captured at B "
          f"{tokens.shape[0]} x S {tokens.shape[1] - 1}); max abs err vs "
          "fp32 plain <= 2x / 3x the bf16 plain error + (1e-5 / 1e-4) x "
          "min(1, max |ref|): " + ", ".join(f"{k_} {e:.3e} <= {g:.3e}"
                                for k_, (e, g) in res.items())
          + "; per-row worst err/gate (median |ref|, median row gate): "
          + ", ".join(f"{k_} {r:.3f} ({med:.3e}, {g:.3e})"
                      for k_, (r, med, g) in rows.items()), flush=True)
    return res


def profile_train(torch, run_step, tag="train"):
    """Where a training step's time goes: `run_step()` once, then once more
    under torch.profiler (CPU + CUDA activities) through the package's
    utils.profiling, which labels the port's kernels by id; the id table
    (each port kernel's CUDA name) is printed beside."""
    import tempfile
    from flash_attn_v100_tpu_torch.utils import profiling

    walls = []

    def one():
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory(prefix="fa_trace_") as d:
        profiling.capture_trace(one, iters=1, trace_dir=d)
        rows = profiling.summarize_trace(d)
        ids = profiling.kernel_ids(d)
    wall = walls[-1]
    busy_us = sum(us for _, us, _ in rows)
    launches = sum(n for _, _, n in rows)
    by_label = {lab: us for lab, us, _ in rows}
    share = {key: by_label.get(key, 0.0) / max(busy_us, 1e-9)
             for key in ("K1", "K2", "K3")}
    res = dict(wall_ms=wall * 1e3, busy_ms=busy_us / 1e3,
               busy_share=busy_us / 1e3 / max(wall * 1e3, 1e-9),
               launches=launches, share=share)
    print(f"{tag} profile (torch.profiler, one step): wall "
          f"{res['wall_ms']:.1f} ms, device busy {res['busy_ms']:.1f} ms "
          f"({100 * res['busy_share']:.1f}%), {launches} kernel "
          f"launches; shares of device time: K1 {100 * share['K1']:.1f}%, "
          f"K2 {100 * share['K2']:.1f}%, K3 {100 * share['K3']:.1f}%",
          flush=True)
    for name, us, _ in rows[:8]:
        print(f"  {us / 1e3:9.3f} ms  {name[:90]}")
    for name, kid in sorted(ids.items(), key=lambda kv: kv[1]):
        print(f"  id {kid} <- {name}")
    return res


# ------------------------------------------------------------ engine phase

ENGINE_LOGITS_MULT, ENGINE_LOGITS_ATOL = 2.0, 1e-5
ENGINE_LOGITS_GATE = ("assert_close_rel(mult=2, atol=1e-5): kernel-path logits "
                      "vs fp32-plain-attention logits within 2x the "
                      "bf16-plain-attention logits' distance")
ENGINE_QUANT_GATE = ("assert_close_rel(mult=2, atol=1e-5): kernel-path logits "
                     "vs the plain twins' logits within 2x the distance of "
                     "the twins with P unrounded")
# the engine run: LONG prompts prefill first (K8 route), then SHORT prompts
# arrive (K4 prefill route, T bucket 64) and all decode N_NEW tokens greedily
N_LONG, LONG_LEN, SHORT_LENS, N_NEW = 6, 512, (40, 25), 32
PAGE_SIZE, NUM_PAGES = 128, 64


def _scale_clones(kw):
    return {n: (x.clone() if n in ("k_scales", "v_scales") and x is not None
                else x) for n, x in kw.items()}


def make_engine(torch, params, cfg, kind=None):
    """The engine runs' ServingEngine: a pool of payload `kind` ("int8",
    "fp8", "int4"; None: the model dtype) on the card."""
    from flash_attn_v100_tpu_torch import ServingEngine
    eng = ServingEngine(params, cfg, max_batch=N_LONG + len(SHORT_LENS),
                        num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                        device="cuda",
                        kv_dtype=None if kind is None else quant_dtype(
                            torch, kind))
    assert eng.sched.is_native, "the native scheduler must be in use"
    assert eng.quantized == (kind is not None)
    return eng


def serve_traffic(torch, eng, cfg, long_len=LONG_LEN):
    """The engine runs' traffic: N_LONG prompts of `long_len` tokens
    prefilled in one step (the K8 route), then SHORT_LENS prompts beside
    their decodes (the K4 route), N_NEW greedy tokens each.  Returns (the
    outputs, the request ids, the host clock at submit / after the second
    step / at the end, the tokens generated at the last two)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    long_prompts = [rng.integers(1, cfg.vocab_size, long_len).tolist()
                    for _ in range(N_LONG)]
    short_prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                     for n in SHORT_LENS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=N_NEW) for p in long_prompts]
    eng.step()                           # 6 x 512-token prefill: K8 route
    rids += [eng.submit(p, max_new_tokens=N_NEW) for p in short_prompts]
    eng.step()                           # short prefills (K4) + 6 decodes
    torch.cuda.synchronize()
    t_a, tok_a = time.perf_counter(), eng.metrics["tokens_generated"]
    out = eng.run_to_completion()
    torch.cuda.synchronize()
    t_b, tok_b = time.perf_counter(), eng.metrics["tokens_generated"]
    return out, rids, (t0, t_a, t_b), (tok_a, tok_b)


def phase_engine(torch, cfg, kind=None):
    """ServingEngine at `cfg` through both kernels (K4q / K8q over a pool
    of payload `kind` "int8", "fp8" or "int4"; None: the model dtype's
    K4 / K8); the first prefill step of each route is replayed with the
    plain attention versions."""
    import functools
    from flash_attn_v100_tpu_torch.models.transformer import init_params
    from flash_attn_v100_tpu_torch.ops import kvcache as kv_mod
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    from flash_attn_v100_tpu_torch.runtime import engine as eng_mod

    params = init_params(cfg, seed=SEED, device="cuda", lm_head=True)
    eng = make_engine(torch, params, cfg, kind)
    tag = "engine" if kind is None else f"engine {kind}"

    # capture the first prefill (T > 1) step of each route: the pools
    # (and scales) before it, its inputs and its logits
    real_pf = eng_mod.paged_forward
    cap = {}

    def spy(params_, k_pool, v_pool, tokens, cs, bt, cfg_, **kw):
        rows = (k_pool if kw.get("k_scales") is None
                else kw["k_scales"]).shape[2]
        route = eng_mod._route(cfg_, tokens.shape[1], rows)
        if route in cap or tokens.shape[1] == 1:
            return real_pf(params_, k_pool, v_pool, tokens, cs, bt, cfg_, **kw)
        c = cap[route] = dict(k=k_pool.clone(), v=v_pool.clone(),
                              kw=_scale_clones(kw),
                              args=(tokens.clone(), cs.clone(), bt.clone()))
        out = real_pf(params_, k_pool, v_pool, tokens, cs, bt, cfg_, **kw)
        c["logits"] = out[0].clone()
        return out

    def counts():
        return serving_counts(kind)[0]

    twins = (dec.paged_decode_attention_ref, vl.flash_attn_varlen_fwd_paged_ref)
    reset_serving_counts()
    eng_mod.paged_forward = spy
    try:
        out, rids, (t0, t_a, t_b), (tok_a, tok_b) = serve_traffic(
            torch, eng, cfg)
    finally:
        eng_mod.paged_forward = real_pf
    launches, twin_calls, other = serving_counts(kind)
    calls = dict(eng_mod.paged_forward.calls)

    assert sorted(out) == sorted(rids), "every request must finish"
    for rid in rids:
        toks = out[rid]
        assert len(toks) == N_NEW, (rid, len(toks))
        assert all(0 <= t < cfg.vocab_size for t in toks)
    L = cfg.n_layers
    for route in ("decode", "varlen"):
        assert calls[route] > 0 and launches[route] > 0, (calls, launches)
        assert launches[route] == L * calls[route], (route, launches, calls)
    assert twin_calls == [0, 0], f"plain twins called: {twin_calls}"
    assert other == 0, f"{other} launches of another payload's kernels"
    assert sorted(cap) == ["decode", "varlen"], sorted(cap)

    # each captured prefill step again, with the plain attention versions
    def replay(c, decode_fn, varlen_fn):
        def merged(*a, **k):   # the K4 route's merged entry from partials
            o, lse = dec.merge_partials(*decode_fn(*a, **k))
            return o.to(a[0].dtype), lse
        saved = (kv_mod.paged_decode_attention_merged,
                 kv_mod.flash_attn_varlen_fwd_paged)
        kv_mod.paged_decode_attention_merged = merged
        kv_mod.flash_attn_varlen_fwd_paged = varlen_fn
        try:
            return real_pf(params, c["k"].clone(), c["v"].clone(),
                           *c["args"], cfg, **_scale_clones(c["kw"]))[0]
        finally:
            (kv_mod.paged_decode_attention_merged,
             kv_mod.flash_attn_varlen_fwd_paged) = saved

    # the yardstick: 16-bit pools, products in bf16; quantized pools, P
    # left unrounded
    yard = dict(upcast=False) if kind is None else dict(round_p=False)
    errs, first = {}, {}
    for route in ("varlen", "decode"):
        c = cap[route]
        plain = replay(c, *twins)
        plain_y = replay(c, *(functools.partial(t, **yard) for t in twins))
        logits = c["logits"]
        assert logits.shape == plain.shape and torch.isfinite(logits).all()
        err, gate = gated(torch, logits, plain, plain_y,
                          f"{tag}: first {route}-route prefill logits",
                          ENGINE_LOGITS_MULT, ENGINE_LOGITS_ATOL)
        errs[route] = err
        if route == "varlen":   # the first prefill step, its real rows
            first = {n: t[:N_LONG].cpu() for n, t in (
                ("logits", logits), ("plain", plain), ("plain_y", plain_y))}
        tokens = c["args"][0]
        print(f"{tag}: first {route}-route prefill (tokens "
              f"{tuple(tokens.shape)}) logits max_abs_err {err:.4e} <= gate "
              f"{gate:.4e} vs the plain versions ("
              f"{ENGINE_LOGITS_GATE if kind is None else ENGINE_QUANT_GATE})")
    assert launches == counts(), "the replays launched a kernel"

    pool_bytes = sum(t.numel() * t.element_size() for t in (
        eng.k_pool, eng.v_pool, eng.k_scales, eng.v_scales) if t is not None)
    ttfts = [eng.ttft(r) for r in rids]
    ttft_p50_ms = statistics.median(ttfts) * 1e3
    decode_tok_s = (tok_b - tok_a) / (t_b - t_a)
    print(f"{tag}: {cfg.n_layers} layers, dim {cfg.dim}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.head_dim}, {cfg.dtype}, untied "
          f"lm_head, KV pool {eng.k_pool.dtype}"
          f"{' (int4-packed)' if eng.kv_int4 else ''} {pool_bytes} bytes "
          f"with scales; {len(rids)} requests ({N_LONG} x {LONG_LEN} + "
          f"{list(SHORT_LENS)} prompt tokens, {N_NEW} new each, greedy), "
          f"max_batch {eng.max_batch}, page_size {PAGE_SIZE}")
    print(f"{tag}: forward calls {calls}, kernel launches {launches}, plain "
          f"twin calls {twin_calls}")
    print(f"{tag}: TTFT p50 {ttft_p50_ms:.2f} ms (first-wave "
          f"{statistics.median(ttfts[:N_LONG]) * 1e3:.2f} ms, second-wave "
          f"{statistics.median(ttfts[N_LONG:]) * 1e3:.2f} ms), steady decode "
          f"{decode_tok_s:.1f} tok/s ({tok_b - tok_a} tokens in "
          f"{t_b - t_a:.3f} s), total {t_b - t0:.3f} s", flush=True)
    prof = profile_decode(torch, eng, cfg)
    return dict(launches=launches, ttft_p50_ms=ttft_p50_ms,
                decode_tok_s=decode_tok_s, logits_err=errs, profile=prof,
                pool_bytes=pool_bytes, tokens=[out[r] for r in rids],
                first_prefill=first)


# ------------------------------------------- head dim 256 on the main path

# Gemma-2B's published attention and model widths (google/gemma-2b
# config.json: hidden_size 2048, num_attention_heads 8, num_key_value_heads
# 1, head_dim 256, intermediate_size 16384, vocab_size 256000, 18 layers,
# rms_norm_eps 1e-6) on the repo's Llama body (models/transformer.py): no
# GeGLU, tied embeddings or embedding scale; random seeded weights
D256_TRAIN_LAYERS, D256_TRAIN_STEPS = 2, 2


def gemma_2b_config(torch):
    from flash_attn_v100_tpu_torch import ModelConfig
    return ModelConfig(vocab_size=256000, dim=2048, n_layers=18, n_heads=8,
                       n_kv_heads=1, head_dim=256, ffn_dim=16384,
                       rope_theta=10000.0, max_seq_len=8192, norm_eps=1e-6,
                       dtype=torch.bfloat16)


def head_dim_train(torch, cfg, tag):
    """Step 1's per-token losses and gradients of `cfg` at B TRAIN_B x
    TRAIN_S through K1-K3 against the same through the plain attention in
    fp32 and bf16 (phase_train's loss gates; each leaf's gradient within
    `gated`'s backward gate, 3 x the bf16 plain one's distance + 1e-4),
    then D256_TRAIN_STEPS AdamW steps from the counters at 0: each of K1,
    K2, K3 launched n_layers times a step, the plain versions never."""
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops import flash_attention as fa_mod
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.utils import testing as tt

    dev = torch.device("cuda")
    params = tm.init_params(cfg, seed=SEED, device=dev, lm_head=True)
    leaves = tm.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tokens = train_tokens(torch, cfg, dev)
    names = ["embed", "ln_f", "lm_head"] + [
        f"layer {i} {k}" for i, lp in enumerate(params["layers"])
        for k in sorted(lp)]
    assert len(names) == len(leaves)

    def losses_grads():
        logits = tm.forward(params, tokens[:, :-1], cfg)
        logp = torch.log_softmax(logits, dim=-1)
        del logits
        nll = -logp.gather(-1, tokens[:, 1:, None].to(torch.long))[..., 0]
        del logp
        grads = torch.autograd.grad(nll.mean(), leaves)
        return nll.detach(), grads

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(dfwd, dbwd)
    nll_k, g_k = losses_grads()
    counts = _kernel_counts(dfwd, dbwd)
    L = cfg.n_layers
    assert [counts[n] for n in ("K1", "K2", "K3")] == [L] * 3, counts
    with _plain_attention(fa_mod, dfwd, dbwd, True):
        nll32, g32 = losses_grads()
    with _plain_attention(fa_mod, dfwd, dbwd, False):
        nll16, g16 = losses_grads()
    err, gate = gated(torch, nll_k, nll32, nll16, f"{tag} step 1 token losses",
                      2.0, 1e-5)
    means = [float(x.double().mean()) for x in (nll_k, nll32, nll16)]
    e16 = (nll16 - nll32).double()
    spread = 3.0 * float(e16.std()) / e16.numel() ** 0.5
    mean_err = abs(means[0] - means[1])
    mean_gate = max(2.0 * abs(means[2] - means[1]) + 1e-5, spread)
    assert mean_err <= mean_gate, (
        f"{tag} step 1 loss: err {mean_err:.3e} > gate {mean_gate:.3e}")
    worst = (0.0, "")
    for name, a, r32, r16 in zip(names, g_k, g32, g16):
        e, gt = gated(torch, a, r32, r16, f"{tag} step 1 grad {name}",
                      tt.BWD_MULT, tt.BWD_ATOL)
        worst = max(worst, (e / gt, name))
    del g_k, g32, g16, nll32, nll16, e16
    print(f"{tag} train step 1 (B {TRAIN_B} x S {TRAIN_S}): token losses max "
          f"err {err:.3e} <= gate {gate:.3e}; mean kernel {means[0]:.6f}, "
          f"plain fp32 {means[1]:.6f}, plain bf16 {means[2]:.6f}: err "
          f"{mean_err:.3e} <= gate {mean_gate:.3e} ({TRAIN_LOSS_GATE}); "
          f"{len(names)} gradients within 3 x the bf16 plain error + 1e-4, "
          f"worst err/gate {worst[0]:.3f} ({worst[1]})", flush=True)

    step, init_opt = tm.make_train_step(cfg)
    opt = init_opt(params)
    torch.cuda.synchronize()
    _reset_counts(dfwd, dbwd)
    losses, secs = [], []
    for _ in range(D256_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, tokens)
        losses.append(float(loss))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = _kernel_counts(dfwd, dbwd)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert all(math.isfinite(x) for x in losses), losses
    for name in ("K1", "K2", "K3"):
        assert counts[name] == L * D256_TRAIN_STEPS, counts
    assert counts["plain_fwd"] == 0 and counts["plain_bwd"] == 0, counts
    n_params = sum(t.numel() for t in leaves)
    print(f"{tag} train: {L} layers, dim {cfg.dim}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, ffn "
          f"{cfg.ffn_dim}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
          f"params; AdamW, B {TRAIN_B} x S {TRAIN_S} (batch not cut); losses "
          f"{[round(x, 5) for x in losses]} (step 1's mean above "
          f"{means[0]:.5f}), step times {[round(x * 1e3, 1) for x in secs]} "
          f"ms, peak memory {peak_gb:.2f} GB; launches K1 {counts['K1']}, K2 "
          f"{counts['K2']}, K3 {counts['K3']}; plain calls "
          f"{counts['plain_fwd']} / {counts['plain_bwd']}", flush=True)
    return dict(launches=counts, losses=losses, step_ms=secs[-1] * 1e3,
                peak_gb=peak_gb, loss_err=mean_err, loss_gate=mean_gate,
                grad_worst=worst)


def head_dim_serve(torch, cfg, tag, long_len=LONG_LEN):
    """`serve_traffic` on `cfg` at full depth (the K8 route's prefill wave,
    then K4 decodes), every forward call of the run replayed on copies of
    its pools through the plain attention versions: each call's logits
    within phase_engine's gate (2 x the bf16-product plain run's error vs
    the fp32 one + 1e-5), and each served greedy token a greedy token of
    the plain run within that gate (its plain logit at most the gate below
    the plain maximum, so a near-tie may fall either way); the long
    prompts of `long_len` tokens.  Launch counts
    of the run itself: K4 / K8 n_layers a forward call of their route, the
    plain twins never."""
    import functools
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops import kvcache as kv_mod
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    from flash_attn_v100_tpu_torch.runtime import engine as eng_mod

    params = tm.init_params(cfg, seed=SEED, device="cuda", lm_head=True)
    n_params = sum(t.numel() for t in tm.param_leaves(params))
    eng = make_engine(torch, params, cfg)
    real_pf = eng_mod.paged_forward
    twins = (dec.paged_decode_attention_ref, vl.flash_attn_varlen_fwd_paged_ref)
    calls = {"decode": 0, "varlen": 0}
    own = {"launches": {"decode": 0, "varlen": 0}, "twins": [0, 0]}
    worst = {"decode": (0.0, 0.0), "varlen": (0.0, 0.0)}

    def replay(k, v, args, kw, decode_fn, varlen_fn):
        def merged(*a, **k_):
            o, lse = dec.merge_partials(*decode_fn(*a, **k_))
            return o.to(a[0].dtype), lse
        saved = (kv_mod.paged_decode_attention_merged,
                 kv_mod.flash_attn_varlen_fwd_paged)
        kv_mod.paged_decode_attention_merged = merged
        kv_mod.flash_attn_varlen_fwd_paged = varlen_fn
        try:
            return real_pf(params, k.clone(), v.clone(), *args, cfg,
                           **kw)[0]
        finally:
            (kv_mod.paged_decode_attention_merged,
             kv_mod.flash_attn_varlen_fwd_paged) = saved

    def spy(params_, k_pool, v_pool, tokens, cs, bt, cfg_, **kw):
        route = eng_mod._route(cfg_, tokens.shape[1], k_pool.shape[2])
        k0, v0 = k_pool.clone(), v_pool.clone()
        args = (tokens.clone(), cs.clone(), bt.clone())
        before = serving_counts()
        out = real_pf(params_, k_pool, v_pool, tokens, cs, bt, cfg_, **kw)
        after = serving_counts()
        for r in own["launches"]:
            own["launches"][r] += after[0][r] - before[0][r]
        own["twins"] = [a + y - x for a, x, y in
                        zip(own["twins"], before[1], after[1])]
        calls[route] += 1
        logits = out[0].float()
        plain = replay(k0, v0, args, kw, *twins).float()
        plain_y = replay(k0, v0, args, kw, *(functools.partial(
            t, upcast=False) for t in twins)).float()
        assert torch.isfinite(logits).all(), "non-finite served logits"
        err, gate = gated(torch, logits, plain, plain_y,
                          f"{tag} engine {route} call {calls[route]} logits",
                          ENGINE_LOGITS_MULT, ENGINE_LOGITS_ATOL)
        chosen = plain.gather(-1, logits.argmax(-1, keepdim=True))[..., 0]
        margin = float((plain.amax(-1) - chosen).max())
        assert margin <= gate, (
            f"{tag} engine {route} call {calls[route]}: a served token's "
            f"plain logit {margin:.3e} below the plain maximum > gate "
            f"{gate:.3e}")
        worst[route] = max(worst[route], (err / gate, margin / gate))
        return out

    reset_serving_counts()
    eng_mod.paged_forward = spy
    try:
        out, rids, (t0, t_a, t_b), (tok_a, tok_b) = serve_traffic(
            torch, eng, cfg, long_len)
    finally:
        eng_mod.paged_forward = real_pf
    assert sorted(out) == sorted(rids), "every request must finish"
    for rid in rids:
        assert len(out[rid]) == N_NEW, (rid, len(out[rid]))
    L = cfg.n_layers
    for route in ("decode", "varlen"):
        assert calls[route] > 0, calls
        assert own["launches"][route] == L * calls[route], (route, own, calls)
    assert own["twins"] == [0, 0], f"plain twins called: {own['twins']}"
    print(f"{tag} engine: {L} layers, dim {cfg.dim}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.head_dim}, ffn {cfg.ffn_dim}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, untied lm_head, {n_params / 1e9:.3f}"
          f" B params (not cut); {len(rids)} requests ({N_LONG} x {long_len} "
          f"+ {list(SHORT_LENS)} prompt tokens, {N_NEW} greedy tokens each), "
          f"max_batch {eng.max_batch}, page {PAGE_SIZE}; forward calls "
          f"{calls}, launches {own['launches']}, plain twin calls "
          f"{own['twins']}; every call's logits vs the plain replays: worst "
          f"err/gate decode {worst['decode'][0]:.3f}, varlen "
          f"{worst['varlen'][0]:.3f} ({ENGINE_LOGITS_GATE}); served tokens' "
          f"plain-logit shortfall / gate: decode {worst['decode'][1]:.3f}, "
          f"varlen {worst['varlen'][1]:.3f}; TTFT p50 "
          f"{statistics.median([eng.ttft(r) for r in rids]) * 1e3:.1f} ms "
          f"(with the replays)", flush=True)
    return dict(launches=own["launches"], calls=calls, worst=worst)


def phase_d256(torch):
    """The repo's Llama body at Gemma-2B's widths (head dim 256): training
    (head_dim_train, cut to D256_TRAIN_LAYERS layers) through K1-K3 at D
    256, then serving at full depth (head_dim_serve) through K8 and K4 at D
    256."""
    cfg = gemma_2b_config(torch)
    train = head_dim_train(torch, dataclasses.replace(
        cfg, n_layers=D256_TRAIN_LAYERS), "d256")
    gc.collect()
    torch.cuda.empty_cache()
    serve = head_dim_serve(torch, cfg, "d256")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(train=train, serve=serve)


def reset_serving_counts():
    """Zero the serving kernels' launch counters (K4, K8 and each payload's
    K4q / K8q), their plain twins' call counters and paged_forward's
    calls per route."""
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    from flash_attn_v100_tpu_torch.runtime import engine as eng_mod
    dec.paged_decode_attention.launches = 0
    vl.flash_attn_varlen_fwd_paged.launches = 0
    for k in QUANT_KINDS:
        dec.paged_decode_attention.quant_launches[k] = 0
        vl.flash_attn_varlen_fwd_paged.quant_launches[k] = 0
    dec.paged_decode_attention_ref.calls = 0
    vl.flash_attn_varlen_fwd_paged_ref.calls = 0
    eng_mod.paged_forward.calls.update(decode=0, varlen=0)


def serving_counts(kind=None):
    """({"decode": K4 (K4q of payload `kind`) launches, "varlen": K8 (K8q)
    launches}, [the plain twins' calls], the launches of any other
    payload's kernels) since reset_serving_counts."""
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    dk, vk = dec.paged_decode_attention, vl.flash_attn_varlen_fwd_paged
    if kind is None:
        launches = {"decode": dk.launches, "varlen": vk.launches}
    else:
        launches = {"decode": dk.quant_launches[kind],
                    "varlen": vk.quant_launches[kind]}
    every = (dk.launches + vk.launches + sum(dk.quant_launches.values())
             + sum(vk.quant_launches.values()))
    twin_calls = [dec.paged_decode_attention_ref.calls,
                  vl.flash_attn_varlen_fwd_paged_ref.calls]
    return launches, twin_calls, every - sum(launches.values())


def phase_engine_quant(torch, cfg, bf16):
    """phase_engine once per quantized payload kind; `bf16` is the 16-bit
    run's result, whose pool bytes, TTFT and decode rate are printed
    beside (pool bytes: payload + scales, 2 (D + 4) / (2 D) of bf16's for
    int8 / fp8, 2 (D / 2 + 4) / (2 D) for int4)."""
    D = cfg.head_dim
    res = {}
    for kind in QUANT_KINDS:
        r = res[kind] = phase_engine(torch, cfg, kind)
        torch.cuda.empty_cache()
        want = ((D // 2 if kind == "int4" else D) + 4) / (2 * D)
        ratio = r["pool_bytes"] / bf16["pool_bytes"]
        assert abs(ratio - want) < 1e-12, (kind, ratio, want)
        print(f"engine {kind} vs bf16: pool bytes {ratio:.4f}x (expected "
              f"{want:.4f}), TTFT p50 {r['ttft_p50_ms']:.2f} vs "
              f"{bf16['ttft_p50_ms']:.2f} ms, decode {r['decode_tok_s']:.1f} "
              f"vs {bf16['decode_tok_s']:.1f} tok/s, device busy "
              f"{r['profile']['busy_ms_per_step']:.3f} vs "
              f"{bf16['profile']['busy_ms_per_step']:.3f} ms per decode step",
              flush=True)
    return res


# ------------------------------------------------------------ parallel phase

# The sharded paths (flash_attn_v100_tpu_torch/parallel/) run as SPMD ranks:
# PAR_WORLD processes on the one card, joined by gloo (NCCL refuses two ranks
# on one device); every time measured here is of four processes sharing one
# card, and a collective's time is gloo's through the host, no measure of a
# multi-card system.
# ---------------------------------------------------------------- fp32

TF32_OPS_PER_S = 494.7e12     # H100 SXM dense TF32 tensor-core peak: the
                              # fp32 bound's operations rate
FFMA_OPS_PER_S = 66.9e12      # H100 SXM fp32 FMA on the CUDA cores: the
                              # ceiling of an fp32 body on FFMA
SPLIT_OPS_PER_S = TF32_OPS_PER_S / 3   # 3 x TF32 split products: the
                              # ceiling of K1's, K2's and K3's fp32 bodies
FP32_D128 = (1, 4096, 32, 32, 128)   # K1 / K3 fp32 beside the fair SDPA at
                              # B 1 x 4096^2, 32/32 heads x 128, causal
# the fp32 bodies (csrc/f32_tiles.cuh): id -> (library, the kernel's name
# at head dim {D} as cu++filt prints it, the head dims on wgmma); K1's
# body on TF32 wgmma at D 32-128, K2's at D 32 / 64, TF32 mma.sync at the
# others, in K3's and in K4's (the decode body's fp32 instantiation, T
# float and KIND kK32 = 4, at 16 and 64 q rows a block)
_K4_F32 = "decode_kernel<float, (int){D}, (int)4, (int){rows}, (int)0>"
F32_TF32_KERNELS = {
    "K1": ("fwd_f32", "fwd_f32_kernel<(int){D}, (int)0>", (32, 64, 128)),
    "K5": ("fwd_f32", "fwd_f32_kernel<(int){D}, (int)1>", (32, 64, 128)),
    "K8": ("fwd_f32", "fwd_f32_kernel<(int){D}, (int)2>", (32, 64, 128)),
    "K2": ("bwd_f32", "dq_f32_kernel<(int){D}, (bool)0>", (32, 64)),
    "K6": ("bwd_f32", "dq_f32_kernel<(int){D}, (bool)1>", (32, 64)),
    "K3": ("bwd_f32", "dkv_f32_kernel<(int){D}, (bool)0>", ()),
    "K7": ("bwd_f32", "dkv_f32_kernel<(int){D}, (bool)1>", ()),
    "K4": ("decode_f32", _K4_F32.replace("{rows}", "16"), ()),
    "K4 rows 64": ("decode_f32", _K4_F32.replace("{rows}", "64"), ())}
F32_SASS_OPS = {"hgmma_tf32": ("HGMMA.", ".TF32"),
                "hmma_tf32": ("HMMA.", ".TF32"), "ffma": ("FFMA",)}
F32_FFMA_MAX = 500            # FFMA of a body on the tensor cores: the
                              # score pass's only (the FFMA product loops of
                              # K2's old body gave 627-987)
FP32_GATES = {"fwd": (2.0, 1e-5), "bwd": (3.0, 1e-4)}
FP32_GATE = ("err vs the fp64 oracle <= 2 x the fp32 plain twin's + 1e-5 "
             "(out, LSE), 3 x + 1e-4 (gradients)")
FP32_PATH_ATOL = 1e-4         # kernel path vs plain path: loss, gradients,
                              # engine logits (the twins are the fp32 oracle)
FP32_TRAIN_B = 4              # cut to 2 if the activations do not fit
FP32_K4_GRAPH_REPS = 5        # graph replays of one K4 fp32 launch
FP32_LAYERS = 8               # TinyLlama-1.1B's 22 cut for the time limit


def attn64(torch, q, k, v, valid, scale, do=None):
    """The fp64 oracle of one slice: q (H, M, D) against k/v (1 or H, N,
    D) under `valid` (broadcast to (H, M, N)); returns (out, lse, grads or
    None), dk/dv summed over the heads that share them."""
    leaves = [x.double().requires_grad_(do is not None) for x in (q, k, v)]
    with torch.set_grad_enabled(do is not None):
        qd, kd, vd = leaves
        H = qd.shape[0]
        s = (qd @ kd.expand(H, -1, -1).transpose(1, 2)) * scale
        s = s.masked_fill(~valid, float("-inf"))
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = (p @ vd.expand(H, -1, -1)) / torch.where(l == 0,
                                                     torch.ones_like(l), l)
        lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                          m + torch.log(l))[..., 0]
        grads = (None if do is None
                 else torch.autograd.grad(o, leaves, do.double()))
    return o.detach(), lse.detach(), grads


def gate64(torch, name, got, twin, ref, kind):
    """The fp32 gate: got's max abs error against the fp64 oracle `ref`
    within FP32_GATES[kind] of the fp32 plain twin's; -inf entries (rows
    with no live key) must match exactly."""
    mult, atol = FP32_GATES[kind]
    got, twin = got.double(), twin.double()
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(got)), f"{name}: -inf rows differ"
    e = float((got[fin] - ref[fin]).abs().max()) if fin.any() else 0.0
    et = float((twin[fin] - ref[fin]).abs().max()) if fin.any() else 0.0
    gate = mult * et + atol
    assert e <= gate, f"{name}: err {e:.3e} > gate {gate:.3e} ({FP32_GATE})"
    return dict(err=e, twin_err=et, gate=gate,
                vs_twin=float((got[fin] - twin[fin]).abs().max())
                if fin.any() else 0.0)


def dense_oracle64(torch, q, k, v, do, scale):
    """attn64 over (batch row, kv head) slices of a causal dense call:
    (out (B, M, Hq, D), lse (B, Hq, M), (dq, dk, dv))."""
    B, M, Hq, D = q.shape
    N, Hk = k.shape[1], k.shape[2]
    g = Hq // Hk
    dev = q.device
    valid = (torch.arange(N, device=dev)[None, :]
             <= torch.arange(M, device=dev)[:, None] + (N - M))
    out = torch.empty(q.shape, dtype=torch.float64, device=dev)
    lse = torch.empty((B, Hq, M), dtype=torch.float64, device=dev)
    grads = [torch.empty(x.shape, dtype=torch.float64, device=dev)
             for x in (q, k, v)]
    for b in range(B):
        for h in range(Hk):
            hq = slice(h * g, (h + 1) * g)
            o, l, gr = attn64(
                torch, q[b, :, hq].transpose(0, 1),
                k[b, :, h:h + 1].transpose(0, 1),
                v[b, :, h:h + 1].transpose(0, 1), valid, scale,
                do[b, :, hq].transpose(0, 1))
            out[b, :, hq] = o.transpose(0, 1)
            lse[b, hq] = l
            for dst, x, hs in zip(grads, gr, (hq, slice(h, h + 1),
                                              slice(h, h + 1))):
                dst[b, :, hs] = x.transpose(0, 1)
    return out, lse, grads


def fp32_dense(torch, B, S, Hq, Hk, D, seed):
    """K1-K3 on fp32 inputs (causal) against their plain twins and the
    fp64 oracle; returns the gates, the launches and the inputs."""
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, h, D), generator=gen, device=dev)
                   for h in (Hq, Hk, Hk, Hq))
    scale, params = D ** -0.5, masklib.MaskParams(causal=True)
    _reset_counts(dfwd, dbwd)
    out, lse = dfwd.flash_attn_dense_fwd(q, k, v, scale, params)
    grads = dbwd.flash_attn_dense_bwd(q, k, v, out, do, lse, scale, params)
    torch.cuda.synchronize()
    counts = _kernel_counts(dfwd, dbwd)
    assert (counts["K1"], counts["K2"], counts["K3"], counts["plain_fwd"],
            counts["plain_bwd"]) == (1, 1, 1, 0, 0), counts
    assert out.dtype == lse.dtype == torch.float32
    o_t, lse_t = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params)
    g_t = dbwd.flash_attn_dense_bwd_ref(q, k, v, o_t, do, lse_t, scale,
                                        params)
    o64, lse64, g64 = dense_oracle64(torch, q, k, v, do, scale)
    tag = f"fp32 B {B} x {S}, {Hq}/{Hk} x {D}"
    res = {"K1": gate64(torch, f"K1 {tag} out", out, o_t, o64, "fwd"),
           "K1 lse": gate64(torch, f"K1 {tag} lse", lse, lse_t, lse64,
                            "fwd")}
    for name, g, gt, gr in zip(("K2 dq", "K3 dk", "K3 dv"), grads, g_t, g64):
        res[name] = gate64(torch, f"{name} {tag}", g, gt, gr, "bwd")
    print(f"fp32 K1-K3 {tag} causal: " + ", ".join(
        f"{n} err {r['err']:.3e} (twin {r['twin_err']:.3e}, gate "
        f"{r['gate']:.3e}, vs twin {r['vs_twin']:.3e})"
        for n, r in res.items()), flush=True)
    return res, (q, k, v, do, out, lse, scale, params)


def fp32_varlen(torch, B, S, Hq, Hk, D):
    """K5-K7 on fp32 inputs through flash_attn_varlen_func at
    phase_varlen's packed documents (c), forward and backward, against the
    plain twins and the fp64 oracle (per document); returns the gates, the
    launches and the inputs."""
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    lens = [n for row in packed_doc_lengths(B, S, SEED) for n in row]
    T = sum(lens)
    cu = torch.tensor([0] + lens, device=dev).cumsum(0).to(torch.int32)
    ms = max(lens)
    q, k, v, do = (torch.randn((T, h, D), generator=gen, device=dev)
                   for h in (Hq, Hk, Hk, Hq))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    vl.flash_attn_varlen_fwd.launches = 0
    vl.varlen_dq_kernel.launches = vl.varlen_dkv_kernel.launches = 0
    vl.flash_attn_varlen_fwd_ref.calls = vl.flash_attn_varlen_bwd_ref.calls = 0
    out = flash_attn_varlen_func(*leaves, cu, cu, ms, ms, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    counts = _varlen_counts(vl)
    launches = {n: counts[n] for n in ("K5", "K6", "K7")}
    assert launches == {"K5": 1, "K6": 1, "K7": 1}, launches
    assert counts["plain_fwd"] == counts["plain_bwd"] == 0, counts
    scale, params = D ** -0.5, masklib.MaskParams(causal=True)
    args = (q, k, v, cu, cu, ms, ms, scale, params)
    o_t, lse_t = vl.flash_attn_varlen_fwd_ref(*args)
    g_t = vl.flash_attn_varlen_bwd_ref(q, k, v, o_t, do, lse_t, cu, cu, ms,
                                       ms, scale, params)
    g = Hq // Hk
    o64 = torch.empty(q.shape, dtype=torch.float64, device=dev)
    g64 = [torch.empty(x.shape, dtype=torch.float64, device=dev)
           for x in (q, k, v)]
    at = 0
    for n in lens:
        valid = (torch.arange(n, device=dev)[None, :]
                 <= torch.arange(n, device=dev)[:, None])
        rows = slice(at, at + n)
        for h in range(Hk):
            hq = slice(h * g, (h + 1) * g)
            o, _, gr = attn64(torch, q[rows, hq].transpose(0, 1),
                              k[rows, h:h + 1].transpose(0, 1),
                              v[rows, h:h + 1].transpose(0, 1), valid,
                              scale, do[rows, hq].transpose(0, 1))
            o64[rows, hq] = o.transpose(0, 1)
            for dst, x, hs in zip(g64, gr, (hq, slice(h, h + 1),
                                            slice(h, h + 1))):
                dst[rows, hs] = x.transpose(0, 1)
        at += n
    tag = f"fp32 {len(lens)} packed documents, {T} tokens"
    res = {"K5": gate64(torch, f"K5 {tag} out", out.detach(), o_t, o64,
                        "fwd")}
    for name, x, gt, gr in zip(("K6 dq", "K7 dk", "K7 dv"), leaves, g_t,
                               g64):
        res[name] = gate64(torch, f"{name} {tag}", x.grad, gt, gr, "bwd")
    print(f"fp32 K5-K7 {tag} (flash_attn_varlen_func, {Hq}/{Hk} x {D}, "
          f"causal): " + ", ".join(
              f"{n} err {r['err']:.3e} (twin {r['twin_err']:.3e}, gate "
              f"{r['gate']:.3e})" for n, r in res.items()), flush=True)
    return res, launches, (q, k, v, do, cu, ms, lens, scale, params)


def fp32_k8(torch):
    """K8 on fp32 at k8_case's engine prefill wave against its twin and
    the fp64 oracle over the gathered cache."""
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    (B, T, Hq, Hk, D, ps), prefix, seqlens, q, kp, vp, tail, _ = k8_case(
        torch, torch.float32)
    twins0 = vl.flash_attn_varlen_fwd_paged_ref.calls
    n0 = vl.flash_attn_varlen_fwd_paged.launches
    out, lse = vl.flash_attn_varlen_fwd_paged(q, kp, vp, *tail)
    torch.cuda.synchronize()
    assert vl.flash_attn_varlen_fwd_paged.launches == n0 + 1
    assert vl.flash_attn_varlen_fwd_paged_ref.calls == twins0
    o_t, lse_t = vl.flash_attn_varlen_fwd_paged_ref(q, kp, vp, *tail)
    kc, vc = gather_kv(torch, kp, vp, tail[0], seqlens, ps)
    g, dev, scale = Hq // Hk, q.device, tail[5]
    o64 = torch.empty(q.shape, dtype=torch.float64, device=dev)
    lse64 = torch.empty(lse.shape, dtype=torch.float64, device=dev)
    for b in range(B):
        n, rows = int(seqlens[b]), slice(b * T, (b + 1) * T)
        valid = (torch.arange(n, device=dev)[None, :]
                 <= torch.arange(T, device=dev)[:, None] + int(prefix[b]))
        for h in range(Hk):
            hq = slice(h * g, (h + 1) * g)
            o, l, _ = attn64(torch, q[rows, hq].transpose(0, 1),
                             kc[b, h:h + 1, :n], vc[b, h:h + 1, :n], valid,
                             scale)
            o64[rows, hq] = o.transpose(0, 1)
            lse64[hq, rows] = l
    tag = f"fp32 {B} x {T} new tokens over prefixes {prefix.tolist()}"
    res = {"K8": gate64(torch, f"K8 {tag} out", out, o_t, o64, "fwd"),
           "K8 lse": gate64(torch, f"K8 {tag} lse", lse, lse_t, lse64,
                            "fwd")}
    print(f"fp32 K8 {tag}, {Hq}/{Hk} x {D}, page {ps}: " + ", ".join(
        f"{n} err {r['err']:.3e} (twin {r['twin_err']:.3e}, gate "
        f"{r['gate']:.3e})" for n, r in res.items()), flush=True)
    return res, (B, T, Hq, Hk, D, ps, prefix, seqlens, q, kp, vp, tail, kc,
                 vc)


def fp32_k4(torch):
    """K4 (the merged entry, the engine's route) on fp32 at the engine's
    decode step, B 8, 32/4 x 64, page 128, lengths 600-2000, against its
    twin and the fp64 oracle."""
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ggen = torch.Generator(device=dev).manual_seed(SEED)
    B, Hk, group, D, ps, max_pages = 8, 4, 8, 64, 128, 16
    lens = torch.randint(600, 2001, (B,), generator=gen)
    tbl, n_pages = paged_tables(torch, gen, lens, ps, max_pages, dev)
    kp, vp = make_pool(torch, ggen, dev, Hk, n_pages, ps, D, torch.float32)
    q = torch.randn((B, Hk, group, D), generator=ggen, device=dev)
    lens_d = lens.to(dev, torch.int32)
    kw = dict(qpos_vec=lens_d - 1, softmax_scale=D ** -0.5,
              params=masklib.MaskParams(window_right=0), t_new=1,
              group=group, num_splits=0)
    args = (q, kp[None], vp[None], tbl, lens_d,
            torch.zeros(B, dtype=torch.int32, device=dev))
    twins0 = dec.paged_decode_attention_ref.calls
    n0 = dec.paged_decode_attention.launches
    o, lse = dec.paged_decode_attention_merged(*args, **kw)
    torch.cuda.synchronize()
    assert dec.paged_decode_attention.launches == n0 + 1
    assert dec.paged_decode_attention_ref.calls == twins0
    assert o.dtype == torch.float32
    o_t, lse_t = dec.merge_partials(*dec.paged_decode_attention_ref(*args,
                                                                     **kw))
    kc, vc = gather_kv(torch, kp, vp, tbl, lens, ps)
    o64 = torch.empty(o.shape, dtype=torch.float64, device=dev)
    lse64 = torch.empty(lse.shape, dtype=torch.float64, device=dev)
    for b in range(B):
        n = int(lens[b])
        for h in range(Hk):
            ob, lb, _ = attn64(torch, q[b, h][:, None], kc[b, h, :n][None],
                               vc[b, h, :n][None], torch.ones(
                                   (1, n), dtype=torch.bool, device=dev),
                               D ** -0.5)
            o64[b, h] = ob[:, 0]
            lse64[b, h, :, 0] = lb[:, 0]
    res = {"K4": gate64(torch, "K4 fp32 decode step out", o, o_t, o64,
                        "fwd"),
           "K4 lse": gate64(torch, "K4 fp32 decode step lse", lse, lse_t,
                            lse64, "fwd")}
    print(f"fp32 K4 decode step B {B}, {Hk * group}/{Hk} x {D}, page {ps}, "
          f"lengths {int(lens.min())}-{int(lens.max())} (merged entry): "
          + ", ".join(f"{n} err {r['err']:.3e} (twin {r['twin_err']:.3e}, "
                      f"gate {r['gate']:.3e})" for n, r in res.items()),
          flush=True)
    return res, (q, kp, vp, tbl, lens, lens_d, args, kw, kc, vc, group)


# fp32 q over quantized pools (K4q / K8q's fp32 instantiations): the bound's
# operations rate is the design's products': int8 tensor cores for int8 /
# int4 (S and P V), bf16 for fp8, whose S is three bf16 products (q split
# in three exact parts) and P V one
FP32_QUANT_PRODUCTS = {"int8": 2, "int4": 2, "fp8": 4}


def fp32_quant_ops(kind, pairs, D):
    """(operations, their rate) of the fp32-q K4q / K8q designs over
    `pairs` live (q row, key) pairs at head dim D."""
    return (FP32_QUANT_PRODUCTS[kind] * 2 * D * pairs,
            BF16_FLOPS_PER_S if kind == "fp8" else INT8_OPS_PER_S)


def fp32_quant_occupancy(build) -> dict:
    """K4q's and K8q's fp32-q instantiations at D 32 / 64 / 128 / 256:
    registers, local memory, dynamic shared memory and resident warps a
    multiprocessor (K4q in 16-row and 64-row blocks, K8q without and with
    bias), from the libraries' occupancy entries with dtype code 2."""
    import ctypes
    from flash_attn_v100_tpu_torch.ops.cuda.decode import KIND_CODE
    res = {}
    for kind in QUANT_KINDS:
        for D in (32, 64, 128, 256):
            for name, var in (("K4q", 16), ("K4q", 64), ("K8q", 0),
                              ("K8q", 1)):
                out = (ctypes.c_int * 5)()
                at = ctypes.addressof(out)
                if name == "K4q":
                    rc = build.load("decode_quant").fa_decode_quant_occupancy(
                        KIND_CODE[kind], 2, D, var, at)
                else:
                    rc = build.load("varlen_paged_quant") \
                        .fa_varlen_paged_quant_occupancy(KIND_CODE[kind], 2,
                                                         D, var, at)
                build.check(rc, f"{name} fp32 {kind} occupancy")
                blocks, smem, threads, regs, local = out
                res[(name, kind, D, var)] = dict(
                    registers=regs, local_bytes=local, smem_bytes=smem,
                    blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32)
    for name, var_name in (("K4q", "rows"), ("K8q", "extra")):
        for kind in QUANT_KINDS:
            cells = [f"D {D} {var_name} {var}: {r['registers']} regs, "
                     f"local {r['local_bytes']} B, smem {r['smem_bytes']} B, "
                     f"{r['warps_per_sm']} warps/SM"
                     for (n, k, D, var), r in res.items()
                     if n == name and k == kind]
            print(f"{name} fp32 {kind} occupancy: " + "; ".join(cells),
                  flush=True)
    return res


def fp32_quant(torch, flush):
    """K4q and K8q on fp32 q, per payload kind: K4q through the merged
    entry (the engine's route) at fp32_k4's decode step (B 8, 32/4 x 64,
    page 128, lengths 600-2000), K8q at k8_case's 4 x 512 new tokens over
    prefixes 0/300/0/300; each against its plain twin at the kernel's P
    grouping and the fp32 oracle over the dequantized pool (QUANT_GATE),
    with one launch of its kind counted and no plain call; then kernel,
    plain and fp32 SDPA times (SDPA over the dequantized, pre-gathered KV)
    beside the bound (bytes over 3.35 TB/s or the design's operations
    over its products' rate).  Returns {"K4q": {kind: result}, "K8q":
    {kind: result}}."""
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ggen = torch.Generator(device=dev).manual_seed(SEED)
    B, Hk, group, D, ps, max_pages = 8, 4, 8, 64, 128, 16
    lens = torch.randint(600, 2001, (B,), generator=gen)
    tbl, n_pages = paged_tables(torch, gen, lens, ps, max_pages, dev)
    kp, vp = make_pool(torch, ggen, dev, Hk, n_pages, ps, D, torch.float32)
    q = torch.randn((B, Hk, group, D), generator=ggen, device=dev)
    lens_d = lens.to(dev, torch.int32)
    lp = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(qpos_vec=lens_d - 1, softmax_scale=D ** -0.5,
              params=masklib.MaskParams(window_right=0), t_new=1,
              group=group, num_splits=0)
    live = int(lens.sum())
    res = {"K4q": {}, "K8q": {}}
    for kind in QUANT_KINDS:
        (kq, vq, ks, vs), (kd, vd) = quant_pools(torch, kp, vp, kind)
        args = (q, kq[None], vq[None], tbl, lens_d, lp)
        qkw = dict(kw, k_scales=ks[None], v_scales=vs[None],
                   int4=kind == "int4")

        def run(qkw=qkw, args=args):
            return dec.paged_decode_attention_merged(*args, **qkw)
        n0 = dec.paged_decode_attention.quant_launches[kind]
        twins0 = dec.paged_decode_attention_ref.calls
        o, lse = run()
        torch.cuda.synchronize()
        assert dec.paged_decode_attention.quant_launches[kind] == n0 + 1
        assert dec.paged_decode_attention_ref.calls == twins0
        assert o.dtype == torch.float32 and lse.dtype == torch.float32
        twin, lse_twin = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, **qkw))
        unr = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, round_p=False, **qkw))[0]
        oracle = dec.merge_partials(*dec.paged_decode_attention_ref(
            q, kd[None], vd[None], tbl, lens_d, lp, **kw))[0]
        vsw = wrong_chunk_pool(torch, vs, tbl, lens, ps, B - 1)
        o_w = dec.paged_decode_attention_merged(
            *args, **dict(qkw, v_scales=vsw[None]))[0]
        wrong = o.clone()
        wrong[B - 1] = o_w[B - 1]
        r = gate_quant(torch, f"K4q fp32 {kind} decode", kind, o, lse, twin,
                       unr, lse_twin, oracle, wrong)
        del twin, unr, oracle, o_w, wrong
        r["ms"] = time_ms(torch, run, flush=flush)
        r["plain_ms"] = time_ms(torch, lambda: dec.paged_decode_attention_ref(
            *args, **qkw), reps=3, warmup=1, flush=flush)
        kc, vc = gather_kv(torch, kd, vd, tbl, lens, ps)
        r["library_ms"] = time_ms(
            torch, decode_sdpa(torch, q, kc, vc, lens_d, group), flush=flush)
        del kc, vc
        row_bytes = D // 2 if kind == "int4" else D
        nbytes = (q.numel() * 4 + 2 * live * Hk * (row_bytes + 4)
                  + tbl.numel() * 4 + B * 12 + B * Hk * group * (4 * D + 4))
        ops, rate = fp32_quant_ops(kind, live * Hk * group, D)
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, ops, rate)
        res["K4q"][kind] = r
    del kp, vp

    (B, T, Hq, Hk, D, ps), prefix, seqlens, q, kp, vp, tail, _ = k8_case(
        torch, torch.float32)
    tbl = tail[0]
    pairs = Hq * sum(T * int(p) + T * (T + 1) // 2 for p in prefix)
    for kind in QUANT_KINDS:
        (kq, vq, ks, vs), (kd, vd) = quant_pools(torch, kp, vp, kind)
        args = (q, kq, vq, *tail)
        skw = dict(k_scales=ks, v_scales=vs)

        def run(args=args, skw=skw):
            return vl.flash_attn_varlen_fwd_paged(*args, **skw)
        n0 = vl.flash_attn_varlen_fwd_paged.quant_launches[kind]
        twins0 = vl.flash_attn_varlen_fwd_paged_ref.calls
        out, lse = run()
        torch.cuda.synchronize()
        assert vl.flash_attn_varlen_fwd_paged.quant_launches[kind] == n0 + 1
        assert vl.flash_attn_varlen_fwd_paged_ref.calls == twins0
        assert out.dtype == torch.float32
        twin, lse_twin = vl.flash_attn_varlen_fwd_paged_ref(*args, **skw)
        unr = vl.flash_attn_varlen_fwd_paged_ref(*args, round_p=False,
                                                 **skw)[0]
        oracle = vl.flash_attn_varlen_fwd_paged_ref(q, kd, vd, *tail)[0]
        o_w = vl.flash_attn_varlen_fwd_paged(
            *args, k_scales=ks, v_scales=torch.roll(vs, 1, dims=2))[0]
        wrong = spliced0(out, o_w, B * T - 64)
        r = gate_quant(torch, f"K8q fp32 {kind} prefill", kind, out, lse,
                       twin, unr, lse_twin, oracle, wrong)
        del twin, unr, oracle, o_w, wrong
        r["ms"] = time_ms(torch, run, flush=flush)
        r["plain_ms"] = time_ms(
            torch, lambda: vl.flash_attn_varlen_fwd_paged_ref(*args, **skw),
            reps=3, warmup=1, flush=flush)
        kc, vc = gather_kv(torch, kd, vd, tbl, seqlens, ps)
        r["library_ms"] = time_ms(
            torch, prefill_sdpa(torch, q, kc, vc, prefix, T), flush=flush)
        del kc, vc
        row_bytes = D // 2 if kind == "int4" else D
        nbytes = (2 * q.numel() * 4 + Hq * B * T * 4
                  + 2 * int(seqlens.sum()) * Hk * (row_bytes + 4)
                  + tbl.numel() * 4)
        ops, rate = fp32_quant_ops(kind, pairs, D)
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, ops, rate)
        res["K8q"][kind] = r
    for kid in ("K4q", "K8q"):
        for kind, r in res[kid].items():
            print(f"{kid} fp32 {kind}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, SDPA fp32 over the dequantized "
                  f"pre-gathered KV {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
    print(f"fp32 q over quantized pools: checks and times "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return res


def fp32_quant_tiny(torch, kind, prompts=(100, 9), n_new=8):
    """ModelConfig.tiny() (fp32) served from a `kind` pool, one
    max_batch-1 engine a prompt (page 128: the 100-token prompt's prefill
    takes the K8 route, the 9-token one's the K4 route), against a direct
    paged_forward loop through the same kernels (the engine's shapes,
    bucketed prefill, full block table): greedy tokens equal.  Returns the
    engine runs' launches (K4q, K8q of `kind`; the direct loops' are not
    counted)."""
    import numpy as np
    from flash_attn_v100_tpu_torch import ModelConfig, ServingEngine
    from flash_attn_v100_tpu_torch.models.transformer import init_params
    from flash_attn_v100_tpu_torch.ops import kvcache as kv_mod
    from flash_attn_v100_tpu_torch.runtime import engine as eng_mod
    cfg = ModelConfig.tiny()
    params = init_params(cfg, seed=SEED, device="cuda")
    ps, num_pages = 128, 16
    rows = ps // 2 if kind == "int4" else ps
    pdt = torch.int8 if kind == "int4" else quant_dtype(torch, kind)
    rng = np.random.default_rng(SEED + 2)
    saved = kv_mod.VARLEN_PREFILL_MIN_ROWS
    kv_mod.VARLEN_PREFILL_MIN_ROWS = 128   # the tiny model's K8 route
    total = {"decode": 0, "varlen": 0}
    try:
        for n in prompts:
            prompt = rng.integers(1, cfg.vocab_size, n).tolist()
            shape = (cfg.n_kv_heads, (num_pages + 1) * cfg.n_layers, rows,
                     cfg.head_dim)
            pools = [torch.zeros(shape, dtype=pdt, device="cuda")
                     for _ in range(2)]
            scales = dict(k_scales=torch.ones((*shape[:2], ps, 1),
                                              device="cuda"),
                          v_scales=torch.ones((*shape[:2], ps, 1),
                                              device="cuda"))
            bt = torch.arange(1, cfg.max_seq_len // ps + 1, dtype=torch.int32,
                              device="cuda")[None]
            T = ServingEngine._bucket(n)
            toks = torch.zeros((1, T), dtype=torch.long, device="cuda")
            toks[0, :n] = torch.tensor(prompt, device="cuda")
            with torch.no_grad():
                logits = eng_mod.paged_forward(
                    params, *pools, toks,
                    torch.zeros(1, dtype=torch.int32, device="cuda"), bt,
                    cfg, **scales)[0]
                ref = [int(logits[0, n - 1].argmax())]
                for i in range(n_new - 1):
                    cs = torch.tensor([n + i], dtype=torch.int32,
                                      device="cuda")
                    logits = eng_mod.paged_forward(
                        params, *pools,
                        torch.tensor([[ref[-1]]], device="cuda"), cs, bt,
                        cfg, **scales)[0]
                    ref.append(int(logits[0, 0].argmax()))
            eng = ServingEngine(params, cfg, max_batch=1, num_pages=num_pages,
                                page_size=ps, device="cuda",
                                kv_dtype=quant_dtype(torch, kind))
            reset_serving_counts()
            rid = eng.submit(prompt, max_new_tokens=n_new)
            got = eng.run_to_completion()[rid]
            launches, twin_calls, other = serving_counts(kind)
            assert twin_calls == [0, 0], twin_calls
            assert other == 0, f"{other} launches of another kernel"
            assert got == ref, (kind, n, got, ref)
            for k in total:
                total[k] += launches[k]
    finally:
        kv_mod.VARLEN_PREFILL_MIN_ROWS = saved
    assert total["decode"] > 0 and total["varlen"] > 0, total
    print(f"fp32 ModelConfig.tiny served from an {kind} pool (page {ps}, "
          f"prompts {list(prompts)}, {n_new} new each, one max_batch-1 "
          f"engine a prompt): greedy tokens equal to a direct paged_forward "
          f"loop's; engine launches K4q {total['decode']}, K8q "
          f"{total['varlen']}, plain twin calls 0", flush=True)
    return total


def fp32_train(torch, cfg, B, tag):
    """One fp32 model's training check: the step-1 loss and every leaf's
    gradient through the kernels against the same through the plain
    attention versions (within FP32_PATH_ATOL), then `steps` AdamW steps
    of make_train_step through K1-K3 with their launches counted and the
    plain twins never called.  Returns what phase_fp32 prints."""
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops import flash_attention as fa_mod
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    dev = torch.device("cuda")
    params = tm.init_params(cfg, seed=SEED, device=dev, lm_head=True)
    leaves = tm.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    gen = torch.Generator().manual_seed(SEED)
    S = min(TRAIN_S, cfg.max_seq_len)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                           generator=gen).to(dev)
    with _plain_attention(fa_mod, dfwd, dbwd, True):
        loss_p = tm.loss_fn(params, tokens, cfg)
        grads_p = torch.autograd.grad(loss_p, leaves)
    loss_p = float(loss_p.detach())
    step, init_opt = tm.make_train_step(cfg)
    opt = init_opt(params)
    steps = TRAIN_STEPS if cfg.n_layers > 2 else 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(dfwd, dbwd)
    losses, secs, grad_err = [], [], 0.0
    for i in range(steps):
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, tokens)
        losses.append(float(loss))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == 0:   # step 1's gradients are still in .grad
            for t, gp in zip(leaves, grads_p):
                grad_err = max(grad_err, float((t.grad - gp).abs().max()))
    del grads_p
    counts = _kernel_counts(dfwd, dbwd)
    L = cfg.n_layers
    assert all(counts[n] == L * steps for n in ("K1", "K2", "K3")), counts
    assert counts["plain_fwd"] == counts["plain_bwd"] == 0, counts
    loss_err = abs(losses[0] - loss_p)
    assert loss_err <= FP32_PATH_ATOL, (tag, losses[0], loss_p)
    assert grad_err <= FP32_PATH_ATOL, (tag, grad_err)
    assert all(math.isfinite(x) for x in losses), losses
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"fp32 {tag} train: {L} layers, dim {cfg.dim}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.head_dim}, B {B} x S {S}, {steps} "
          f"AdamW step(s): losses {[round(x, 6) for x in losses]}, step "
          f"times {[round(x * 1e3, 1) for x in secs]} ms, peak {peak:.2f} "
          f"GB; step-1 loss vs the plain path's {loss_p:.6f}: err "
          f"{loss_err:.3e}, every leaf's gradient: max err {grad_err:.3e} "
          f"(gate {FP32_PATH_ATOL:.0e}); launches K1/K2/K3 {counts['K1']}/"
          f"{counts['K2']}/{counts['K3']}, plain calls 0", flush=True)
    return dict(launches=counts, losses=losses, step_ms=statistics.median(
        secs) * 1e3, peak_gb=peak, loss_err=loss_err, grad_err=grad_err,
        B=B), params


def fp32_serve(torch, params, cfg, tag, prompts, n_new, page_size=PAGE_SIZE,
               num_pages=NUM_PAGES, kind=None):
    """One fp32 engine run through K8 and K4 (K8q and K4q over a pool of
    payload `kind`), its first K8-route prefill step and first decode step
    (T = 1) replayed through the plain twins (logits within
    FP32_PATH_ATOL; over a quantized pool within ENGINE_QUANT_GATE: an
    ulp of P's exponential flips an int8 value of P where its quotient
    lies at a half, in kernel or twin, and the layers carry those flips to
    the logits), and the same
    traffic served again on the plain twins: greedy tokens equal.  At a
    first difference the top-two logit margin there is printed; over an
    fp32 pool the run fails unless that margin is within the logits gate
    (a tie the gate cannot order)."""
    from flash_attn_v100_tpu_torch import ServingEngine
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops import kvcache as kv_mod
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    from flash_attn_v100_tpu_torch.runtime import engine as eng_mod

    @contextlib.contextmanager
    def plain_twins(**yard):
        def plain_merged(*a, **k):
            o, lse = dec.merge_partials(*dec.paged_decode_attention_ref(
                *a, **yard, **k))
            return o.to(a[0].dtype), lse
        saved = (kv_mod.paged_decode_attention_merged,
                 kv_mod.flash_attn_varlen_fwd_paged)
        kv_mod.paged_decode_attention_merged = plain_merged
        kv_mod.flash_attn_varlen_fwd_paged = functools.partial(
            vl.flash_attn_varlen_fwd_paged_ref, **yard)
        try:
            yield
        finally:
            (kv_mod.paged_decode_attention_merged,
             kv_mod.flash_attn_varlen_fwd_paged) = saved

    def run(spy=None):
        eng = ServingEngine(params, cfg, max_batch=len(prompts),
                            num_pages=num_pages, page_size=page_size,
                            device="cuda",
                            kv_dtype=None if kind is None else quant_dtype(
                                torch, kind))
        real = eng_mod.paged_forward
        if spy is not None:
            eng_mod.paged_forward = spy(real)
        try:
            rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
            out = eng.run_to_completion()
        finally:
            eng_mod.paged_forward = real
        return [out[r] for r in rids], eng

    cap = {}

    def spy(real):
        def f(params_, k_pool, v_pool, tokens, cs, bt, cfg_, **kw):
            T = tokens.shape[1]
            key = ("decode step" if T == 1 else
                   "varlen prefill" if eng_mod._route(
                       cfg_, T, k_pool.shape[2]) == "varlen" else None)
            if key is None or key in cap:
                return real(params_, k_pool, v_pool, tokens, cs, bt, cfg_,
                            **kw)
            c = cap[key] = dict(k=k_pool.clone(), v=v_pool.clone(),
                                kw=_scale_clones(kw),
                                args=(tokens.clone(), cs.clone(),
                                      bt.clone()))
            out = real(params_, k_pool, v_pool, tokens, cs, bt, cfg_, **kw)
            c["logits"] = out[0].clone()
            return out
        return f

    reset_serving_counts()
    toks, eng = run(spy)
    launches, twin_calls, other = serving_counts(kind)
    assert twin_calls == [0, 0], twin_calls
    assert other == 0, f"{other} launches of another payload's kernels"
    assert launches["decode"] > 0 and launches["varlen"] > 0, launches
    assert sorted(cap) == ["decode step", "varlen prefill"], sorted(cap)
    errs = {}
    for key, c in cap.items():
        def replay(**yard):
            with plain_twins(**yard):
                return eng_mod.paged_forward(params, c["k"].clone(),
                                             c["v"].clone(), *c["args"], cfg,
                                             **_scale_clones(c["kw"]))[0]
        plain = replay()
        errs[key] = float((c["logits"] - plain).abs().max())
        if kind is None:
            assert errs[key] <= FP32_PATH_ATOL, (tag, key, errs[key])
        else:
            err, gate = gated(torch, c["logits"], plain,
                              replay(round_p=False),
                              f"fp32 {tag} {kind}: first {key} logits",
                              ENGINE_LOGITS_MULT, ENGINE_LOGITS_ATOL)
            print(f"fp32 {tag} {kind}: first {key} logits err {err:.3e} <= "
                  f"gate {gate:.3e} ({ENGINE_QUANT_GATE})", flush=True)
    del cap, eng
    with plain_twins():
        toks_p, _ = run()
    diff = [(i, j) for i, (a, b) in enumerate(zip(toks, toks_p))
            for j in range(len(a)) if a[j] != b[j]][:1]
    same = "equal to the plain run's"
    if diff:
        i, j = diff[0]
        seq = torch.tensor(prompts[i] + toks[i][:j], device="cuda")[None]
        with torch.no_grad():
            top = tm.forward(params, seq, cfg)[0, -1].topk(2).values
        margin = float(top[0] - top[1])
        same = (f"equal to the plain run's up to request {i} token {j} "
                f"(kernel {toks[i][j]}, plain {toks_p[i][j]}), where the "
                f"top-two logit margin is {margin:.3e}")
        print(f"fp32 {tag} serve: tokens {same}", flush=True)
        assert kind is not None or margin <= FP32_PATH_ATOL, (
            f"fp32 {tag}: greedy tokens differ from the plain run at a "
            f"margin above the logits gate")
    print(f"fp32 {tag} serve: {len(prompts)} requests (prompts "
          f"{sorted(len(p) for p in prompts)}, {n_new} new each, greedy), "
          f"{kind or 'fp32'} pool, page {page_size}: launches {launches}, "
          f"plain twin calls 0; first K8-route prefill logits err "
          f"{errs['varlen prefill']:.3e}, first decode step logits err "
          f"{errs['decode step']:.3e} (max abs; gate "
          f"{'ENGINE_QUANT_GATE' if kind else f'{FP32_PATH_ATOL:.0e}'}) vs "
          f"the plain twins; tokens {same}", flush=True)
    return dict(launches=launches, logits_err=errs, tokens_equal=not diff)


def fair_sdpa(torch, flush, q, k, v, do, causal=True) -> dict:
    """fp32 SDPA's forward and backward (CUDA events around one call) on
    q / k / v (B, S, H, D), two ways: `fwd_ms` / `bwd_ms` with k / v heads
    repeated to q's under the efficient backend (3 x TF32 products in its
    CUTLASS sources: the fair fp32 yardstick), `gqa_fwd_ms` / `gqa_bwd_ms`
    with `enable_gqa` and the default choice of backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    group = q.shape[2] // k.shape[2]
    do_s = do.transpose(1, 2).contiguous()
    res = {}
    for how in ("fair", "gqa"):
        rep = 1 if how == "gqa" else group
        qs, ks, vs = (t.repeat_interleave(r, dim=2).transpose(1, 2)
                      .contiguous().requires_grad_()
                      for t, r in ((q, 1), (k, rep), (v, rep)))
        kw = dict(is_causal=causal, enable_gqa=how == "gqa" and group > 1)
        ctx = (sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION) if how == "fair"
               else contextlib.nullcontext())
        with ctx:
            fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, **kw), reps=5, flush=flush)
            o = F.scaled_dot_product_attention(qs, ks, vs, **kw)
            bwd = time_ms(torch, lambda: torch.autograd.grad(
                o, (qs, ks, vs), do_s, retain_graph=True), reps=5,
                flush=flush)
        pre = "" if how == "fair" else "gqa_"
        res[pre + "fwd_ms"], res[pre + "bwd_ms"] = fwd, bwd
        del o, qs, ks, vs
    return res


def f32_sass(build) -> dict:
    """Each instantiation of F32_TF32_KERNELS at D 32-256: its SASS counts
    (`build.sass_counts` with F32_SASS_OPS: TF32 HGMMA and HMMA, every
    FFMA) and ptxas's registers and local bytes.  Asserts for every one
    (K1 / K5 / K8, K2 / K6, K3 / K7, K4 at 16 and 64 rows) that every
    tensor-core product is a TF32 one, HGMMA (no HMMA) at the head dims on
    wgmma, HMMA (no HGMMA) at the others, fewer than F32_FFMA_MAX FFMA (no
    FFMA product loop), and no local memory."""
    import re
    res = {}
    counts = {lib: build.sass_counts(lib, F32_SASS_OPS)
              for lib in ("fwd_f32", "bwd_f32", "decode_f32")}
    usage = {lib: build.ptxas_usage(lib) for lib in counts}
    for kid, (lib, kernel, wgmma) in F32_TF32_KERNELS.items():
        rows = []
        for D in (32, 64, 128, 256):
            pat = re.compile(re.escape(kernel.format(D=D)))
            (name, c), = [(n, c) for n, c in counts[lib].items()
                          if pat.search(n)]
            u = usage[lib][name]
            r = dict(D=D, **c, registers=u["registers"],
                     local_bytes=u["stack"] + u["spill_stores"])
            wg = D in wgmma
            assert r["hgmma_tf32" if wg else "hmma_tf32"] > 0, (name, r)
            assert r["hgmma_tf32"] == r["hgmma"], (name, r)
            assert r["hmma_tf32"] == r["hmma"], (name, r)
            assert r["hmma" if wg else "hgmma"] == 0, (name, r)
            assert r["ffma"] < F32_FFMA_MAX, (name, r)
            assert r["local_bytes"] == 0, (name, r)
            rows.append(r)
        res[kid] = rows
        print(f"fp32 {kid} SASS (D 32 / 64 / 128 / 256): HGMMA.TF32 "
              f"{[r['hgmma_tf32'] for r in rows]}, HMMA.TF32 "
              f"{[r['hmma_tf32'] for r in rows]}, FFMA "
              f"{[r['ffma'] for r in rows]}, MUFU.EX2 "
              f"{[r['mufu_ex2'] for r in rows]}, registers "
              f"{[r['registers'] for r in rows]}, local bytes "
              f"{[r['local_bytes'] for r in rows]}", flush=True)
    return res


def fp32_times(torch, flush, dense, varlen, k8, k4):
    """Kernel, plain twin and library times of each fp32 kernel at its main
    shape, with the bound (bytes over 3.35 TB/s or operations over the
    TF32 rate), the 3 x TF32 ceiling (operations at a third of it) and the
    FFMA ceiling; K1-K3 also at FP32_D128.  The library: for K1-K3
    `fair_sdpa` (heads repeated, the efficient backend; its `enable_gqa`
    call beside it), for K5-K7 `varlen_library` (heads repeated), for K4
    / K8 SDPA over the pre-gathered KV."""
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
    F = torch.nn.functional
    out = {}

    def row(name, ms, plain, lib, flops, nbytes, library, gqa=None):
        bms, by = bound_ms(nbytes, flops, TF32_OPS_PER_S)
        split = bound_ms(nbytes, flops, SPLIT_OPS_PER_S)[0]
        ceil = bound_ms(nbytes, flops, FFMA_OPS_PER_S)[0]
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                         bound_by=by, split_bound_ms=split,
                         ffma_bound_ms=ceil, library=library)
        if gqa is not None:
            out[name]["library_gqa_ms"] = gqa
        print(f"fp32 {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"{library} {lib:.4f} ms"
              + ("" if gqa is None else f" (enable_gqa {gqa:.4f} ms)")
              + f", bound {bms:.4f} ms ({by}, {flops:.3e} flop at TF32), "
              f"3xTF32 ceiling {split:.4f} ms, FFMA ceiling {ceil:.4f} ms; "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bms / ms:.1f}% of the "
              f"bound, {100 * split / ms:.1f}% of the 3xTF32 ceiling, "
              f"{100 * ceil / ms:.1f}% of the FFMA ceiling", flush=True)

    def dense_rows(tag, q, k, v, do, o, lse, scale, params):
        """K1-K3 (`tag` after the id) on these inputs beside fair_sdpa."""
        B, S, Hq, D = q.shape
        Hk = k.shape[2]
        delta = dbwd.softmax_delta(o, do)
        lse_c = lse.clamp_min(NEG_INF).contiguous()
        kargs = (q, k, v, do, lse_c, delta, None, scale, params, 0.0, None,
                 0, None, Hq)
        ms = {"K1": time_ms(torch, lambda: dfwd.flash_attn_dense_fwd(
                  q, k, v, scale, params), reps=10, flush=flush),
              "K2": time_ms(torch, lambda: dbwd.dq_kernel(*kargs), reps=10,
                            flush=flush),
              "K3": time_ms(torch, lambda: dbwd.dkv_kernel(*kargs), reps=10,
                            flush=flush)}
        p_fwd = time_ms(torch, lambda: dfwd.flash_attn_dense_fwd_ref(
            q, k, v, scale, params), reps=3, warmup=1, flush=flush)
        p_bwd = time_ms(torch, lambda: dbwd.flash_attn_dense_bwd_ref(
            q, k, v, o, do, lse, scale, params), reps=3, warmup=1,
            flush=flush)
        lib = fair_sdpa(torch, flush, q, k, v, do)
        work = dense_work(B, S, Hq, Hk, D, esize=4)
        for kid, plain, what in (("K1", p_fwd, "fwd"), ("K2", p_bwd, "bwd"),
                                 ("K3", p_bwd, "bwd")):
            row(kid + tag, ms[kid], plain, lib[what + "_ms"], *work[kid],
                "sdpa fp32 " + ("fwd" if kid == "K1" else "bwd (K2 + K3)")
                + ", heads repeated, efficient backend",
                gqa=lib[f"gqa_{what}_ms"])

    # K1-K3 at the training shape, then at FP32_D128
    dense_rows("", *dense)
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    B, S, Hq, Hk, D = FP32_D128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    q, k, v, do = (torch.randn((B, S, h, D), generator=gen, device="cuda")
                   for h in (Hq, Hk, Hk, Hq))
    scale, params = D ** -0.5, masklib.MaskParams(causal=True)
    o, lse = dfwd.flash_attn_dense_fwd(q, k, v, scale, params)
    dense_rows(" D 128", q, k, v, do, o, lse, scale, params)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()

    # K5-K7 at the packed documents
    q, k, v, do, cu, mx, lens, scale, params = varlen
    Hq, Hk, D = q.shape[1], k.shape[1], q.shape[2]
    o, lse = vl.flash_attn_varlen_fwd(q, k, v, cu, cu, mx, mx, scale, params)
    delta = vl.varlen_delta(o, do)
    lse_c = lse.clamp_min(NEG_INF).contiguous()
    bk = (q, k, v, do, lse_c, delta, None, cu, cu, None, None, mx, mx,
          scale, params, 0.0, None)
    ms = {"K5": time_ms(torch, lambda: vl.flash_attn_varlen_fwd(
              q, k, v, cu, cu, mx, mx, scale, params), reps=10, flush=flush),
          "K6": time_ms(torch, lambda: vl.varlen_dq_kernel(*bk), reps=10,
                        flush=flush),
          "K7": time_ms(torch, lambda: vl.varlen_dkv_kernel(*bk), reps=10,
                        flush=flush)}
    p_fwd = time_ms(torch, lambda: vl.flash_attn_varlen_fwd_ref(
        q, k, v, cu, cu, mx, mx, scale, params), reps=3, warmup=1,
        flush=flush)
    p_bwd = time_ms(torch, lambda: vl.flash_attn_varlen_bwd_ref(
        q, k, v, o, do, lse, cu, cu, mx, mx, scale, params), reps=3,
        warmup=1, flush=flush)
    lv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    label, fn, o_lib = varlen_library(torch, *lv, cu, mx)
    l_fwd = time_ms(torch, fn, reps=3, warmup=1, flush=flush)
    l_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, lv, do.view_as(o_lib) if o_lib.shape == do.shape else
        do.transpose(0, 1)[None], retain_graph=True), reps=3, warmup=1,
        flush=flush)
    del o_lib, lv
    work = varlen_work(lens, Hq, Hk, D, esize=4)
    for name, plain, lib in (("K5", p_fwd, l_fwd), ("K6", p_bwd, l_bwd),
                             ("K7", p_bwd, l_bwd)):
        row(name, ms[name], plain, lib, *work[name],
            f"{label} fp32 " + ("fwd" if name == "K5" else "bwd (K6 + K7)"))

    # K8 at the engine's prefill wave
    B, T, Hq, Hk, D, ps, prefix, seqlens, q, kp, vp, tail, kc, vc = k8
    kms = time_ms(torch, lambda: vl.flash_attn_varlen_fwd_paged(
        q, kp, vp, *tail), flush=flush)
    plain = time_ms(torch, lambda: vl.flash_attn_varlen_fwd_paged_ref(
        q, kp, vp, *tail), reps=3, warmup=1, flush=flush)
    lib = time_ms(torch, prefill_sdpa(torch, q, kc, vc, prefix, T),
                  flush=flush)
    pairs = Hq * sum(T * int(p) + T * (T + 1) // 2 for p in prefix)
    nbytes = (2 * q.numel() * 4 + 2 * int(seqlens.sum()) * Hk * D * 4
              + q.shape[0] * Hq * 4)
    row("K8", kms, plain, lib, 4 * D * pairs, nbytes,
        "sdpa fp32 (pre-gathered KV)")

    # K4 at the engine's decode step, through the merged entry: a call, and
    # FP32_K4_GRAPH_REPS graph replays of it (the launch's device time)
    q, kp, vp, tbl, lens, lens_d, args, kw, kc, vc, group = k4
    kms = time_ms(torch, lambda: dec.paged_decode_attention_merged(
        *args, **kw), flush=flush)
    k4_graph = graph_ms(torch, lambda: dec.paged_decode_attention_merged(
        *args, **kw), reps=FP32_K4_GRAPH_REPS, flush=flush)
    plain = time_ms(torch, lambda: dec.merge_partials(
        *dec.paged_decode_attention_ref(*args, **kw)), reps=5, flush=flush)
    lib = time_ms(torch, decode_sdpa(torch, q, kc, vc, lens_d, group),
                  flush=flush)
    n_kv = int(lens.sum()) * q.shape[1]
    nbytes = 2 * n_kv * q.shape[-1] * 4 + 2 * q.numel() * 4
    row("K4", kms, plain, lib, 4 * q.shape[-1] * group * n_kv, nbytes,
        "sdpa fp32 (pre-gathered KV)")
    out["K4"]["graph_ms"] = k4_graph
    print(f"fp32 K4: {k4_graph:.4f} ms a graph replay (device time, median "
          f"of {FP32_K4_GRAPH_REPS}) beside its {out['K4']['bound_ms']:.4f} "
          f"ms bound", flush=True)
    return out


def phase_fp32(torch, flush):
    """fp32 through K1-K8's fp32 bodies: (1) each kernel against its plain
    twin and the fp64 oracle at its main shape (K1-K3 at the training
    shape, ModelConfig.tiny's heads and D 128 / 256; K5-K7 at the packed
    documents; K8 at the engine's prefill wave; K4 at its decode step);
    (2) the path at full width: TinyLlama-1.1B's widths in fp32 (depth
    cut to FP32_LAYERS), three
    AdamW steps through K1-K3 (step 1's loss and every leaf's gradient
    against the plain path's) and phase_engine's 8 requests through K8
    and K4 (the first prefill's and decode step's logits against the plain
    twins', greedy tokens equal to a plain run's); the same for
    ModelConfig.tiny(); (3) each kernel's times beside its plain twin, fp32
    SDPA (`fp32_times`: the fair call and the `enable_gqa` one), the TF32
    bound, the 3 x TF32 and FFMA ceilings (K4 also as graph replays of one
    launch: its device time), and the SASS of the bodies on the tensor
    cores (`f32_sass`); then fp32 q over int8, fp8
    and int4 pools (K4q / K8q's fp32 instantiations: fp32_quant's checks
    and times, ModelConfig.tiny() served from each pool against a direct
    paged_forward loop, and the TinyLlama serve again from an int8
    pool)."""
    import numpy as np
    from flash_attn_v100_tpu_torch import ModelConfig
    from flash_attn_v100_tpu_torch.ops import kvcache as kv_mod
    t0 = time.perf_counter()
    errs = {}
    dense = None
    for i, shape in enumerate(((TRAIN_B, TRAIN_S, 32, 4, 64),
                               (2, 256, 4, 2, 32), (1, 512, 8, 2, 128),
                               (1, 256, 4, 2, 256))):
        res, inputs = fp32_dense(torch, *shape, seed=SEED + 10 + i)
        if i == 0:
            errs.update(res)
            dense = inputs
        else:
            for n, r in res.items():   # the worst over the shapes
                if r["err"] - r["gate"] > errs[n]["err"] - errs[n]["gate"]:
                    errs[n] = r
    v_res, v_launches, varlen = fp32_varlen(torch, TRAIN_B, TRAIN_S, 32, 4,
                                            64)
    errs.update(v_res)
    k8_res, k8 = fp32_k8(torch)
    k4_res, k4 = fp32_k4(torch)
    errs.update(k8_res)
    errs.update(k4_res)
    t_check = time.perf_counter() - t0
    times = fp32_times(torch, flush, dense, varlen, k8, k4)
    del dense, varlen, k8, k4
    gc.collect()
    torch.cuda.empty_cache()
    from flash_attn_v100_tpu_torch.ops.cuda import build
    sass = f32_sass(build)
    # fp32 q over quantized pools: K4q / K8q's fp32 instantiations
    quant_occ = fp32_quant_occupancy(build)
    quant = fp32_quant(torch, flush)
    gc.collect()
    torch.cuda.empty_cache()

    # (2) the path at full width, then ModelConfig.tiny()
    t1 = time.perf_counter()
    cfg = ModelConfig.tinyllama_1b(dtype=torch.float32, n_layers=FP32_LAYERS)
    train = None
    try:
        train, params = fp32_train(torch, cfg, FP32_TRAIN_B, "TinyLlama-1.1B")
    except torch.cuda.OutOfMemoryError:
        pass
    if train is None:   # outside the handler, so its frames are freed
        gc.collect()
        torch.cuda.empty_cache()
        print(f"fp32 TinyLlama-1.1B train: B {FP32_TRAIN_B} x {TRAIN_S} "
              f"does not fit; cut to B {FP32_TRAIN_B // 2}", flush=True)
        train, params = fp32_train(torch, cfg, FP32_TRAIN_B // 2,
                                   "TinyLlama-1.1B")
    rng = np.random.default_rng(SEED)
    prompts = ([rng.integers(1, cfg.vocab_size, LONG_LEN).tolist()
                for _ in range(N_LONG)]
               + [rng.integers(1, cfg.vocab_size, n).tolist()
                  for n in SHORT_LENS])
    with torch.no_grad():
        params = {k_: (v_.detach() if k_ != "layers" else
                       [{n: t.detach() for n, t in lp.items()} for lp in v_])
                  for k_, v_ in params.items()}
        serve = fp32_serve(torch, params, cfg, "TinyLlama-1.1B", prompts,
                           N_NEW)
        serve_int8 = fp32_serve(torch, params, cfg, "TinyLlama-1.1B",
                                prompts, N_NEW, kind="int8")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    tiny = ModelConfig.tiny()
    tiny_train, tparams = fp32_train(torch, tiny, 2, "ModelConfig.tiny")
    trng = np.random.default_rng(SEED + 1)
    tprompts = [trng.integers(1, tiny.vocab_size, n).tolist()
                for n in (100, 70, 9)]
    # the tiny model's prefills reach K8 at this many q rows (group 2 x 64
    # tokens); the engine's route rule is otherwise unchanged
    saved = kv_mod.VARLEN_PREFILL_MIN_ROWS
    kv_mod.VARLEN_PREFILL_MIN_ROWS = 128
    try:
        with torch.no_grad():
            tparams = {k_: (v_.detach() if k_ != "layers" else
                            [{n: t.detach() for n, t in lp.items()}
                             for lp in v_]) for k_, v_ in tparams.items()}
            tiny_serve = fp32_serve(torch, tparams, tiny, "ModelConfig.tiny",
                                    tprompts, 8, page_size=128,
                                    num_pages=16)
    finally:
        kv_mod.VARLEN_PREFILL_MIN_ROWS = saved
    del tparams
    quant_launches = {kind: fp32_quant_tiny(torch, kind)
                      for kind in QUANT_KINDS}
    t_path = time.perf_counter() - t1
    print(f"fp32: kernel checks {t_check:.1f} s, times "
          f"{t1 - t0 - t_check:.1f} s, paths {t_path:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = {"K1": train["launches"]["K1"], "K2": train["launches"]["K2"],
                "K3": train["launches"]["K3"], **v_launches,
                "K4": serve["launches"]["decode"],
                "K8": serve["launches"]["varlen"]}
    return dict(errs=errs, times=times, launches=launches, train=train,
                serve=serve, tiny_train=tiny_train, tiny_serve=tiny_serve,
                quant=quant, quant_launches=quant_launches,
                quant_occupancy=quant_occ, serve_int8=serve_int8, sass=sass)


PAR_WORLD = 4
PAR_TIMEOUT_S = 420
# (c) serves at TinyLlama width with max_seq_len cut to 1024: on seq 2 the
# shard boundary is then at 512 tokens, so the 512-token prompts fill shard
# 0 and their decode appends land on shard 1
PAR_MAX_SEQ = 1024
# (c)'s logits gate, derived: the unsharded kernel path is held to 2 d of
# the fp32-plain-attention logits (ENGINE_LOGITS_GATE; d: the bf16-plain
# logits' distance, two bf16-rounded attention products a layer); the
# model-axis all-reduce rounds each of the 2 partial sums of the o- and
# down-projections to bf16 before adding them, one more bf16 rounding of
# each of the 2 sublayer outputs a layer, no more roundings than d counts:
# another 2 d.  Quantized pools: d is the twins' distance with P unrounded.
PAR_LOGITS_MULT, PAR_LOGITS_ATOL = 4.0, 1e-5
PAR_SERVE_RUNS = (("seq 2 x model 2, bf16 pool", (1, 2, 2), None),
                  ("seq 2 x model 2, int8 pool", (1, 2, 2), "int8"),
                  ("model 2 (tensor parallel only), bf16 pool", (1, 1, 2),
                   None))


def _par_turns(torch, dist, fn):
    """fn() on each rank in turn, the others waiting at a barrier: a time
    taken alone on the card.  Returns this rank's result."""
    out = None
    for r in range(dist.get_world_size()):
        dist.barrier()
        if dist.get_rank() == r:
            out = fn()
            torch.cuda.synchronize()
    dist.barrier()
    return out


@contextlib.contextmanager
def _plain_kvcache():
    """flash_attn_with_kvcache's K4 call routed to the plain twin (fp32
    products), merged as the kernel merges."""
    from flash_attn_v100_tpu_torch.ops import kvcache as kv
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec

    def merged(*a, **k):
        o, lse = dec.merge_partials(*dec.paged_decode_attention_ref(*a, **k))
        return o.to(a[0].dtype), lse
    saved = kv.paged_decode_attention_merged
    kv.paged_decode_attention_merged = merged
    try:
        yield
    finally:
        kv.paged_decode_attention_merged = saved


def _par_decode(torch, dist):
    """(a) The 32k-context decode (B 8, 32 / 8 heads x 128, page 512) with
    the context sharded over seq 4: each rank holds a quarter of every
    sequence's pages; rank 0 also runs the unsharded call and the fp32
    oracle."""
    from flash_attn_v100_tpu_torch.ops import kvcache as kv
    from flash_attn_v100_tpu_torch.ops import quant
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
    from flash_attn_v100_tpu_torch.parallel import (
        SEQ_AXIS, flash_attn_with_kvcache_sharded, make_mesh,
        merge_lse_across)
    rank = dist.get_rank()
    mesh = make_mesh(seq=PAR_WORLD)
    s = mesh.index(SEQ_AXIS)
    res = {}
    for kind in (None, "int8"):
        ggen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        q, kc, vc, kw, nbytes = long_decode_case(torch, ggen, kind)
        tbl, lens = kw["block_table"], kw["cache_seqlens"]
        mp = tbl.shape[1] // PAR_WORLD
        B = tbl.shape[0]
        # this rank's pages (table columns [s mp, (s + 1) mp)), renumbered
        cols = tbl[:, s * mp:(s + 1) * mp].reshape(-1).long()
        local = [x[:, cols].contiguous() for x in (kc, vc)]
        sc = {}
        if kind is not None:
            sc = dict(k_scales=kw["k_scales"][:, cols].contiguous(),
                      v_scales=kw["v_scales"][:, cols].contiguous())
        tbl_l = torch.arange(B * mp, dtype=torch.int32,
                             device="cuda").reshape(B, mp)
        launches0 = (dec.paged_decode_attention.launches,
                     dict(dec.paged_decode_attention.quant_launches))
        out, lse = flash_attn_with_kvcache_sharded(
            q, *local, mesh, lens, block_table=tbl_l, causal=True,
            return_softmax_lse=True, **sc)
        torch.cuda.synchronize()
        n_launch = (dec.paged_decode_attention.launches - launches0[0]
                    if kind is None else
                    dec.paged_decode_attention.quant_launches[kind]
                    - launches0[1][kind])
        # this rank's K4 call alone, as flash_attn_with_kvcache_sharded
        # makes it (no append: cache_seqlens is the shard's live rows)
        N_shard = mp * kc.shape[2]
        cs_l = (lens - s * N_shard).clamp(0, N_shard)

        def local_call():
            return kv.flash_attn_with_kvcache(
                q, *local, cache_seqlens=cs_l, block_table=tbl_l,
                causal=True, kv_cache_layout="HND", return_softmax_lse=True,
                q_position_lens=lens - s * N_shard, **sc)
        t_local = _par_turns(torch, dist, lambda: graph_ms(torch, local_call))
        o_l, lse_l = local_call()
        lse_t = lse_l.permute(0, 2, 1)[..., None].contiguous()
        o_f = o_l.float()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(20):
            merge_lse_across(o_f, lse_t, mesh, SEQ_AXIS)
        torch.cuda.synchronize()
        t_merge = (time.perf_counter() - t0) / 20 * 1e3
        r = dict(local_ms=t_local, merge_ms=t_merge, launches=n_launch,
                 local_bound_ms=nbytes / PAR_WORLD / HBM_BYTES_PER_S * 1e3)
        if rank == 0:
            full = dict(kw, return_softmax_lse=True)
            out_u, lse_u = kv.flash_attn_with_kvcache(q, kc, vc, **full)
            r["unsharded_ms"] = graph_ms(
                torch, lambda: kv.flash_attn_with_kvcache(q, kc, vc, **full))
            r["unsharded_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            # the fp32 oracle: the plain twin in fp32 over the float (or
            # dequantized) pools
            if kind is None:
                fk, fv = kc.float(), vc.float()
            else:
                fk = quant.dequantize_kv(kc, kw["k_scales"], torch.float32)
                fv = quant.dequantize_kv(vc, kw["v_scales"], torch.float32)
            okw = {n: x for n, x in full.items()
                   if n not in ("k_scales", "v_scales")}
            with _plain_kvcache():
                o32, lse32 = kv.flash_attn_with_kvcache(q.float(), fk, fv,
                                                        **okw)
            del fk, fv
            name = f"parallel (a) seq-sharded 32k decode, {kind or 'bf16'}"
            err, gate = gated(torch, out, o32, out_u, f"{name} out")
            row = gated_rows(torch, out, o32, out_u, f"{name} out", 2.0)[0]
            lerr, lgate = gated(torch, lse, lse32, lse_u, f"{name} lse")
            oracle_err = float((out.float() - o32).abs().max())
            if kind is not None:
                assert oracle_err <= QUANT_ORACLE_GATE[kind], oracle_err
            r.update(max_abs_err=err, gate=gate, row_ratio=row, lse_err=lerr,
                     lse_gate=lgate, oracle_err=oracle_err,
                     unsharded_err=float((out_u.float() - o32).abs().max()))
        res[kind or "bf16"] = r
        del q, kc, vc, kw, local, sc, out, lse
        torch.cuda.empty_cache()
    return res


def _par_dense(torch, dist):
    """(b) flash_attn_func_sharded at the headline prefill shape on model
    4: each rank's 8 heads bit-equal to the unsharded K1's same heads."""
    from flash_attn_v100_tpu_torch import flash_attn_func
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.parallel import (
        MODEL_AXIS, flash_attn_func_sharded, make_mesh)
    mesh = make_mesh(model=PAR_WORLD)
    c = mesh.index(MODEL_AXIS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    B, S, Hq, Hk, D = 4, 4096, 32, 8, 128
    q = torch.randn((B, S, Hq, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((B, S, Hk, D), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    n0 = dfwd.flash_attn_dense_fwd.launches
    out = flash_attn_func_sharded(q, k, v, mesh, causal=True)
    torch.cuda.synchronize()
    launches = dfwd.flash_attn_dense_fwd.launches - n0
    hl = Hq // PAR_WORLD
    ref = flash_attn_func(q, k, v, causal=True)[:, :, c * hl:(c + 1) * hl]
    t = _par_turns(torch, dist, lambda: time_ms(
        torch, lambda: flash_attn_func_sharded(q, k, v, mesh, causal=True)))
    return dict(bit_equal=bool(torch.equal(out, ref)), launches=launches,
                heads=(c * hl, (c + 1) * hl), ms=t)


def _par_serve(torch, dist):
    """(c) ServingEngine(mesh=) at TinyLlama width (22 layers, random
    weights from SEED) serving phase_engine's traffic on each of
    PAR_SERVE_RUNS; ranks outside a run's mesh wait for it."""
    from flash_attn_v100_tpu_torch import ModelConfig, ServingEngine
    from flash_attn_v100_tpu_torch.models.transformer import (
        init_params, shard_params)
    from flash_attn_v100_tpu_torch.parallel import make_mesh
    from flash_attn_v100_tpu_torch.runtime import engine as eng_mod
    cfg = ModelConfig.tinyllama_1b(max_seq_len=PAR_MAX_SEQ)
    res = {}
    for label, shape, kind in PAR_SERVE_RUNS:
        mesh = make_mesh(*shape)
        if mesh.is_member:
            full = init_params(cfg, seed=SEED, device="cuda", lm_head=True)
            params = shard_params(full, cfg, mesh)
            del full
            torch.cuda.empty_cache()
            eng = ServingEngine(
                params, cfg, max_batch=N_LONG + len(SHORT_LENS),
                num_pages=NUM_PAGES, page_size=PAGE_SIZE, device="cuda",
                mesh=mesh,
                kv_dtype=None if kind is None else quant_dtype(torch, kind))
            real_pf, cap = eng_mod.paged_forward, {}

            def spy(*a, **kw):
                out = real_pf(*a, **kw)
                if "logits" not in cap and a[3].shape[1] > 1:
                    cap["logits"] = out[0][:N_LONG].cpu()
                return out
            reset_serving_counts()
            eng_mod.paged_forward = spy
            try:
                out, rids, (t0, t_a, t_b), (tok_a, tok_b) = serve_traffic(
                    torch, eng, cfg)
            finally:
                eng_mod.paged_forward = real_pf
            launches, twins, other = serving_counts(kind)
            ttfts = [eng.ttft(r) for r in rids]
            res[label] = dict(
                coords=mesh.coords, launches=launches, twin_calls=twins,
                other=other, calls=dict(eng_mod.paged_forward.calls),
                tokens=[out[r] for r in rids], logits=cap["logits"],
                ttft_p50_ms=statistics.median(ttfts) * 1e3,
                decode_tok_s=(tok_b - tok_a) / (t_b - t_a),
                pool_shape=tuple(eng.k_pool.shape))
            del eng, params
            torch.cuda.empty_cache()
        dist.barrier()
    return res


def _parallel_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase_parallel: (a), (b) and (c) in turn; its results
    go to tmp/rank<rank>.pkl."""
    import pickle
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    try:
        res = dict(decode=_par_decode(torch, dist),
                   dense=_par_dense(torch, dist),
                   serve=_par_serve(torch, dist))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def phase_parallel(torch, eng, eng_q):
    """The sharded paths on PAR_WORLD ranks sharing the card (gloo): (a)
    the seq-sharded 32k decode, bf16 and int8, against the unsharded call
    and the fp32 oracle; (b) head-sharded K1 at the headline shape, bit
    for bit per head; (c) the sharded serving engine at TinyLlama width
    against phase_engine's run (`eng`; `eng_q`: phase_engine_quant's).
    The kernels are the parent's build; a rank that fails fails the
    phase."""
    import pickle
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_parallel_rank, args=(PAR_WORLD, tmp),
                                 nprocs=PAR_WORLD, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + PAR_TIMEOUT_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"phase_parallel: ranks still running "
                                   f"after {PAR_TIMEOUT_S} s")
        ranks = []
        for r in range(PAR_WORLD):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    tag = (f"parallel ({PAR_WORLD} processes on one card, gloo; times "
           f"are theirs, not a multi-card system's)")
    print(f"{tag}: ranks done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    res = dict(decode={}, serve={})
    for kind in ("bf16", "int8"):
        r0 = ranks[0]["decode"][kind]
        per = [r["decode"][kind] for r in ranks]
        assert all(p["launches"] == 1 for p in per), [p["launches"]
                                                      for p in per]
        print(f"parallel (a) seq-sharded 32k decode, {kind} (B {LONG_B}, "
              f"{LONG_HQ}/{LONG_HK} heads x {LONG_D}, page 512, seq "
              f"{PAR_WORLD} x model 1): merged out max_abs_err vs the fp32 "
              f"oracle {r0['max_abs_err']:.3e} <= gate {r0['gate']:.3e} (2 x "
              f"the unsharded call's {r0['unsharded_err']:.3e} + 1e-5; each "
              f"shard's output is rounded to bf16 before the merge, as the "
              f"JAX package's), worst row err/gate {r0['row_ratio']:.3f} "
              f"(gated_rows, mult 2), lse "
              f"{r0['lse_err']:.3e} <= {r0['lse_gate']:.3e}"
              + ("" if kind == "bf16" else
                 f", oracle gate {QUANT_ORACLE_GATE[kind]}"), flush=True)
        print(f"parallel (a) {kind}: per rank K4{'' if kind == 'bf16' else 'q'}"
              f" device ms (graph replay, alone on the card) "
              f"{[round(p['local_ms'], 4) for p in per]}, bound "
              f"{r0['local_bound_ms']:.4f} ms each (bytes); unsharded "
              f"{r0['unsharded_ms']:.4f} ms, bound "
              f"{r0['unsharded_bound_ms']:.4f} ms; LSE merge (gloo, host "
              f"clock) ms {[round(p['merge_ms'], 3) for p in per]}",
              flush=True)
        res["decode"][kind] = dict(r0, local_ms=[p["local_ms"] for p in per],
                                   merge_ms=[p["merge_ms"] for p in per])
    dense = [r["dense"] for r in ranks]
    for d in dense:
        assert d["bit_equal"], f"heads {d['heads']}: not bit-equal to K1"
        assert d["launches"] == 1, d
    print(f"parallel (b) head-sharded K1 (B 4 x S 4096, 32/8 heads x 128, "
          f"causal, bf16, model {PAR_WORLD}): every rank's heads "
          f"{[d['heads'] for d in dense]} bit-equal to the unsharded K1's, "
          f"1 launch a rank; ms a call alone on the card "
          f"{[round(d['ms'], 4) for d in dense]}", flush=True)
    res["dense_ms"] = [d["ms"] for d in dense]
    for label, shape, kind in PAR_SERVE_RUNS:
        runs = [r["serve"][label] for r in ranks if label in r["serve"]]
        assert len(runs) == shape[0] * shape[1] * shape[2], label
        ref = eng if kind is None else eng_q[kind]
        seq_sharded = shape[1] > 1
        for r in runs:
            assert len(r["tokens"]) == len(ref["tokens"]) and all(
                len(t) == N_NEW for t in r["tokens"]), label
            assert r["twin_calls"] == [0, 0], (label, r["twin_calls"])
            assert r["other"] == 0, (label, r["other"])
            assert r["launches"]["decode"] > 0, (label, r["launches"])
            if seq_sharded:
                assert r["launches"]["varlen"] == 0, (label, r["launches"])
            else:
                assert r["launches"]["varlen"] > 0, (label, r["launches"])
            assert r["tokens"] == runs[0]["tokens"], "ranks disagree"
        first = ref["first_prefill"]
        err, gate = gated(torch, runs[0]["logits"], first["plain"],
                          first["plain_y"],
                          f"parallel (c) {label} first prefill logits",
                          PAR_LOGITS_MULT, PAR_LOGITS_ATOL)
        vs_kernel = float((runs[0]["logits"] - first["logits"]).abs().max())
        same = sum(a == b for x, y in zip(runs[0]["tokens"], ref["tokens"])
                   for a, b in zip(x, y))
        total = sum(len(x) for x in ref["tokens"])
        # each request's tokens up to its first difference: greedy decoding
        # of random weights (flat logits) forks on a rounding, after which
        # the rest of the request differs
        prefix = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                       len(x)) for x, y in zip(runs[0]["tokens"],
                                                ref["tokens"])]
        print(f"parallel (c) TinyLlama width, {label}, max_seq_len "
              f"{PAR_MAX_SEQ}: first prefill logits max_abs_err vs the "
              f"fp32-plain-attention logits {err:.3e} <= gate {gate:.3e} "
              f"({PAR_LOGITS_MULT:g} x the "
              f"{'bf16-plain' if kind is None else 'P-unrounded twin'} "
              f"distance + {PAR_LOGITS_ATOL:g}), vs the unsharded kernel "
              f"path's logits {vs_kernel:.3e}; greedy tokens identical to "
              f"phase_engine's {same}/{total}, each request's up to its first "
              f"difference {prefix}; TTFT p50 "
              f"{statistics.median(r['ttft_p50_ms'] for r in runs):.2f} ms, "
              f"decode {statistics.median(r['decode_tok_s'] for r in runs):.1f}"
              f" tok/s ({PAR_WORLD} processes on one card)", flush=True)
        for r in runs:
            print(f"parallel (c) {label} rank {r['coords']}: launches "
                  f"{r['launches']} (K4{'' if kind is None else 'q'} decode "
                  f"route, K8{'' if kind is None else 'q'} varlen route), "
                  f"plain twin calls {r['twin_calls']}, forward calls "
                  f"{r['calls']}, pool {r['pool_shape']}", flush=True)
        res["serve"][label] = dict(
            logits_err=err, gate=gate, vs_kernel=vs_kernel,
            tokens_same=same, tokens_total=total, same_prefix=prefix,
            launches=[r["launches"] for r in runs],
            ttft_p50_ms=[r["ttft_p50_ms"] for r in runs],
            decode_tok_s=[r["decode_tok_s"] for r in runs])
    print(f"{tag}: {time.perf_counter() - t0:.1f} s in all", flush=True)
    return res


# ------------------------------------------------ sequence-parallel training

# phase_ring runs on its own RING_WORLD gloo processes on the one card, as
# phase_parallel does; its times are four processes sharing one card.
RING_WORLD = 4
RING_TIMEOUT_S = 480
# (a), (b): the headline head shape over seq 4 (2048 rows a rank), bf16
RING_B, RING_S, RING_HQ, RING_HK, RING_D = 1, 8192, 32, 8, 128
RING_WINDOW = (4096, 0)
RING_LAYOUTS = (("contiguous causal", dict(causal=True)),
                ("zigzag causal", dict(causal=True, layout="zigzag")),
                ("contiguous causal, window (4096, 0)",
                 dict(causal=True, window_size=RING_WINDOW)))
# (c): TinyLlama-1.1B width at RT_LAYERS layers (its 22 cut for the smoke's
# time limit), B 2 x 2049 tokens (1024 rows a rank after the shift), two
# AdamW steps (the second from the first's update and optimizer state)
# through make_train_step(mesh=) on seq 2 x model 2
RT_MESH, RT_B, RT_S, RT_STEPS, RT_LAYERS = (1, 2, 2), 2, 2048, 2, 8


def ring_config():
    """(c)'s model: TinyLlama-1.1B's widths cut to RT_LAYERS layers (the
    depth of 22 cut for the smoke's time limit)."""
    from flash_attn_v100_tpu_torch import ModelConfig
    return ModelConfig.tinyllama_1b(n_layers=RT_LAYERS)
# (c)'s step-1 loss gate, derived before the first chip run (PERF.md §6):
# phase_train holds the unsharded kernel path's mean loss to max(2
# d + 1e-5, 3 s / sqrt(n)) of the fp32-plain-attention mean (d: the
# bf16-plain-attention mean's distance from it; s: the std of the bf16
# token errors, n tokens), and the sharded path gets twice that.  The
# reasoning behind the factor, that the sharded path adds no more bf16
# roundings than d counts, proved wrong on the chip (PERF.md §6): d counts
# attention's precision alone, while a model axis splits the o- and
# down-projections' sums into bf16 partial products summed in bf16 (the
# cause split RT_SPLIT puts the gap on the model axis), so the floor term
# sets this gate.
RT_LOSS_MULT, RT_LOSS_ATOL, RT_FLOOR_MULT = 4.0, 1e-5, 2.0
# (c)'s step-1 gradient gate, derived the same way before the chip run that
# first tested it (PERF.md §6): the reference's gates hold a kernel's
# gradients to 3x (utils/testing.py BWD_MULT) the bf16 plain version's
# error, and the sharded path gets twice the kernel's allowance.  Per leaf,
# on each rank's shard: |G - G32| <= 6 |G16 - G32| (Frobenius norms), with
# G32 / G16 the unsharded step-1 gradients through the plain attention in
# fp32 / bf16.
RT_GRAD_MULT = 6.0
# (c)'s cause split: the same step on a seq-only and a model-only mesh of
# the first two ranks
RT_SPLIT = ((1, 2, 1), (1, 1, 2))
# (c)'s negative controls: one step under each planted fault, which the
# gates must catch
RT_FAULTS = ("past chunk dropped", "gradient sum skipped")
# (d): one make_lora_train_step(mesh=) step on RT_MESH at (c)'s width,
# batch and base weights: rank-8 adapters on wq/wk/wv/wo (phase_lora's),
# B drawn N(0, RL_B_STD) so that A has a gradient too; the loss and each
# adapter's gradient against the unsharded LoRA step's under (c)'s gates,
# and the planted fault: the adapter gradients' sum over "model" dropped
RL_B_STD = 0.01
RL_FAULT = "adapter gradients' model sum dropped"


def ring_launches(kw, r, n=RING_WORLD, c=RING_S // RING_WORLD) -> int:
    """K1 (and K2, K3) launches of rank r in one causal ring pass: zigzag
    one a step; contiguous one for each step s <= r (the chunk lies in the
    past), less the chunks wholly behind a left window w (s c > c - 1 + w,
    parallel/ring.py::_step_plan)."""
    if kw.get("layout") == "zigzag":
        return n
    w = kw.get("window_size", (-1, -1))[0]
    return sum(1 for s in range(r + 1) if w < 0 or s * c <= c - 1 + w)


def ring_inputs(torch):
    """(a) and (b)'s global q, k, v, dout: bf16 on the card, from SEED."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    B, S, Hq, Hk, D = RING_B, RING_S, RING_HQ, RING_HK, RING_D
    return [torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((B, S, Hq, D), (B, S, Hk, D),
                                      (B, S, Hk, D), (B, S, Hq, D))]


def ring_train_tokens(torch, cfg):
    gen = torch.Generator().manual_seed(SEED + 22)
    return torch.randint(0, cfg.vocab_size, (RT_B, RT_S + 1),
                         generator=gen).to("cuda")


def _ring_attn(torch, dist):
    """(a) ring_attention on seq RING_WORLD, each layout forward and
    backward twice: the first pass's launch counts and this rank's blocks
    (output, dq, dk, dv rows), the second pass's host times."""
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.parallel import (
        SEQ_AXIS, local_shard, make_mesh, ring_attention, zigzag_shard)
    mesh = make_mesh(seq=RING_WORLD)
    s = mesh.index(SEQ_AXIS)
    m = RING_S // RING_WORLD
    rows = slice(s * m, (s + 1) * m)
    q, k, v, do = ring_inputs(torch)
    res = {}
    for label, kw in RING_LAYOUTS:
        xs = [zigzag_shard(t, RING_WORLD) if kw.get("layout") == "zigzag"
              else t for t in (q, k, v, do)]
        qg, kg, vg = (t.clone().requires_grad_(True) for t in xs[:3])
        dol = local_shard(xs[3], (None, SEQ_AXIS), mesh)
        r = dict(times=[])
        for it in range(2):
            for t in (qg, kg, vg):
                t.grad = None
            torch.cuda.synchronize()
            dist.barrier()
            _reset_counts(dfwd, dbwd)
            t0 = time.perf_counter()
            out = ring_attention(qg, kg, vg, mesh, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fwd = _kernel_counts(dfwd, dbwd)
            _reset_counts(dfwd, dbwd)
            out.backward(dol)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            bwd = _kernel_counts(dfwd, dbwd)
            r["times"].append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
            if it == 0:
                r.update(fwd=fwd, bwd=bwd, out=out.detach().cpu(),
                         grads=[t.grad[:, rows].cpu() for t in (qg, kg, vg)])
        res[label] = r
        del qg, kg, vg, out
    return res


def _ring_ulysses(torch, dist):
    """(b) ulysses_attention on seq RING_WORLD: this rank's output rows
    and gradient rows against the unsharded flash_attn_func's, bit for
    bit, and its K1-K3 launches."""
    from flash_attn_v100_tpu_torch import flash_attn_func
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.parallel import (
        SEQ_AXIS, local_shard, make_mesh, ulysses_attention)
    mesh = make_mesh(seq=RING_WORLD)
    s = mesh.index(SEQ_AXIS)
    m = RING_S // RING_WORLD
    rows = slice(s * m, (s + 1) * m)
    q, k, v, do = ring_inputs(torch)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    torch.cuda.synchronize()
    dist.barrier()
    _reset_counts(dfwd, dbwd)
    t0 = time.perf_counter()
    out = ulysses_attention(qg, kg, vg, mesh, causal=True)
    out.backward(local_shard(do, (None, SEQ_AXIS), mesh))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = _kernel_counts(dfwd, dbwd)
    qu, ku, vu = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = flash_attn_func(qu, ku, vu, causal=True)
    ref.backward(do)
    equal = [torch.equal(out, ref[:, rows])] + [
        torch.equal(a.grad[:, rows], b.grad[:, rows])
        for a, b in zip((qg, kg, vg), (qu, ku, vu))]
    return dict(counts=counts, bit_equal=equal, ms=ms)


def _rt_leaf_names(params):
    """param_leaves' order, by name."""
    names = [k for k in ("embed", "ln_f", "lm_head") if k in params]
    for i, lp in enumerate(params["layers"]):
        names += [f"layers.{i}.{k}" for k in sorted(lp)]
    return names


def _rt_as_params(params, leaves):
    """`leaves` (param_leaves' order) in `params`' dict structure."""
    it = iter(leaves)
    out = {k: next(it) for k in ("embed", "ln_f", "lm_head") if k in params}
    out["layers"] = [{k: next(it) for k in sorted(lp)}
                     for lp in params["layers"]]
    return out


@contextlib.contextmanager
def _patched(obj, attr, value):
    saved = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


def _rt_fault(name):
    """One of RT_FAULTS, patched in this process alone: the ring's past
    chunks dropped (each rank attends its own chunk only), or the
    gradients' sum over data and seq skipped."""
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.parallel import ring as ring_mod
    if name is None:
        return contextlib.nullcontext()
    if name == RT_FAULTS[0]:
        plan = ring_mod._step_plan
        return _patched(ring_mod, "_step_plan",
                        lambda cfg, s, c: (None, plan(cfg, s, c)[1]))
    return _patched(tm, "all_reduce_flat", lambda *a: None)


def _ring_train(torch, dist, tmp):
    """(c) make_train_step(mesh=) at TinyLlama-1.1B width.  First one step
    at learning rate 0 under each of RT_FAULTS on RT_MESH and on each mesh
    of RT_SPLIT: its loss and each leaf's step-1 gradient error against the
    unsharded fp32-attention gradient (tmp/g32.pt, this rank's shard of
    it).  Then RT_STEPS AdamW steps on RT_MESH: each step's loss, host time
    and K1-K3 launches, the step-1 gradient errors, and the peak memory."""
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.parallel import make_mesh
    cfg = ring_config()
    full = tm.init_params(cfg, seed=SEED, device="cuda", lm_head=True)
    g32 = torch.load(f"{tmp}/g32.pt", mmap=True)
    tokens = ring_train_tokens(torch, cfg)

    def shard(mesh):
        params = tm.shard_params(full, cfg, mesh)
        for t in tm.param_leaves(params):
            t.requires_grad_(True)
        return params

    def grad_errs(params, mesh):
        """Each leaf's |G - G32| / |G32| on this rank's shard."""
        errs = []
        for t, r in zip(tm.param_leaves(params),
                        tm.param_leaves(tm.shard_params(g32, cfg, mesh))):
            r = r.to("cuda", torch.float32)
            errs.append(float((t.grad.float() - r).norm() / r.norm()))
        return errs

    def probe(mesh, fault=None):
        """One step at learning rate 0 (the parameters stay as they are)."""
        if not mesh.is_member:
            return None
        params = shard(mesh)
        step, init_opt = tm.make_train_step(
            cfg, optimizer=lambda lv: torch.optim.SGD(lv, lr=0.0), mesh=mesh)
        with _rt_fault(fault):
            loss = float(step(params, init_opt(params), tokens)[0])
        res = dict(loss=loss, grad_err=grad_errs(params, mesh),
                   coords=mesh.coords)
        for t in tm.param_leaves(params):
            t.grad = None
        return res

    mesh = make_mesh(*RT_MESH)
    out = dict(faults={f: probe(mesh, f) for f in RT_FAULTS})
    out["split"] = {}
    for shape in RT_SPLIT:
        out["split"][shape] = probe(make_mesh(*shape))
        dist.barrier()
    # the AdamW run last: it updates the replicated leaves, which its shard
    # shares with `full`, in place
    params = shard(mesh)
    del full
    torch.cuda.empty_cache()
    step, init_opt = tm.make_train_step(cfg, mesh=mesh)
    opt = init_opt(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, counts = [], [], []
    for i in range(RT_STEPS):
        dist.barrier()
        _reset_counts(dfwd, dbwd)
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, tokens)
        losses.append(float(loss))            # syncs
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts.append(_kernel_counts(dfwd, dbwd))
        if i == 0:    # the check's own copies stay out of the peak
            peak = torch.cuda.max_memory_allocated()
            out["grad_err"] = grad_errs(params, mesh)
            torch.cuda.reset_peak_memory_stats()
    peak = max(peak, torch.cuda.max_memory_allocated())
    return dict(out, coords=mesh.coords, losses=losses, step_s=secs,
                counts=counts, peak_gb=peak / 1e9)


def _rl_setup(torch, tmp):
    """(d)'s model, adapter config and tokens, and the adapters of
    tmp/lora.pt on the card, requiring grad."""
    from flash_attn_v100_tpu_torch.integrations import lora as lora_mod
    cfg = ring_config()
    lora = torch.load(f"{tmp}/lora.pt")
    lora = dict(layers=[{n: {k: t.cuda().requires_grad_(True)
                             for k, t in ab.items()} for n, ab in ad.items()}
                        for ad in lora["layers"]])
    return cfg, lora_mod.LoraConfig(), lora, ring_train_tokens(torch, cfg)


def _ring_lora(torch, dist, tmp):
    """(d) one make_lora_train_step(mesh=) AdamW step on RT_MESH: the loss,
    each adapter's gradient (on the host), the K1-K3 launches; then the
    same step with RL_FAULT planted: its loss and gradients."""
    from flash_attn_v100_tpu_torch.integrations import lora as lora_mod
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.parallel import make_mesh
    from flash_attn_v100_tpu_torch.parallel.mesh import (
        DATA_AXIS, SEQ_AXIS, all_reduce_flat)
    mesh = make_mesh(*RT_MESH)
    cfg, lcfg, _, tokens = _rl_setup(torch, tmp)
    shard = tm.shard_params(tm.init_params(cfg, seed=SEED, device="cuda",
                                           lm_head=True), cfg, mesh)

    def no_model_sum(lora, mesh_):
        all_reduce_flat([t.grad for t in lora_mod.lora_leaves(lora)], mesh_,
                        (DATA_AXIS, SEQ_AXIS))

    out = {}
    for label, fault in (("step", None), ("fault", no_model_sum)):
        lora = _rl_setup(torch, tmp)[2]
        step, init_opt = lora_mod.make_lora_train_step(cfg, lcfg, mesh=mesh)
        opt = init_opt(lora)
        dist.barrier()
        _reset_counts(dfwd, dbwd)
        t0 = time.perf_counter()
        with (contextlib.nullcontext() if fault is None else
              _patched(lora_mod, "reduce_lora_grads", fault)):
            loss = float(step(lora, opt, shard, tokens)[0])
        torch.cuda.synchronize()
        out[label] = dict(loss=loss, s=time.perf_counter() - t0,
                          counts=_kernel_counts(dfwd, dbwd),
                          grads=[t.grad.cpu() for t in
                                 lora_mod.lora_leaves(lora)])
        del lora, opt
    return dict(out, coords=mesh.coords)


def _ring_lora_reference(torch, tmp):
    """(d)'s unsharded reference, in this process before the spawn: the
    adapters (lora_init's, B drawn N(0, RL_B_STD)) go to tmp/lora.pt; the
    token losses and adapter gradients of lora_loss through the kernels
    and through the plain attention in fp32 and bf16; then one unsharded
    make_lora_train_step AdamW step."""
    from flash_attn_v100_tpu_torch.integrations import lora as lora_mod
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops import flash_attention as fa_mod
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    cfg = ring_config()
    lcfg = lora_mod.LoraConfig()
    params = tm.init_params(cfg, seed=SEED, device="cuda", lm_head=True)
    lora = lora_mod.lora_init(params, lcfg, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    with torch.no_grad():
        for ad in lora["layers"]:
            for ab in ad.values():
                ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen,
                                          device="cuda") * RL_B_STD)
    torch.save(dict(layers=[{n: {k: t.detach().cpu() for k, t in ab.items()}
                             for n, ab in ad.items()}
                            for ad in lora["layers"]]), f"{tmp}/lora.pt")
    leaves = lora_mod.lora_leaves(lora)
    tokens = ring_train_tokens(torch, cfg)

    def losses_and_grads():
        eff = lora_mod.materialize(params, lora, lcfg)
        logp = torch.log_softmax(tm.forward(eff, tokens[:, :-1], cfg),
                                 dim=-1)
        tok = -logp.gather(-1, tokens[:, 1:, None].to(torch.long))[..., 0]
        return tok.detach(), torch.autograd.grad(tok.mean(), leaves)

    tok_k, g_k = losses_and_grads()
    with _plain_attention(fa_mod, dfwd, dbwd, True):
        tok32, g32 = losses_and_grads()
    with _plain_attention(fa_mod, dfwd, dbwd, False):
        tok16, g16 = losses_and_grads()

    def rel(grads):
        return [float((g.float() - r.float()).norm() / r.float().norm())
                for g, r in zip(grads, g32)]

    step, init_opt = lora_mod.make_lora_train_step(cfg, lcfg)
    loss = float(step(lora, init_opt(lora), params, tokens)[0])
    e16_tok = (tok16 - tok32).double()
    names = [f"layers.{i}.{n}.{k}" for i, ad in enumerate(lora["layers"])
             for n in sorted(ad) for k in ("a", "b")]
    res = dict(loss=loss, mean_k=float(tok_k.double().mean()),
               mean32=float(tok32.double().mean()),
               mean16=float(tok16.double().mean()),
               floor=3.0 * float(e16_tok.std()) / e16_tok.numel() ** 0.5,
               e16=rel(g16), e_k=rel(g_k), g32=[g.cpu() for g in g32],
               names=names)
    del params, lora, leaves, g_k, g32, g16
    return res


def _ring_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase_ring: (a), (b) and (c) in turn; its results go
    to tmp/rank<rank>.pkl."""
    import pickle
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    try:
        res = dict(attn=_ring_attn(torch, dist))
        torch.cuda.empty_cache()
        res["ulysses"] = _ring_ulysses(torch, dist)
        torch.cuda.empty_cache()
        res["train"] = _ring_train(torch, dist, tmp)
        torch.cuda.empty_cache()
        res["lora"] = _ring_lora(torch, dist, tmp)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _ring_oracle(torch, q, k, v, do, params, upcast):
    """The plain forward and backward one kv head's group at a time (a
    full 8192^2 fp32 score matrix for 32 heads does not fit the card):
    upcast, in fp32 over fp32 copies of the inputs; else in their bf16."""
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    g = q.shape[2] // k.shape[2]
    scale = q.shape[-1] ** -0.5
    parts = []
    for j in range(k.shape[2]):
        xs = (q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1],
              v[:, :, j:j + 1], do[:, :, j * g:(j + 1) * g])
        if upcast:
            xs = [t.float() for t in xs]
        o, lse = dfwd.flash_attn_dense_fwd_ref(*xs[:3], scale, params,
                                               upcast=upcast)
        grads = dbwd.flash_attn_dense_bwd_ref(*xs[:3], o, xs[3], lse, scale,
                                              params, upcast=upcast)
        parts.append([o, *grads])
        del o, lse, grads
    return [torch.cat([p[i] for p in parts], dim=2) for i in range(4)]


def _ring_train_reference(torch, tmp):
    """(c)'s unsharded run in this process, before the spawn: the first
    batch's token losses and step-1 gradients through the kernels and
    through the plain attention in fp32 and bf16 (the gates; the fp32
    gradients go to tmp/g32.pt for the ranks, and each leaf's errors are
    taken on every shard of a model axis of RT_MESH or RT_SPLIT), then
    RT_STEPS AdamW steps of make_train_step on the same weights and
    batch."""
    import numpy as np
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops import flash_attention as fa_mod
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.parallel.mesh import AXES, Mesh
    cfg = ring_config()
    params = tm.init_params(cfg, seed=SEED, device="cuda", lm_head=True)
    leaves = tm.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tokens = ring_train_tokens(torch, cfg)

    def token_losses_and_grads():
        logp = torch.log_softmax(tm.forward(params, tokens[:, :-1], cfg),
                                 dim=-1)
        tok = -logp.gather(-1, tokens[:, 1:, None].to(torch.long))[..., 0]
        return tok.detach(), torch.autograd.grad(tok.mean(), leaves)

    tok_k, g_k = token_losses_and_grads()
    with _plain_attention(fa_mod, dfwd, dbwd, True):
        tok32, g32 = token_losses_and_grads()
    with _plain_attention(fa_mod, dfwd, dbwd, False):
        tok16, g16 = token_losses_and_grads()
    torch.save(_rt_as_params(params, [g.cpu() for g in g32]),
               f"{tmp}/g32.pt")

    def cut(grads, mesh):
        return tm.param_leaves(tm.shard_params(
            _rt_as_params(params, grads), cfg, mesh))

    def rel(grads, refs):
        return [float((g.float() - r.float()).norm() / r.float().norm())
                for g, r in zip(grads, refs)]

    # {(model axis size, model index): each leaf's error on that shard}
    e16, e_k = {}, {}
    for tp in sorted({shape[2] for shape in (RT_MESH,) + RT_SPLIT}):
        for j in range(tp):
            mesh = Mesh(np.arange(tp).reshape(1, 1, tp), j,
                        dict.fromkeys(AXES))
            r = cut(g32, mesh)
            e16[tp, j], e_k[tp, j] = rel(cut(g16, mesh), r), rel(
                cut(g_k, mesh), r)
    del g_k, g32, g16
    step, init_opt = tm.make_train_step(cfg)
    opt = init_opt(params)
    losses, secs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(RT_STEPS):
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, tokens)
        losses.append(float(loss))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    e16_tok = (tok16 - tok32).double()
    res = dict(losses=losses, step_s=secs,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               mean_k=float(tok_k.double().mean()),
               mean32=float(tok32.double().mean()),
               mean16=float(tok16.double().mean()),
               floor=3.0 * float(e16_tok.std()) / e16_tok.numel() ** 0.5,
               e16=e16, e_k=e_k, names=_rt_leaf_names(params))
    del params, opt, tokens, tok_k, tok32, tok16, e16_tok, leaves
    return res


def ring_lora_check(torch, ranks, ref, t_ref, launches):
    """(d): every rank's LoRA step against the unsharded reference: the
    loss within (c)'s loss gate rule of the fp32-plain-attention mean, each
    adapter's gradient within RT_GRAD_MULT x the bf16-plain gradient's
    distance from the fp32-plain one; the planted RL_FAULT must fail the
    gradient gate.  Adds (d)'s K1-K3 launches to `launches`."""
    runs = [r["lora"] for r in ranks]
    d16 = abs(ref["mean16"] - ref["mean32"])
    gate = max(RT_LOSS_MULT * d16 + RT_LOSS_ATOL,
               RT_FLOOR_MULT * ref["floor"])

    def held(label):
        losses = {r[label]["loss"] for r in runs}
        assert len(losses) == 1, (label, losses)
        err = abs(runs[0][label]["loss"] - ref["mean32"])
        ratios = [((g.float() - r).norm().item() / r.norm().item()
                   / (RT_GRAD_MULT * e16), name, run["coords"])
                  for run in runs
                  for g, r, e16, name in zip(run[label]["grads"], ref["g32"],
                                             ref["e16"], ref["names"])]
        w = max(ratios, key=lambda x: x[0])
        ok = (err <= gate, all(x[0] <= 1.0 for x in ratios))
        print(f"ring (d) LoRA {label}: loss {runs[0][label]['loss']:.6f}, "
              f"err {err:.3e} {'<=' if ok[0] else '>'} gate {gate:.3e}; "
              f"adapter gradients {'held' if ok[1] else 'NOT held'}: worst "
              f"{w[1]} on {w[2]} at {w[0]:.2f} of its gate (median "
              f"{statistics.median(x[0] for x in ratios):.2f})", flush=True)
        return ok

    for r in runs:
        want = RT_LAYERS * ring_launches(dict(causal=True),
                                         r["coords"]["seq"], n=RT_MESH[1])
        c = r["step"]["counts"]
        assert (c["K1"], c["K2"], c["K3"]) == (want,) * 3, (r["coords"], c)
        assert c["plain_fwd"] == c["plain_bwd"] == 0, (r["coords"], c)
    print(f"ring (d) make_lora_train_step(mesh=) on seq {RT_MESH[1]} x model "
          f"{RT_MESH[2]}, TinyLlama-1.1B width (bf16), B {RT_B} x "
          f"{RT_S + 1}, rank 8 on wq/wk/wv/wo ({len(ref['names'])} adapter "
          f"tensors, B ~ N(0, {RL_B_STD:g})): the unsharded LoRA step's "
          f"loss {ref['loss']:.6f}, fp32-plain mean {ref['mean32']:.6f}, "
          f"kernel mean {ref['mean_k']:.6f}, its worst adapter gradient "
          f"{max(a / b for a, b in zip(ref['e_k'], ref['e16'])):.2f} x the "
          f"bf16-plain's; reference {t_ref:.1f} s", flush=True)
    ok = held("step")
    assert all(ok), f"ring (d) LoRA step gates {ok}"
    bad = held("fault")
    assert not bad[1], f"ring (d): the gradient gate missed '{RL_FAULT}'"
    print(f"ring (d) negative control '{RL_FAULT}' (planted in the ranks): "
          f"caught by the gradient gate", flush=True)
    for n in ("K1", "K2", "K3"):
        launches[n]["(d) a LoRA step, per rank (seq, model)"] = [
            [r["coords"]["seq"], r["coords"]["model"], r["step"]["counts"][n]]
            for r in runs]
    for r in runs:
        print(f"ring (d) rank {r['coords']}: K1 = K2 = K3 = "
              f"{r['step']['counts']['K1']} launches, plain twins 0; step "
              f"{r['step']['s'] * 1e3:.1f} ms (host clock)", flush=True)


def phase_ring(torch):
    """The sequence-parallel training path on RING_WORLD gloo ranks sharing
    the card: (a) ring_attention at the headline head shape over seq 4,
    three layouts, forward and backward, against the fp32 oracle within
    the reference's gates, with each rank's exact K1-K3 launches; (b)
    ulysses_attention at the same shape, bit-equal to the unsharded K1-K3
    per head; (c) make_train_step(mesh=) at TinyLlama-1.1B width on seq 2 x
    model 2 against the unsharded run (made here first): the step-1 loss
    and each leaf's step-1 gradient within their derived gates, K1-K3
    launches a step; the same step on a seq-only and a model-only mesh
    (the cause split) within the same gates; and one step under each
    planted fault of RT_FAULTS, which the gates must catch; (d) one
    make_lora_train_step(mesh=) step on the same mesh, weights and batch
    against the unsharded LoRA step (ring_lora_check), with its planted
    fault.  Plain twins are never called in a rank.  Returns the launch
    counts for the kernels line."""
    import pickle
    import tempfile
    import torch.multiprocessing as mp
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.parallel import zigzag_unshard
    from flash_attn_v100_tpu_torch.utils import testing as tt
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref = _ring_train_reference(torch, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        t_rl = time.perf_counter()
        rl_ref = _ring_lora_reference(torch, tmp)
        t_rl = time.perf_counter() - t_rl
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"ring: unsharded (c) reference done in "
              f"{time.perf_counter() - t0:.1f} s; card memory before the "
              f"spawn: {free / 1e9:.2f} GB free of {total / 1e9:.2f} GB",
              flush=True)
        ctx = mp.start_processes(_ring_rank, args=(RING_WORLD, tmp),
                                 nprocs=RING_WORLD, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + RING_TIMEOUT_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"phase_ring: ranks still running after "
                                   f"{RING_TIMEOUT_S} s")
        ranks = []
        for r in range(RING_WORLD):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    tag = (f"ring ({RING_WORLD} processes on one card, gloo; times are "
           f"theirs, not a multi-card system's)")
    print(f"{tag}: ranks done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {"K1": {}, "K2": {}, "K3": {}}

    # (a): each layout's blocks put together, against the oracles
    q, k, v, do = ring_inputs(torch)
    oracles = {}
    shape = (f"B {RING_B} x {RING_S}, {RING_HQ}/{RING_HK} heads x "
             f"{RING_D}, bf16, seq {RING_WORLD}")
    for label, kw in RING_LAYOUTS:
        w = kw.get("window_size", (-1, -1))
        key = tuple(w)
        if key not in oracles:
            params = masklib.MaskParams(causal=True, window_left=w[0],
                                        window_right=w[1])
            oracles.clear()
            torch.cuda.empty_cache()
            oracles[key] = (_ring_oracle(torch, q, k, v, do, params, True),
                            _ring_oracle(torch, q, k, v, do, params, False))
        r32, r16 = oracles[key]
        per = [r["attn"][label] for r in ranks]
        for i, p in enumerate(per):
            want = ring_launches(kw, i)
            assert (p["fwd"]["K1"], p["bwd"]["K2"], p["bwd"]["K3"]) == (
                want, want, want), (label, i, p["fwd"], p["bwd"], want)
            assert p["fwd"]["K2"] == p["fwd"]["K3"] == p["bwd"]["K1"] == 0
            assert all(p[d][n] == 0 for d in ("fwd", "bwd")
                       for n in ("plain_fwd", "plain_bwd")), (label, p)
        got = [torch.cat([p["out"] for p in per], 1).cuda()] + [
            torch.cat([p["grads"][i] for p in per], 1).cuda()
            for i in range(3)]
        if kw.get("layout") == "zigzag":
            got = [zigzag_unshard(t, RING_WORLD) for t in got]
        errs = []
        for name, g, a, b, mult, atol in zip(
                ("out", "dq", "dk", "dv"), got, r32, r16,
                (tt.FWD_MULT,) + (tt.BWD_MULT,) * 3,
                (tt.FWD_ATOL,) + (tt.BWD_ATOL,) * 3):
            e, gate = gated(torch, g, a, b, f"ring (a) {label} {name}", mult,
                            atol)
            errs.append(f"{name} {e:.3e} <= {gate:.3e} ({e / gate:.2f} of "
                        f"the gate)")
        del got
        for n, d in (("K1", "fwd"), ("K2", "bwd"), ("K3", "bwd")):
            launches[n][f"(a) {label}"] = [p[d][n] for p in per]
        counts = launches["K1"][f"(a) {label}"]
        print(f"ring (a) {label} ({shape}): vs the fp32 oracle (head groups "
              f"in turn), gates 2x / 3x the bf16 oracle's error + 1e-5 / "
              f"1e-4: {'; '.join(errs)}; K1 = K2 = K3 launches per rank "
              f"{counts} (exact), plain twins 0; ms fwd / bwd per rank "
              f"(host clock, synchronised, 2nd pass) "
              f"{[tuple(round(x, 1) for x in p['times'][-1]) for p in per]}",
              flush=True)
    del oracles, q, k, v, do
    torch.cuda.empty_cache()

    # (b) Ulysses
    uly = [r["ulysses"] for r in ranks]
    for i, u in enumerate(uly):
        assert all(u["bit_equal"]), (i, u["bit_equal"])
        c = u["counts"]
        assert (c["K1"], c["K2"], c["K3"]) == (1, 1, 1), (i, c)
        assert c["plain_fwd"] == c["plain_bwd"] == 0, (i, c)
    for n in launches:
        launches[n]["(b) ulysses"] = [u["counts"][n] for u in uly]
    print(f"ring (b) ulysses_attention ({shape}, causal): every rank's "
          f"output and dq, dk, dv rows bit-equal to the unsharded "
          f"flash_attn_func's (K1-K3 on {RING_HQ // RING_WORLD} q / "
          f"{RING_HK // RING_WORLD} kv heads a rank over the full sequence); "
          f"K1 = K2 = K3 = 1 launch a rank, plain twins 0; ms fwd + bwd per "
          f"rank (host clock) {[round(u['ms'], 1) for u in uly]}",
          flush=True)

    # (c) the sharded training step against the unsharded run
    runs = [r["train"] for r in ranks]
    for r in runs:
        want = RT_LAYERS * ring_launches(dict(causal=True),
                                         r["coords"]["seq"], n=RT_MESH[1])
        for c in r["counts"]:
            assert (c["K1"], c["K2"], c["K3"]) == (want,) * 3, (
                r["coords"], c)
            assert c["plain_fwd"] == c["plain_bwd"] == 0, (r["coords"], c)
        assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
        assert r["losses"] == runs[0]["losses"], "ranks disagree on the loss"
    d16 = abs(ref["mean16"] - ref["mean32"])
    gate = max(RT_LOSS_MULT * d16 + RT_LOSS_ATOL, RT_FLOOR_MULT * ref["floor"])

    def held(label, tp, res):
        """One step-1 run's member ranks (loss, grad_err, coords) against
        the loss gate and each leaf's gradient gate; prints and returns
        whether each gate held."""
        assert len({r["loss"] for r in res}) == 1, (label, res)
        err = abs(res[0]["loss"] - ref["mean32"])
        ratios = [(e / (RT_GRAD_MULT * e16), name, r["coords"], e, e16)
                  for r in res for name, e, e16 in zip(
                      ref["names"], r["grad_err"],
                      ref["e16"][tp, r["coords"]["model"]])]
        w = max(ratios, key=lambda x: x[0])
        ok = (err <= gate, all(x[0] <= 1.0 for x in ratios))
        print(f"ring (c) {label}: step-1 loss {res[0]['loss']:.6f}, err "
              f"{err:.3e} {'<=' if ok[0] else '>'} gate {gate:.3e}; "
              f"gradients {'held' if ok[1] else 'NOT held'}: worst leaf "
              f"{w[1]} on {w[2]}, |G - G32| / |G32| {w[3]:.3e} against "
              f"{RT_GRAD_MULT:g} x the bf16-plain's {w[4]:.3e} "
              f"({w[0]:.2f} of the gate; median over leaves and ranks "
              f"{statistics.median(x[0] for x in ratios):.2f})", flush=True)
        return ok

    print(f"ring (c) make_train_step(mesh=) at TinyLlama-1.1B width "
          f"({RT_LAYERS} layers, reduced from 22; bf16), B {RT_B} x "
          f"{RT_S + 1} tokens: the step-1 loss "
          f"against the fp32-plain-attention mean {ref['mean32']:.6f}, gate "
          f"max({RT_LOSS_MULT:g} x the bf16-plain mean's distance "
          f"{d16:.3e} + {RT_LOSS_ATOL:g}, {RT_FLOOR_MULT:g} x 3 std / "
          f"sqrt(n) {ref['floor']:.3e}); unsharded kernel path "
          f"{ref['mean_k']:.6f} (its step-1 loss {ref['losses'][0]:.6f}, "
          f"err {abs(ref['mean_k'] - ref['mean32']):.3e}; its worst leaf "
          f"gradient error "
          f"{max(a / b for a, b in zip(ref['e_k'][1, 0], ref['e16'][1, 0])):.2f}"
          f" x the bf16-plain's)", flush=True)
    main_ok = held(f"seq {RT_MESH[1]} x model {RT_MESH[2]}", RT_MESH[2],
                   [dict(loss=r["losses"][0], grad_err=r["grad_err"],
                         coords=r["coords"]) for r in runs])
    assert all(main_ok), f"ring (c) step-1 gates {main_ok}"
    for shape in RT_SPLIT:
        res = [r["train"]["split"][shape] for r in ranks]
        ok = held(f"cause split, seq {shape[1]} x model {shape[2]} (ranks "
                  f"0-1)", shape[2], [x for x in res if x is not None])
        assert all(ok), f"ring (c) seq {shape[1]} x model {shape[2]}: {ok}"
    for fault in RT_FAULTS:
        ok = held(f"negative control, {fault} (planted in the ranks)",
                  RT_MESH[2], [r["train"]["faults"][fault] for r in ranks])
        assert not all(ok), f"ring (c): the gates missed '{fault}'"
    for n in launches:
        launches[n]["(c) a step, per rank (seq, model)"] = [
            [r["coords"]["seq"], r["coords"]["model"], r["counts"][0][n]]
            for r in runs]
    ring_lora_check(torch, ranks, rl_ref, t_rl, launches)
    print(f"ring (c) losses sharded {[round(x, 6) for x in runs[0]['losses']]}"
          f" vs unsharded {[round(x, 6) for x in ref['losses']]}; unsharded "
          f"step {[round(x * 1e3, 1) for x in ref['step_s']]} ms, peak "
          f"{ref['peak_gb']:.2f} GB", flush=True)
    for r in runs:
        print(f"ring (c) rank {r['coords']}: K1 = K2 = K3 = "
              f"{r['counts'][0]['K1']} launches a step ({RT_LAYERS} layers x "
              f"{r['coords']['seq'] + 1} ring steps), plain twins 0; step "
              f"times {[round(x * 1e3, 1) for x in r['step_s']]} ms, peak "
              f"memory {r['peak_gb']:.2f} GB", flush=True)
    print(f"{tag}: {time.perf_counter() - t0:.1f} s in all", flush=True)
    return dict(launches=launches)


# ------------------------------------------------------ integrations

# TinyLlama-1.1B's published config.json (huggingface.co/TinyLlama/
# TinyLlama-1.1B-intermediate-step-1431k-3T), the fields an HF checkpoint
# carries; the HF-import run reads them from a plain object
TINYLLAMA_CONFIG_JSON = dict(
    architectures=["LlamaForCausalLM"], attention_bias=False, bos_token_id=1,
    eos_token_id=2, hidden_act="silu", hidden_size=2048,
    initializer_range=0.02, intermediate_size=5632,
    max_position_embeddings=2048, model_type="llama",
    num_attention_heads=32, num_hidden_layers=22, num_key_value_heads=4,
    pretraining_tp=1, rms_norm_eps=1e-05, rope_scaling=None,
    rope_theta=10000.0, tie_word_embeddings=False, torch_dtype="bfloat16",
    use_cache=True, vocab_size=32000)
# the port's parameter names -> HF Llama's module names
HF_PROJ = dict(wq="self_attn.q_proj", wk="self_attn.k_proj",
               wv="self_attn.v_proj", wo="self_attn.o_proj",
               w1="mlp.gate_proj", w3="mlp.up_proj", w2="mlp.down_proj")
HF_NORM = dict(ln1="input_layernorm", ln2="post_attention_layernorm")


def hf_state_dict(torch, params):
    """The port's params as an HF LlamaForCausalLM state dict on the CPU:
    HF's names, each projection transposed back to (out, in), contiguous,
    as a checkpoint loads."""
    def host(t, transpose=False):
        return (t.t() if transpose else t).contiguous().cpu()

    state = {"model.embed_tokens.weight": host(params["embed"]),
             "model.norm.weight": host(params["ln_f"]),
             "lm_head.weight": host(params["lm_head"], True)}
    for i, lp in enumerate(params["layers"]):
        for k, name in HF_PROJ.items():
            state[f"model.layers.{i}.{name}.weight"] = host(lp[k], True)
        for k, name in HF_NORM.items():
            state[f"model.layers.{i}.{name}.weight"] = host(lp[k])
    return state


def phase_hf_serve(torch, cfg, bf16):
    """HF import, then serving: init_params' weights as an HF state dict on
    the CPU and TinyLlama's config.json fields in a plain object go through
    convert_hf_model onto the card; every tensor must equal init_params',
    and the engine runs' traffic served from them (K8, then K4) must give
    `bf16`'s (phase_engine's) greedy tokens and launch counts."""
    import types
    from flash_attn_v100_tpu_torch.integrations.huggingface import (
        convert_hf_model)
    from flash_attn_v100_tpu_torch.models import transformer as tm

    params = tm.init_params(cfg, seed=SEED, device="cuda", lm_head=True)
    state = hf_state_dict(torch, params)
    hf_config = types.SimpleNamespace(**TINYLLAMA_CONFIG_JSON)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params_hf, cfg_hf = convert_hf_model(state, hf_config, device="cuda")
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in state.values())
    del state
    assert cfg_hf == cfg, (cfg_hf, cfg)
    assert sorted(params_hf) == sorted(params)
    assert all(sorted(a) == sorted(b) for a, b in zip(params_hf["layers"],
                                                      params["layers"]))
    leaves = list(zip(tm.param_leaves(params_hf), tm.param_leaves(params)))
    for a, b in leaves:
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b), "a converted tensor differs"
    del params

    eng = make_engine(torch, params_hf, cfg_hf)
    reset_serving_counts()
    out, rids, (_, t_a, t_b), (tok_a, tok_b) = serve_traffic(
        torch, eng, cfg_hf)
    launches, twin_calls, other = serving_counts()
    tokens = [out[r] for r in rids]
    same = sum(a == b for a, b in zip(tokens, bf16["tokens"]))
    assert tokens == bf16["tokens"], (
        f"{len(tokens) - same} of {len(tokens)} requests' greedy tokens "
        "differ from phase_engine's")
    assert launches == bf16["launches"], (launches, bf16["launches"])
    assert launches["decode"] > 0 and launches["varlen"] > 0, launches
    assert twin_calls == [0, 0] and other == 0, (twin_calls, other)
    ttft_p50_ms = statistics.median(eng.ttft(r) for r in rids) * 1e3
    decode_tok_s = (tok_b - tok_a) / (t_b - t_a)
    print(f"hf_serve: convert_hf_model of a {len(TINYLLAMA_CONFIG_JSON)}-field "
          f"TinyLlama config.json namespace and a {n_bytes / 1e9:.2f} GB HF "
          f"state dict on the CPU -> the card in {conv_s:.2f} s; "
          f"{len(leaves)} tensors torch.equal to init_params'; ModelConfig "
          f"equal to ModelConfig.tinyllama_1b()", flush=True)
    print(f"hf_serve: {len(rids)} requests, greedy tokens identical to "
          f"phase_engine's ({same} of {len(rids)} x {N_NEW}); kernel "
          f"launches {launches} (phase_engine's {bf16['launches']}), plain "
          f"twin calls {twin_calls}; TTFT p50 {ttft_p50_ms:.2f} ms, steady "
          f"decode {decode_tok_s:.1f} tok/s", flush=True)


LORA_STEPS = 4


def phase_lora(torch, cfg, train):
    """LoRA fine-tuning at TinyLlama-1.1B width (rank 8, alpha 16 on wq,
    wk, wv, wo; AdamW lr 2e-4, no weight decay) for LORA_STEPS steps at
    the training run's B 4 x S 2048 through K1-K3, then one profiled step.
    The base is frozen (digests before and after), A stays bit-equal at
    the first step (B = 0 makes dL/dA exactly 0), every B moves, and the
    first step's adapter gradients pass the gradient gate against the same
    gradients through the plain attention versions (fp32 and bf16).
    `train` is phase_train's result, printed beside."""
    from flash_attn_v100_tpu_torch.integrations import lora as lora_mod
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops import flash_attention as fa_mod
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.utils import testing as tt

    dev = torch.device("cuda")
    params = tm.init_params(cfg, seed=SEED, device=dev, lm_head=True)
    base = tm.param_leaves(params)
    assert not any(t.requires_grad for t in base)
    digests = [digest(torch, t) for t in base]
    lcfg = lora_mod.LoraConfig()
    lora = lora_mod.lora_init(params, lcfg, seed=SEED, device=dev)
    leaves = lora_mod.lora_leaves(lora)
    start = [t.detach().clone() for t in leaves]
    tokens = train_tokens(torch, cfg, dev)
    step, init_opt = lora_mod.make_lora_train_step(cfg, lcfg)
    opt = init_opt(lora)
    n_adapter = sum(t.numel() for t in leaves)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(dfwd, dbwd)
    losses, secs = [], []
    for i in range(LORA_STEPS):
        t0 = time.perf_counter()
        loss, lora, opt = step(lora, opt, params, tokens)
        losses.append(float(loss))            # syncs
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == 0:
            grads = [t.grad.detach().clone() for t in leaves]
            a_kept = all(torch.equal(a, a0) for a, a0 in
                         zip(leaves[0::2], start[0::2]))
    counts = _kernel_counts(dfwd, dbwd)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    L = cfg.n_layers
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
    for name in ("K1", "K2", "K3"):
        assert counts[name] == L * LORA_STEPS, counts
    assert counts["plain_fwd"] == 0 and counts["plain_bwd"] == 0, counts
    assert a_kept, "an A moved at the first step (dL/dA must be 0 there)"
    assert all(torch.count_nonzero(g) == 0 for g in grads[0::2])
    moved = [bool(torch.count_nonzero(b)) for b in leaves[1::2]]
    assert all(moved), f"{moved.count(False)} B's did not move"
    assert all(t.grad is None and not t.requires_grad for t in base)
    after = [digest(torch, t) for t in base]
    assert after == digests, (f"{sum(a != b for a, b in zip(after, digests))}"
                              " base leaves changed")
    step_ms = statistics.median(secs[1:]) * 1e3
    tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)

    # the first step's adapter gradients again, from the initial adapters
    # (lora_init is deterministic), through the plain attention versions
    ref = lora_mod.lora_init(params, lcfg, seed=SEED, device=dev)
    assert all(torch.equal(a, b) for a, b in
               zip(lora_mod.lora_leaves(ref), start))

    def adapter_grads():
        return torch.autograd.grad(
            lora_mod.lora_loss(ref, params, tokens, cfg, lcfg),
            lora_mod.lora_leaves(ref))

    with _plain_attention(fa_mod, dfwd, dbwd, True):
        g32 = adapter_grads()
    with _plain_attention(fa_mod, dfwd, dbwd, False):
        g16 = adapter_grads()
    # the gradients of a loss averaged over B x S tokens are small: the atol
    # is scaled by the largest |ref| where that is below 1, as in
    # replay_layer0
    names = [f"layer {i} {n}.{k}" for i, ad in enumerate(ref["layers"])
             for n in sorted(ad) for k in ("a", "b")]
    worst = (0.0, None, 0.0, 0.0)
    for name, g, r32, r16 in zip(names, grads, g32, g16):
        ref_max = float(r32.abs().max())
        err, gate = gated(torch, g, r32, r16, f"lora first-step grad {name}",
                          tt.BWD_MULT, tt.BWD_ATOL * min(1.0, ref_max))
        if gate > 0 and err / gate >= worst[0]:
            worst = (err / gate, name, err, gate)
    del g32, g16, ref, grads

    print(f"lora: {L} layers, dim {cfg.dim}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads x {cfg.head_dim}, untied lm_head, {cfg.dtype}; base frozen; "
          f"adapters rank {lcfg.rank}, alpha {lcfg.alpha} on "
          f"{'/'.join(lcfg.targets)} ({n_adapter / 1e6:.2f} M fp32 "
          f"parameters); AdamW(lr 2e-4, wd 0); B {TRAIN_B} x S {TRAIN_S} "
          f"tokens", flush=True)
    print(f"lora: losses {[round(x, 5) for x in losses]}, step times "
          f"{[round(x * 1e3, 1) for x in secs]} ms; step {step_ms:.1f} ms "
          f"(median of steps 2-{LORA_STEPS}), {tok_s:.0f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB (training run: {train['step_ms']:.1f} "
          f"ms, {train['tokens_s']:.0f} tokens/s, {train['peak_gb']:.2f} GB); "
          f"launches per step K1 {counts['K1'] // LORA_STEPS}, K2 "
          f"{counts['K2'] // LORA_STEPS}, K3 {counts['K3'] // LORA_STEPS}; "
          f"plain calls {counts['plain_fwd']} / {counts['plain_bwd']}",
          flush=True)
    print(f"lora: {len(base)} base leaves bit-unchanged (SHA-256 digests); "
          f"every A bit-equal after step 1, every B moved; first-step "
          f"adapter grads vs the plain attention's (fp32 reference, bf16 "
          f"yardstick) within 3x + 1e-4 x min(1, max |ref|): "
          f"{len(names)} leaves, worst err/gate {worst[0]:.3f} at "
          f"{worst[1]} ({worst[2]:.3e} <= {worst[3]:.3e})", flush=True)
    profile_train(torch, lambda: step(lora, opt, params, tokens), tag="lora")


def profile_decode(torch, eng, cfg, prompt_len=64, n_new=25):
    """Where a steady decode step's time goes: one fused window of decode
    steps at full batch, then one more under torch.profiler (CPU + CUDA
    activities) through the package's utils.profiling."""
    import tempfile
    import numpy as np
    from flash_attn_v100_tpu_torch.utils import profiling

    rng = np.random.default_rng(SEED + 2)
    for _ in range(eng.max_batch):
        eng.submit(rng.integers(1, cfg.vocab_size, prompt_len).tolist(),
                   max_new_tokens=n_new)
    eng.step()                                  # prefill
    eng.step()                                  # first (unfused) decode
    windows = []

    def window():
        tok0 = eng.metrics["tokens_generated"]
        t0 = time.perf_counter()
        eng.step()                              # one fused window
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0,
                        eng.metrics["tokens_generated"] - tok0))

    with tempfile.TemporaryDirectory(prefix="fa_trace_") as d:
        profiling.capture_trace(window, iters=1, trace_dir=d)
        rows = profiling.summarize_trace(d)
    eng.run_to_completion()
    wall, n_tok = windows[-1]
    n_steps = n_tok // eng.max_batch
    busy_us = sum(us for _, us, _ in rows)
    res = dict(steps=n_steps, wall_ms_per_step=wall * 1e3 / max(n_steps, 1),
               busy_ms_per_step=busy_us / 1e3 / max(n_steps, 1),
               launches_per_step=sum(n for _, _, n in rows)
               / max(n_steps, 1))
    print(f"decode profile (torch.profiler, batch {eng.max_batch}, one fused "
          f"window of {n_steps} steps): wall {res['wall_ms_per_step']:.3f} "
          f"ms/step, device busy {res['busy_ms_per_step']:.3f} ms/step "
          f"({100 * busy_us / 1e3 / max(wall * 1e3, 1e-9):.1f}%), "
          f"{res['launches_per_step']:.0f} kernel launches/step")
    for name, us, _ in rows[:6]:
        print(f"  {us / 1e3 / max(n_steps, 1):8.3f} ms/step  {name[:90]}")
    return res


# ------------------------------------------------- P1-P4 (cost probes)

PROBE_SHAPES = {
    # (B, Hq, Hk, M, N): the 3-D variants run (B * Hq, M, D) heads
    "P1 own": (1, 1, 1, 1024, 16384),     # one 1024-row block, 16 tiles
    "P2": (4, 32, 8, 4096, 4096),         # K1's headline heads, non-causal
    "P3": (1, 128, 32, 4096, 4096),       # BH 128, kv heads BH / 4
}
INT4_LARGE = 4096
INT4_EDGE = (256, 384, 640)       # a half-empty N tile, K over 5 chunks
INT4_EXTREME = (136, 72, 96)      # partial M, N and K tiles
S4_PEAK = "none listed"   # the H100 data sheet lists no int4 rate
PROBE_ROUNDS, PROBE_REPS = 3, 10


def int4_extremes(torch, dev, M: int, N: int, K: int, seed: int = 2):
    """(a int8 (M, K), b packed int4 (N, K / 2)) with every value -8 or 7,
    so that the int32 sums reach their largest."""
    from flash_attn_v100_tpu_torch.ops.cuda import probe_int4 as p4

    g = torch.Generator().manual_seed(seed)
    a, b = (torch.where(torch.rand(shape, generator=g) < 0.5, -8, 7).to(
        torch.int8) for shape in ((M, K), (N, K)))
    return a.to(dev), p4.pack_int4(b).to(dev)


def probe_replaces(suite: str, probe) -> str:
    """The TPU kernel a probe variant replaces, by the features it has."""
    if suite == "P1":
        return f"benchmarks/prof_softmax_cost.py:{118 if probe.wide else 25}"
    if suite == "P2":
        line = 200 if probe.strided else 147 if probe.pairs else (
            91 if probe.lse else 52)
        return f"benchmarks/prof_fwd_gap.py:{line}"
    line = 129 if probe.dynamic else 171 if probe.branches else 53
    return f"benchmarks/prof_small_streams.py:{line}"


def probe_cases(probes):
    """(suite, name, probe, shape key) of every row: P1's variants at its
    own shape and at P2's, P2's and P3's at theirs."""
    cases = [("P1", n, p, "P1 own") for n, p in probes.P1_VARIANTS.items()]
    cases += [("P1", n, p, "P2") for n, p in probes.P1_VARIANTS.items()]
    cases += [("P2", n, p, "P2") for n, p in probes.P2_VARIANTS.items()]
    cases += [("P3", n, p, "P3") for n, p in probes.P3_VARIANTS.items()]
    return cases


def run_probe_scripts(torch):
    """The probes' main path: the four `python -m` scripts' main()s in this
    process, the launch counts reset just before and read just after."""
    from flash_attn_v100_tpu_torch.benchmarks import (
        prof_fwd_gap, prof_int4_native, prof_small_streams,
        prof_softmax_cost)
    from flash_attn_v100_tpu_torch.ops.cuda import probe_int4 as p4
    from flash_attn_v100_tpu_torch.ops.cuda import probes

    probes.flash_step.launches = 0
    probes.flash_step.variant_launches = {}
    p4.int4_matmul.launches = p4.int8_int4_matmul.launches = 0
    probes.flash_step_ref.calls = 0
    t0 = time.perf_counter()
    for script in (prof_softmax_cost, prof_fwd_gap, prof_small_streams,
                   prof_int4_native):
        script.main()
    torch.cuda.synchronize()
    launches = dict(variants=dict(probes.flash_step.variant_launches),
                    int4=p4.int4_matmul.launches,
                    int8=p4.int8_int4_matmul.launches)
    # (P4's script checks its products against the twin, as the TPU
    # script against numpy)
    assert probes.flash_step_ref.calls == 0, "a probe script ran the twin"
    print(f"probe scripts: {time.perf_counter() - t0:.1f} s, launches "
          f"{launches}", flush=True)
    return launches


def phase_probes(torch, flush):
    """P1-P3 (csrc/probes.cu) and P4 (csrc/probe_int4.cu): each variant's
    SASS holds the tensor-core and exp2 instructions its stages claim;
    every variant against its plain twin at its shapes (out rows within 2
    bf16 ulps of the row's largest |out|, LSE 1e-5 relative, NaN / inf
    masks equal; P4 exactly), timed beside its twin, SDPA (the full
    function at P2's shape) or torch._int_mm (P4) and its bound; the four
    probe scripts run as their main path.  P4's two kernels must hold
    integer wgmma (IGMMA S8.S8) and no mma.sync IMMA in their SASS."""
    from flash_attn_v100_tpu_torch.benchmarks import common
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import probe_int4 as p4
    from flash_attn_v100_tpu_torch.ops.cuda import probes

    counts = probes.sass_counts()
    for flags in probes.VARIANT_FLAGS:
        probe = next(p for d in (probes.P1_VARIANTS, probes.P2_VARIANTS,
                                 probes.P3_VARIANTS)
                     for p in d.values() if p.flags == flags)
        c, (ss, rs) = counts[flags], probes.expected_hgmma(probe)
        print(f"probe SASS F={flags:5d} {'+'.join(probe.stages) or 'qk'}: "
              f"HGMMA ss {c['hgmma_ss']} (S; {ss} claimed), rs "
              f"{c['hgmma_rs']} (P V; {rs}), MUFU.EX2 {c['ex2']} (>= "
              f"{probes.expected_ex2(probe)}); {probes.occupancy(probe)}",
              flush=True)
        assert (c["hgmma_ss"], c["hgmma_rs"]) == (ss, rs), \
            f"F={flags}: tensor-core work deleted or duplicated"
        assert c["ex2"] >= probes.expected_ex2(probe), \
            f"F={flags}: exp2 work deleted"
    sass4 = p4.sass_counts()
    for kind, name in ((p4.KIND_INT4, "int4xint4"), (p4.KIND_INT8,
                                                     "int8xint4")):
        c = sass4.get(kind, dict(igmma_s8=0, igmma=0, imma=0))
        print(f"probe_int4 SASS {name}: IGMMA S8.S8 {c['igmma_s8']} (integer "
              f"wgmma), IGMMA {c['igmma']}, IMMA {c['imma']}", flush=True)
        assert c["igmma_s8"] > 0, f"P4 {name}: no integer wgmma in its SASS"
        assert c["imma"] == 0, f"P4 {name}: an mma.sync (IMMA) is left"
    # ptxas's wgmma notes: C7520 (wgmma serialized) or C7508 (setmaxnreg
    # ignored) would undo the design; C7519 (a warpgroup.arrive injected
    # before a register-fed wgmma) is counted
    for lib in ("probes", "probe_int4"):
        log = build.build_log(lib).splitlines()
        notes = [ln.strip() for ln in log
                 if ("C75" in ln and "C7519" not in ln) or "serializ" in ln]
        print(f"build {lib}: ptxas wgmma / setmaxnreg notes: "
              f"{notes or 'none'}; C7519 x{sum('C7519' in ln for ln in log)}",
              flush=True)

    launches = run_probe_scripts(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data, cases, sdpa_ms = {}, [], {}
    for suite, name, probe, key in probe_cases(probes):
        B, Hq, Hk, M, N = PROBE_SHAPES[key]
        if key not in data:
            data[key] = [torch.randn((B * h, n, 128), generator=gen,
                                     device=dev).to(torch.bfloat16)
                         for h, n in ((Hq, M), (Hk, N), (Hk, N))]
        q, k, v = common.operands(probe, *data[key], B)
        kw = common.stream_kwargs(probe, M, N, dev)
        scale = probes.SCALE if suite == "P1" else probes.SCALE_LOG2
        pairs = (probes.rect_pairs(M // probes.BLOCK_Q, N // probe.bk)
                 if probe.pairs else None)
        call = functools.partial(probes.flash_step, q, k, v, probe, scale,
                                 **kw)
        twin = functools.partial(probes.flash_step_ref, q, k, v, probe,
                                 scale, bk=probe.bk, pairs=pairs, **kw)
        out = call()
        torch.cuda.synchronize()
        ref = twin()
        res = (probes.compare(out[0], ref[0], out[1], ref[1]) if probe.lse
               else probes.compare(out, ref))
        del out, ref
        assert res["ok"], f"{suite} {name} at {key}: {res}"
        plain_ms = time_ms(torch, twin, reps=2, warmup=0)
        library_ms = None
        if probe.full and key != "P1 own":
            if key not in sdpa_ms:
                qs, ks, vs = (x.view(B, -1, *x.shape[-2:])
                              for x in data[key])
                sdpa_ms[key] = time_ms(
                    torch, lambda: torch.nn.functional.
                    scaled_dot_product_attention(qs, ks, vs,
                                                 enable_gqa=True),
                    reps=PROBE_REPS)
            library_ms = sdpa_ms[key]
        flops, nbytes = probes.work(probe, B * Hq, B * Hk, M, N)
        bms, by = bound_ms(nbytes, flops)
        n_launch = launches["variants"].get(probe.flags, 0)
        assert n_launch > 0, f"{suite} {name}: no launch on the probe path"
        cases.append((call, dict(
            name=f"{suite} {name} ({key} shape)", suite=suite,
            flags=probe.flags, source="probes.cu",
            replaces=probe_replaces(suite, probe), launches=n_launch,
            max_abs_err=res["max_abs_err"], gate=res["gate"],
            row_ratio=res["ratio"], lse_rel=res["lse_rel"],
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
            bound_by=by,
            shape=dict(zip("B Hq Hk M N".split(), PROBE_SHAPES[key])),
            sass=counts[probe.flags])))
    # every variant timed in turns: PROBE_ROUNDS rounds of PROBE_REPS
    # launches each (CUDA events around each), the median of the rounds'
    # medians; the spread shows the card's drift
    for _ in range(PROBE_ROUNDS):
        for call, row in cases:
            row.setdefault("ms_repeats", []).append(
                time_ms(torch, call, reps=PROBE_REPS))
    rows = []
    for _, row in cases:
        row["ms"] = statistics.median(row["ms_repeats"])
        print(f"{row['name']}: kernel {row['ms']:.4f} ms (rounds "
              f"{min(row['ms_repeats']):.4f}-{max(row['ms_repeats']):.4f}), "
              f"plain {row['plain_ms']:.1f} ms, sdpa {row['library_ms']}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); out err "
              f"{row['max_abs_err']:.3e} (row err/gate {row['row_ratio']:.2f}"
              f", gate 2 bf16 ulps of the row's top), lse rel "
              f"{row['lse_rel']:.2e}, non-finite masks equal", flush=True)
        rows.append(row)
    del data
    torch.cuda.empty_cache()

    # P4: exact at the TPU script's shape, timed at 4096^3
    from flash_attn_v100_tpu_torch.benchmarks import prof_int4_native
    small = prof_int4_native.operands(dev, 128, 256, 128)
    large = prof_int4_native.operands(dev, INT4_LARGE, INT4_LARGE,
                                      INT4_LARGE)
    lib_a, lib_b = large[0], p4.unpack_int4(large[1])
    library_ms = time_ms(torch, lambda: torch._int_mm(lib_a, lib_b.t()),
                         flush=flush)
    edges = [prof_int4_native.operands(dev, *INT4_EDGE, seed=1),
             int4_extremes(torch, dev, *INT4_EXTREME)]
    for name, fn, twin_fn, pack in (
            ("int4xint4", p4.int4_matmul, p4.int4_matmul_ref, True),
            ("int8xint4", p4.int8_int4_matmul, p4.int8_int4_matmul_ref,
             False)):
        errs = []
        for q8, kp in (small, large, *edges):
            a = p4.pack_int4(q8) if pack else q8
            out = fn(a, kp)
            torch.cuda.synchronize()
            errs.append(int((out - twin_fn(a, kp)).abs().max()))
        assert errs == [0] * 4, f"P4 {name}: not exact {errs}"
        a = p4.pack_int4(large[0]) if pack else large[0]
        ms = time_ms(torch, lambda: fn(a, large[1]), flush=flush)
        small_a = p4.pack_int4(small[0]) if pack else small[0]
        small_ms = graph_ms(torch, lambda: fn(small_a, small[1]))
        plain_ms = time_ms(torch, lambda: twin_fn(a, large[1]), reps=5)
        ops, nbytes = p4.work(INT4_LARGE, INT4_LARGE, INT4_LARGE,
                              4 if pack else 8)
        if pack:   # no int4 rate to bound the operations by
            bms, by = nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
            s8_bound = bound_ms(nbytes, ops, INT8_OPS_PER_S)[0]
        else:
            bms, by = bound_ms(nbytes, ops, INT8_OPS_PER_S)
            s8_bound = bms
        n_launch = launches["int4" if pack else "int8"]
        assert n_launch > 0, f"P4 {name}: no launch on the probe path"
        print(f"P4 {name}: exact at 128x256x128, {INT4_LARGE}^3, "
              f"{'x'.join(map(str, INT4_EDGE))} and "
              f"{'x'.join(map(str, INT4_EXTREME))} (every value -8 or 7); "
              f"{INT4_LARGE}^3 kernel {ms:.4f} ms ({ops / ms / 1e9:.0f} "
              f"TOP/s), plain {plain_ms:.3f} ms, torch._int_mm on the int8 "
              f"unpacked operands {library_ms:.4f} ms, bound {bms:.4f} ms "
              f"({by}; at the int8 rate {s8_bound:.4f}); 128x256x128 "
              f"{small_ms * 1e3:.2f} us as a graph replay", flush=True)
        rows.append(dict(
            name=f"P4 {name} ({INT4_LARGE}^3)", suite="P4",
            source="probe_int4.cu",
            replaces="benchmarks/prof_int4_native.py:20",
            launches=n_launch, max_abs_err=0.0, gate=0.0, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
            bound_by=by, bound_ms_int8_rate=s8_bound,
            ops_peak=S4_PEAK if pack else "1979 TOP/s int8",
            small_graph_ms=small_ms,
            sass=sass4.get(p4.KIND_INT4 if pack else p4.KIND_INT8)))
    return rows


def phase_bench(torch):
    """The port's bench (`python -m flash_attn_v100_tpu_torch.bench`) and
    the three examples, each a subprocess on the card (the examples at
    once, after the bench, beside phase_scripts' multi-process dryrun:
    none of the four is timed): the bench must exit 0 with its JSON line's
    value > 0, each example 0 with its shapes printed; train_seq_parallel
    spawns 2 gloo ranks sharing the card.  Returns the dryrun's output,
    exit code and seconds with the bench's numbers."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "flash_attn_v100_tpu_torch.bench"],
                       capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    for line in r.stderr.strip().splitlines()[-40:]:
        print(f"bench stderr: {line}", flush=True)
    head = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{") and '"metric"' in ln]
    assert r.returncode == 0, f"bench exited {r.returncode}: {r.stdout[-2000:]}"
    assert head and head[-1]["value"] > 0, f"bench printed {r.stdout!r}"
    print(f"bench: {json.dumps(head[-1])} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    want = {"attention_basics": ["dense: (2, 256, 8, 64)",
                                 "varlen: (436, 8, 64) -> (2, 256, 8, 64)",
                                 "decode: (2, 1, 8, 64)"],
            "serve_engine": ["native C++ scheduler: True",
                             "{0: 24, 1: 24, 2: 24, 3: 24, 4: 24, 5: 24}"],
            "train_seq_parallel": ["'seq': 2", "global dq: (2, 1024, 8, 64) "
                                   "finite: True"]}
    # the three examples and the dryrun at once (each mostly start-up;
    # none is timed)
    t1 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"flash_attn_v100_tpu_torch.examples.{name}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in want}
    dry = subprocess.Popen(
        [sys.executable, "-m", DRYRUN], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    secs = {}
    try:
        dry_out, dry_err = dry.communicate(timeout=SCRIPT_TIMEOUT_S)
        dryrun = dict(out=dry_out, err=dry_err, rc=dry.returncode,
                      seconds=time.perf_counter() - t1)
        for name, proc in procs.items():
            out, err = proc.communicate(
                timeout=max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter()
                                                      - t1)))
            secs[name] = time.perf_counter() - t1
            assert proc.returncode == 0, \
                f"{name} exited {proc.returncode}: {err[-2000:]}"
            for want_line in want[name]:
                assert want_line in out, f"{name}: no {want_line!r} in {out!r}"
            print(f"example {name} (done {secs[name]:.1f} s after the four "
                  f"started): {' | '.join(out.strip().splitlines())}",
                  flush=True)
    finally:
        for proc in (*procs.values(), dry):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return dict(headline=head[-1], bench_s=time.perf_counter() - t0,
                example_s=secs, dryrun=dryrun)


# ----------------------------------------- the bench scripts and the dryrun

SCRIPT_TIMEOUT_S = 300
# (script, arguments): bench_serving at its defaults (page 64: the JAX
# route rule sends a prefill to K8 only at pages of a multiple of 128, so
# its prefills take K4's route) and again at page 128, cut to 8 requests of
# 16 new tokens (its 512-token prefills on K8), bench_decode at its
# defaults, bench_lora_sft at its config with 3 steps; the dryrun (DRYRUN)
# at 2 x 4 gloo ranks on the card, run by phase_bench
SCRIPT_RUNS = (("bench_serving", ()),
               ("bench_serving", ("--page-size", "128", "--requests", "8",
                                  "--max-batch", "8", "--gen-len", "16")),
               ("bench_decode", ()),
               ("bench_lora_sft", ("--steps", "3")))
DRYRUN = "flash_attn_v100_tpu_torch.benchmarks.dryrun_multiprocess"
_NUM = r"([-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?)"


def _script_numbers(name, out):
    """The numbers each script's lines report, by name."""
    import re

    def grab(pat, keys):
        found = re.findall(pat, out)
        assert found, f"{name}: no {pat!r} in {out!r}"
        return [dict(zip(keys, map(float, f if isinstance(f, tuple)
                                   else (f,)))) for f in found]
    if name == "bench_serving":
        r = grab(rf"decode: {_NUM} tok/s/chip steady \({_NUM} toks\), "
                 rf"{_NUM} tok/s/chip e2e", ("decode_tok_s", "dec_toks",
                                             "e2e_tok_s"))[0]
        r.update(grab(rf"TTFT p50={_NUM}ms p99={_NUM}ms",
                      ("ttft_p50_ms", "ttft_p99_ms"))[0])
        r.update(grab(rf"launches: K4 {_NUM}, K8 {_NUM}", ("K4", "K8"))[0])
        return r
    if name == "bench_decode":
        return dict(rows=grab(
            rf"ctx=\s*{_NUM} kv=\w+\s+splits={_NUM}: \s*{_NUM} us\s+"
            rf"{_NUM} tok/s/chip\s+{_NUM} GB/s \({_NUM}% of roofline\)",
            ("ctx", "splits", "us", "tok_s", "gbps", "pct")))
    if name == "bench_lora_sft":
        return grab(rf"\d+ steps: {_NUM} ms/step, {_NUM} tok/s, final loss "
                    rf"{_NUM}", ("ms_per_step", "tok_s", "final_loss"))[0]
    assert "dryrun_multiprocess: OK" in out, out
    return grab(rf"step-1 loss {_NUM}, equal", ("loss",))[0]


def phase_scripts(torch, dryrun):
    """The port's bench scripts (bench_serving, bench_decode,
    bench_lora_sft) through their main() in this process, their printed
    lines captured (SCRIPT_RUNS), and the multi-process dryrun's output
    (`dryrun`, phase_bench's run of it as a subprocess on the card): each
    must finish (the dryrun exit 0) with finite numbers on its lines; the
    serving runs' launch counts must show K4, and the page-128 run's K8
    too; no decode rate may pass 3.35 TB/s; the dryrun must print OK.
    Returns each run's numbers and seconds."""
    import importlib
    import io

    res = []
    t0 = time.perf_counter()
    for name, args in SCRIPT_RUNS + (("dryrun_multiprocess", ()),):
        t1 = time.perf_counter()
        if name == "dryrun_multiprocess":   # it launches its own processes
            out = dryrun["out"]
            assert dryrun["rc"] == 0, (
                f"{name} exited {dryrun['rc']}: {dryrun['err'][-3000:]}")
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                importlib.import_module(
                    f"flash_attn_v100_tpu_torch.benchmarks.{name}").main(
                        list(args))
            out = buf.getvalue()
            gc.collect()
            torch.cuda.empty_cache()
        secs = (dryrun["seconds"] if name == "dryrun_multiprocess"
                else time.perf_counter() - t1)
        tag = " ".join((name,) + tuple(args))
        for line in out.strip().splitlines():
            print(f"script {tag}: {line}", flush=True)
        nums = _script_numbers(name, out)
        flat = [v for row in nums.get("rows", [nums]) for v in row.values()]
        assert all(math.isfinite(v) for v in flat), (tag, nums)
        if name == "bench_serving":
            assert nums["K4"] > 0, (tag, nums)
            assert "--page-size" not in args or nums["K8"] > 0, (tag, nums)
        if name == "bench_decode":   # a rate past the card's would miscount
            assert all(r["pct"] <= 100 for r in nums["rows"]), (tag, nums)
        res.append(dict(script=tag, seconds=secs, **nums))
        print(f"script {tag}: {secs:.1f} s", flush=True)
    print(f"scripts: {time.perf_counter() - t0:.1f} s", flush=True)
    return res


# ------------------------------------- the measurement and attribution scripts

# (script, arguments) run in this process through their main(): each at
# its JAX shapes and widths, cut in rounds, chain length, requests, new
# tokens and knob sets (the full runs are calls of their own)
MEASURE_RUNS = (
    ("prof_calibrate", ("--rounds", "2")),
    ("profile_kernels", ("--iters", "1")),
    ("prof_decode_scan", ("--rounds", "1", "--chain", "8")),
    ("prof_decode_int8", ("--rounds", "1")),
    ("prof_int4", ("--chain", "8")),
    ("prof_decode_pagesize", ("--chain", "8")),
    ("prof_int4_rmw", ("--chain", "16")),
    ("prof_decode_attrib", ("--batch", "4", "--fuse", "1", "8",
                            "--new-tokens", "24", "--chain", "8")),
    ("prof_ttft_tail", ("--requests", "6", "--new-tokens", "8",
                        "--configs", "baseline", "int8_290")),
    ("bench_scaling", ("--devices", "2")),
    ("check_ring_overlap", ("--ranks", "2")),
)
# the section's top row of profile_kernels: a port kernel
PROFILE_TOPS = (("K1",), ("K2", "K3"), ("K4",), ("K4q",), ("K5",))


def _decode_rates(rows):
    """Every GB/s a decode script's rows report (calls and device)."""
    return [r[k] for r in rows.values() if r for k in ("call_gbps",
                                                       "device_gbps")
            if k in r]


def _check_measure(name, res):
    """The phase's assertions on one script's result; returns its summary."""
    peak_gbps = HBM_BYTES_PER_S / 1e9
    if name == "prof_calibrate":
        assert res["ok"], res
        assert max(res["sum_gbps"]) <= peak_gbps, res
        assert max(res["matmul_tflops"]) <= BF16_FLOPS_PER_S / 1e12, res
        return dict(gbps=max(res["sum_gbps"]),
                    tflops=max(res["matmul_tflops"]))
    if name == "profile_kernels":
        for sec, tops in zip(res, PROFILE_TOPS):
            assert sec["top"] in tops, (sec["title"], sec["top"], tops)
            assert 0 < sec["share_pct"] <= 100, (sec["title"], sec)
        # each section's port kernels' µs a call: phase_sweeps holds the
        # sweeps' shipped rows to them
        return {sec["title"]: dict(top=sec["top"], us=sec["total_us"],
                                   share_pct=sec["share_pct"],
                                   kernels={n: us for n, us, _ in sec["rows"]
                                            if n.startswith("K")})
                for sec in res}
    if name in ("prof_decode_scan", "prof_decode_int8",
                "prof_decode_pagesize"):
        rows = {k: r for k, r in res.items() if r and "failed" not in r}
        rates = _decode_rates(rows)
        assert rates and all(0 < g <= peak_gbps for g in rates), res
        return {str(k): r.get("device_gbps", r["call_gbps"])
                for k, r in rows.items()}
    if name == "prof_int4":
        rates = _decode_rates({k: res[k] for k in ("int8", "int4")})
        assert all(0 < g <= peak_gbps for g in rates), res
        return dict(speedup=res["speedup"], int8=res["int8"],
                    int4=res["int4"])
    if name == "prof_int4_rmw":
        assert res["equal"], res
        return res
    if name == "prof_decode_attrib":
        busy = res["device"]["busy_s"]
        for r in res["engines"]:
            assert busy <= r["decode_step_s"], (busy, r)
        return dict(device_ms=busy * 1e3,
                    graph_ms=res["device"].get("graph_s", math.nan) * 1e3,
                    engine_ms={r["fuse"]: r["decode_step_s"] * 1e3
                               for r in res["engines"]})
    if name == "prof_ttft_tail":
        for r in res:
            assert r["p50_s"] <= r["p90_s"], r
        return {r["tag"]: (r["p50_s"] * 1e3, r["p90_s"] * 1e3) for r in res}
    if name == "bench_scaling":
        assert {"ring", "decode"} <= set(res["checks"]), res["checks"]
        for c in res["checks"].values():
            assert c["ok"], res["checks"]
        return dict(ring=res["ring"], decode=res["decode"],
                    checks=res["checks"])
    assert name == "check_ring_overlap"
    seen = "; ".join(
        f"rank {r}: windows {rank['windows']}, K1 {rank['kernels']}, "
        f"traces (lane events, K1s) {rank['attempts']}"
        for r, rank in enumerate(res["ranks"]))
    assert res["ok"], f"ring overlap check FAILED: {seen}"
    return dict(steps=res["steps"], overlapped=res["overlapped"],
                ratio=res["ratio"], k1_tflops=res["k1_flops_per_s"] / 1e12,
                traces=[len(rank["attempts"]) for rank in res["ranks"]])


def phase_measure(torch):
    """The port's measurement and attribution scripts (MEASURE_RUNS), each
    through its main() in this process, its lines printed as they come:
    the calibration reads no rate past 3.35 TB/s or 989 TFLOP/s; each
    profile_kernels section's top row is a port kernel, its share of the
    peak <= 100%; no decode rate passes 3.35 TB/s; both int4 appends write
    equal bytes; a decode step's device time is <= the engine's ms a
    decode step; TTFT p50 <= p90 in each knob set; the 2-rank ring and
    head-sharded decode are within their gates of one rank's; each ring
    step's K1 overlaps its shift.  Returns each script's summary and
    seconds."""
    import importlib

    out = {}
    t0 = time.perf_counter()
    for name, args in MEASURE_RUNS:
        mod = importlib.import_module(
            f"flash_attn_v100_tpu_torch.benchmarks.{name}")
        tag = " ".join((name,) + args)
        print(f"measure {tag}:", flush=True)
        t1 = time.perf_counter()
        res = mod.main(list(args))
        summary = _check_measure(name, res)
        secs = time.perf_counter() - t1
        out[name] = dict(seconds=secs, **(summary if isinstance(
            summary, dict) else dict(result=summary)))
        print(f"measure {name}: {secs:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"measure: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ------------------------------------------------ the tile and unroll sweeps

# (script, arguments) run after phase_measure in its fresh process through
# their main(): the JAX shapes, one round, short chains, the shipped rows
# and one or two variants a script (the full sweeps are calls of their
# own; every variant's gates: tests/test_torch_gpu.py).  Two variants fewer
# since the head-dim-32 phases joined the run (K3's bq64 in prof_bwd,
# prof_int4_ablate's int4-qk-one), for its time limit.
SWEEP_RUNS = (
    ("prof_prefill", ("causal", "ceiling", "--rounds", "1", "--chain", "1",
                      "--iters", "1", "--tiles", "bk128")),
    ("prof_varlen", ("bs", "--rounds", "1", "--chain", "1", "--iters", "1",
                     "--tiles", "bk128")),
    ("prof_bwd", ("--rounds", "1", "--chain", "1", "--iters", "1",
                  "--dq-tiles", "bk64", "--dkv-tiles")),
    ("prof_bwd_unroll", ("--rounds", "1", "--chain", "1", "--iters", "1",
                         "--dq-tiles")),
    ("prof_dkv_wide", ("--rounds", "1", "--chain", "1", "--iters", "1",
                       "--dkv-tiles", "keys128")),
    ("prof_fwd_pipeline", ("--rounds", "1", "--chain", "2", "--iters", "1",
                           "--variants", "pingpong")),
    ("prof_fwd_unroll", ("--rounds", "1", "--chain", "2", "--iters", "1",
                         "--unroll", "1", "2")),
    ("prof_varlen_unroll", ("--rounds", "1", "--chain", "2", "--iters", "1",
                            "--unroll", "1", "4", "--full-unroll", "1",
                            "--mixed-unroll", "1", "--paged-unroll", "1",
                            "8")),
    ("prof_int4_ablate", ("--rounds", "1", "--iters", "1", "--variants",
                          "int8", "int4-prod")),
)
# PERF.md section 2's spread of K1-K3 and K5 in a call (1-20%), and of the
# decode's device time (0.1-5%, here 10%): a sweep's shipped row (one call
# alone, or the split's kernel) against the same kernel in
# profile_kernels' section of that title: (script, row, key, section,
# id, spread)
SWEEP_SPREAD = {"dense": 0.20, "decode": 0.10}
SWEEP_VS_PROFILE = (
    ("prof_prefill", "causal shipped 128x64", "alone_s",
     "Dense causal prefill", "K1", "dense"),
    ("prof_bwd_unroll", "split causal=True", "K2",
     "Dense causal backward", "K2", "dense"),
    ("prof_bwd_unroll", "split causal=True", "K3",
     "Dense causal backward", "K3", "dense"),
    ("prof_varlen", "mixed causal  fwd", "alone_s",
     "Varlen mixed-length causal", "K5", "dense"),
    ("prof_int4_ablate", "int8", "alone_s", "Decode 32k ctx INT8", "K4q",
     "decode"),
)


def _check_sweep(name, res):
    """A sweep script's rows: no rate past 989 TFLOP/s or 3.35 TB/s, every
    same-function variant held to its plain twin (its check's text, the
    script raised otherwise), every timing-only row checked finite.
    Returns the rows' summary."""
    from flash_attn_v100_tpu_torch.benchmarks.common import TIMING_ONLY
    out = {}
    for row, r in res.items():
        if row.startswith("split"):
            out[row] = {k: v * 1e3 for k, v in r.items()}
            continue
        if "call_s" not in r:
            out[row] = r["skipped"][:40]
            continue
        for key in ("tflops", "device_tflops"):
            assert r.get(key, 0) <= BF16_FLOPS_PER_S / 1e12, (name, row, r)
        for key in ("gbps", "device_gbps"):
            assert r.get(key, 0) <= HBM_BYTES_PER_S / 1e9, (name, row, r)
        if r["variant"] is not None:
            if r["timing_only"]:
                assert r["check"] == TIMING_ONLY, (name, row, r)
            else:
                assert r["check"] and "<=" in r["check"], (name, row, r)
        s = dict(ms=r["device_s"] * 1e3, alone_ms=r["alone_s"] * 1e3)
        s.update({k: r[k] for k in ("device_tflops", "device_gbps")
                  if k in r})
        if r["variant"] is not None:
            occ = r["occupancy"]
            s.update(variant=f"{r['kernel']} {r['variant']}",
                     regs=occ["regs"], local=occ["local"], smem=occ["smem"])
        out[row] = s
    return out


def phase_sweeps(torch, measure):
    """The tile and unroll sweeps (SWEEP_RUNS), each through its main() in
    this process (the measurement phase's fresh one), checked by
    _check_sweep; then each kernel's shipped row against profile_kernels'
    row of the same kernel in `measure` (this process's
    phase_measure), within PERF.md section 2's spread.  Returns each
    script's summary and seconds."""
    import importlib

    out, raw = {}, {}
    t0 = time.perf_counter()
    for name, args in SWEEP_RUNS:
        mod = importlib.import_module(
            f"flash_attn_v100_tpu_torch.benchmarks.{name}")
        print(f"sweep {' '.join((name,) + args)}:", flush=True)
        t1 = time.perf_counter()
        raw[name] = mod.main(list(args))
        out[name] = dict(rows=_check_sweep(name, raw[name]),
                         seconds=time.perf_counter() - t1)
        print(f"sweep {name}: {out[name]['seconds']:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    prof = measure["profile_kernels"]
    vs = {}
    for script, row, key, section, kid, spread in SWEEP_VS_PROFILE:
        ours = raw[script][row][key] * 1e6
        (title,) = [t for t in prof if t.startswith(section)]
        theirs = prof[title]["kernels"][kid]
        vs[f"{kid} ({script})"] = (ours, theirs)
        assert abs(ours / theirs - 1) <= SWEEP_SPREAD[spread], (
            f"{kid}: {script}'s {row} {ours:.1f} us against profile_kernels' "
            f"{theirs:.1f} us, past the spread {SWEEP_SPREAD[spread]}")
    out["vs_profile_kernels_us"] = vs
    print(f"sweeps: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


MEASURE_TIMEOUT_S = 520


def phase_measure_fresh(torch):
    """phase_measure, then phase_sweeps, in a fresh process (`chip_smoke.py
    --measure-child`): a process that has run the earlier phases gives
    torch.profiler traces without their device lane (CPU ops only), which
    the profile and decode-attribution scripts refuse.  Its lines are
    printed; its last line carries both phases' summaries."""
    gc.collect()
    torch.cuda.empty_cache()
    r = subprocess.run([sys.executable, __file__, "--measure-child"],
                       capture_output=True, text=True,
                       timeout=MEASURE_TIMEOUT_S)
    for line in r.stdout.strip().splitlines():
        print(line, flush=True)
    assert r.returncode == 0, (
        f"the measurement phase exited {r.returncode}: {r.stderr[-3000:]}")
    (last,) = [ln for ln in r.stdout.splitlines()
               if ln.startswith("measure-child: ")]
    return json.loads(last[len("measure-child: "):])


# --------------------------------------------- dense kernels, two trees

def digest(torch, *tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def dense_times(torch) -> dict:
    """K1, K2 and K3 of the `flash_attn_v100_tpu_torch` on sys.path at the
    training shape: a SHA-256 digest of each kernel's outputs at p 0 and
    0.1 (K1: out and LSE; K2: dq; K3: dk and dv) and their times, K1's
    time at the headline prefill shape, and the head-dim-256 rows
    (`d256_rows`: digests, times, SDPA, bounds) with the D 256 kernels'
    occupancy, to compare two trees of the port in one call:
        python3 chip_smoke.py --dense-times TREE
    K2 and K3 take the plain forward's out and LSE in bf16, not K1's, so
    their inputs are the same in every tree."""
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd

    build.build_all(["fwd", "bwd", "varlen_paged", "varlen_paged_quant"])
    dev = torch.device("cuda")
    B, S, Hq, Hk, D = DENSE_B, DENSE_S, DENSE_HQ, DENSE_HK, DENSE_D
    ggen = torch.Generator(device=dev).manual_seed(SEED + 3)
    q, k, v, do = (torch.randn(s, generator=ggen, device=dev).to(
        torch.bfloat16) for s in ((B, S, Hq, D), (B, S, Hk, D),
                                  (B, S, Hk, D), (B, S, Hq, D)))
    params = masklib.MaskParams(causal=True)
    scale = D ** -0.5
    seed = torch.tensor([0x13579BDF, 0x80000001], dtype=torch.int64)
    outs = {"K1": [], "K2": [], "K3": []}
    for p in (0.0, DENSE_DROPOUT):
        kw = dict(dropout_p=p, dropout_seed=seed if p else None)
        outs["K1"] += dfwd.flash_attn_dense_fwd(q, k, v, scale, params, **kw)
        o16, l16 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params,
                                                 upcast=False, **kw)
        dq, dk, dv = dbwd.flash_attn_dense_bwd(q, k, v, o16, do, l16, scale,
                                               params, **kw)
        outs["K2"].append(dq)
        outs["K3"] += [dk, dv]
    digests = {name: digest(torch, *ts) for name, ts in outs.items()}
    del outs
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    o16, l16 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params,
                                             upcast=False)
    delta = dbwd.softmax_delta(o16, do)
    lse_c = l16.clamp_min(NEG_INF).contiguous()
    kargs = (q, k, v, do, lse_c, delta, None, scale, params, 0.0, None, 0,
             None, Hq)
    ms = {"K1": time_ms(torch, lambda: dfwd.flash_attn_dense_fwd(
              q, k, v, scale, params), flush=flush),
          "K2": time_ms(torch, lambda: dbwd.dq_kernel(*kargs), flush=flush),
          "K3": time_ms(torch, lambda: dbwd.dkv_kernel(*kargs), flush=flush)}
    # K1 at the headline prefill shape (head_dim 128)
    del q, k, v, do, o16, l16, delta, lse_c, kargs
    q, k, v = (torch.randn(s, generator=ggen, device=dev).to(torch.bfloat16)
               for s in ((BENCH_B, BENCH_S, BENCH_HQ, BENCH_D),
                         (BENCH_B, BENCH_S, BENCH_HK, BENCH_D),
                         (BENCH_B, BENCH_S, BENCH_HK, BENCH_D)))
    ms["K1 D 128"] = time_ms(torch, lambda: dfwd.flash_attn_dense_fwd(
        q, k, v, BENCH_D ** -0.5, params), flush=flush)
    del q, k, v
    # head dim 256: digests, graph-replay times beside SDPA's and the bound,
    # and each kernel's registers, spills and shared memory
    d256 = d256_rows(torch, flush, digests)
    for name, row in d256.items():
        for kid in ("K1", "K2", "K3"):
            ms[f"{kid} {name}"] = row[kid]["ms"]
    occ = occupancy(build, ("K1", "K2", "K3", "K6", "K7", "K8", "K8q fp8"),
                    dims=(256,))
    return {"digest": digests, "ms": ms, "d256": d256,
            "occupancy_d256": {f"{n} extra {e}": o
                               for (n, _, e), o in occ.items()}}


def varlen_times(torch) -> dict:
    """K5, K6 and K7 of the `flash_attn_v100_tpu_torch` on sys.path at
    `phase_varlen`'s case (c) (its packed documents and inputs): a digest
    of each kernel's outputs at p 0 and 0.1 (K5: out and LSE; K6: dq; K7:
    dk and dv, fed the plain varlen forward's out and LSE in bf16) and
    their times:
        python3 chip_smoke.py --varlen-times TREE"""
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops import padding as padlib
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl

    # K6/K7's library is that tree's own: "bwd" here, "varlen_bwd" before
    # K6/K7 became bwd.cu's varlen instantiation
    build.build_all([n for n in ("fwd", "bwd", "varlen_bwd")
                     if n in build.SOURCES])
    dev = torch.device("cuda")
    B, S, Hq, Hk, D = DENSE_B, DENSE_S, DENSE_HQ, DENSE_HK, DENSE_D
    ggen = torch.Generator(device=dev).manual_seed(SEED + 5)   # as (c)
    x = [torch.randn((B, S, h, D), generator=ggen, device=dev).to(
        torch.bfloat16) for h in (Hq, Hk, Hk, Hq)]
    aml = torch.zeros((B, S), dtype=torch.int32)
    for r, d in enumerate(packed_doc_lengths(B, S, SEED)):
        aml[r, :len(d)] = torch.tensor(d, dtype=torch.int32)
    un = [padlib.unpad_input_for_concatenated_sequences(t, aml.to(dev))
          for t in x]
    (qc, kc, vc, doc), cu, ms_c = [u[0] for u in un], un[0][2], un[0][3]
    params = masklib.MaskParams(causal=True)
    scale = D ** -0.5
    args = (qc, kc, vc, cu, cu, ms_c, ms_c, scale, params)
    seed = torch.tensor([0x0F1E2D3C, 0x4B5A6978], dtype=torch.int64)
    outs = {"K5": [], "K6": [], "K7": []}
    for p in (0.0, DENSE_DROPOUT):
        kw = dict(dropout_p=p, dropout_seed=seed if p else None)
        outs["K5"] += vl.flash_attn_varlen_fwd(*args, **kw)
        o16, l16 = vl.flash_attn_varlen_fwd_ref(*args, upcast=False, **kw)
        dq, dk, dv = vl.flash_attn_varlen_bwd(qc, kc, vc, o16, doc, l16, cu,
                                              cu, ms_c, ms_c, scale, params,
                                              **kw)
        outs["K6"].append(dq)
        outs["K7"] += [dk, dv]
    digests = {name: digest(torch, *ts) for name, ts in outs.items()}
    del outs
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    o16, l16 = vl.flash_attn_varlen_fwd_ref(*args, upcast=False)
    delta = vl.varlen_delta(o16, doc)
    lse_c = l16.clamp_min(NEG_INF).contiguous()
    kargs = (qc, kc, vc, doc, lse_c, delta, None, cu, cu, None, None, ms_c,
             ms_c, scale, params, 0.0, None)
    ms = {"K5": time_ms(torch, lambda: vl.flash_attn_varlen_fwd(*args),
                        flush=flush),
          "K6": time_ms(torch, lambda: vl.varlen_dq_kernel(*kargs),
                        flush=flush),
          "K7": time_ms(torch, lambda: vl.varlen_dkv_kernel(*kargs),
                        flush=flush)}
    del x, un, qc, kc, vc, doc, o16, l16, delta, lse_c, kargs
    d256 = varlen_times_d256(torch, vl, cu, ms_c, flush)
    for kid, row in d256.items():
        digests[f"{kid} D 256"] = row.pop("digest")
        ms[f"{kid} D 256"] = row["ms"]
    return {"digest": digests, "ms": ms, "d256": d256}


def varlen_times_d256(torch, vl, cu, max_len, flush) -> dict:
    """K6 and K7 at head dim 256: the packed documents of `varlen_times`
    (cu, max_len) at Gemma-2B's 8/1 heads x 256 (D256_SHAPES (b)), causal,
    bf16, fed the plain varlen forward's out and LSE in bf16.  Per kernel:
    a digest of its outputs, its device time from CUDA-graph replays, the
    bound (varlen_work), the plain backward's time (dq, dk, dv together)
    and the library's backward (`varlen_library`, K6 + K7 together)."""
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.ops import masks as masklib

    dev = torch.device("cuda")
    _, _, Hq, Hk, D = D256_SHAPES["b"]
    T = int(cu[-1])
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    q, k, v, do = (torch.randn((T, h, D), generator=gen, device=dev).to(
        torch.bfloat16) for h in (Hq, Hk, Hk, Hq))
    params = masklib.MaskParams(causal=True)
    scale = D ** -0.5
    o16, l16 = vl.flash_attn_varlen_fwd_ref(q, k, v, cu, cu, max_len,
                                            max_len, scale, params,
                                            upcast=False)
    kargs = (q, k, v, do, l16.clamp_min(NEG_INF).contiguous(),
             vl.varlen_delta(o16, do), None, cu, cu, None, None, max_len,
             max_len, scale, params, 0.0, None)
    plain = time_ms(torch, lambda: vl.flash_attn_varlen_bwd_ref(
        q, k, v, o16, do, l16, cu, cu, max_len, max_len, scale, params),
        reps=3, warmup=1, flush=flush)
    del o16, l16
    calls = {"K6": lambda: vl.varlen_dq_kernel(*kargs),
             "K7": lambda: vl.varlen_dkv_kernel(*kargs)}
    ql, kl, vl_ = (t.clone().requires_grad_() for t in (q, k, v))
    label, lib_fn, o_lib = varlen_library(torch, ql, kl, vl_, cu, max_len)
    o_lib = o_lib[0] if isinstance(o_lib, tuple) else o_lib
    do_lib = do if o_lib.dim() == 3 else do.transpose(0, 1)[None]
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (ql, kl, vl_), do_lib, retain_graph=True), flush=flush)
    del o_lib, do_lib, ql, kl, vl_
    lens = (cu[1:] - cu[:-1]).tolist()
    work = varlen_work(lens, Hq, Hk, D)
    res = {}
    for kid, fn in calls.items():
        out = fn()
        dig = digest(torch, *(out if isinstance(out, tuple) else (out,)))
        del out
        flops, nbytes = work[kid]
        bms, by = bound_ms(nbytes, flops)
        res[kid] = dict(digest=dig, ms=graph_ms(torch, fn, flush=flush),
                        bound_ms=bms, bound_by=by, plain_ms=plain,
                        library_ms=lib_bwd,
                        library=f"{label} bwd (K6 + K7)")
        print(f"{kid} D 256 ({len(lens)} packed documents, {T} tokens, "
              f"{Hq}/{Hk} heads, causal, graph replays): {res[kid]['ms']:.4f}"
              f" ms, bound {bms:.4f} ms ({by}), plain {plain:.4f} ms (dq, "
              f"dk, dv); {label} bwd {lib_bwd:.4f} ms", flush=True)
    return res


# ------------------------------------------------------------ head dim 32
#
# (d32a) the D 64 training shape at D 32: B 4 x 2048, 32 q / 4 kv heads;
# (d32b) the small encoders' serving batch, BAAI/bge-small-en-v1.5 and
# sentence-transformers/all-MiniLM-L6-v2 (config.json: hidden 384, 12
# heads x 32, 512 positions) through the drop-in's unpad -> varlen -> pad:
# 256 sequences of 16-512 tokens, numpy default_rng(0); (d16) sweep_dense's
# 4 x 16 x 1024^2 rows at D 16 and 32 (benchmarks/sweep_dense.py:48).
D32A_SHAPE = (4, 2048, 32, 4, 32)
D32B_HEADS, D32B_SEQS, D32B_LENS = 12, 256, (16, 512)
D16_SHAPE = (4, 1024, 16)          # B, S, heads (q and kv)
# MUFU.EX2 a clock on each SM: ~3.9 TFLOP/s of special functions on the
# H100 SXM (FlashAttention-3's paper) over 132 SMs at its boost clock
MUFU_EX2_PER_SM_CLOCK = 16


def d32b_lengths():
    """(d32b)'s 256 sequence lengths, uniform in 16-512."""
    import numpy as np
    lo, hi = D32B_LENS
    return [int(n) for n in
            np.random.default_rng(0).integers(lo, hi + 1, D32B_SEQS)]


def sm_clock(torch, fn) -> dict:
    """The SM clock (MHz) nvidia-smi reads three times while `fn` (a graph
    replay) runs back to back on the card from another thread, and the
    card's maximum SM clock: the clock of the exponentials' bound."""
    import threading
    stop = threading.Event()

    def run():
        while not stop.is_set():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    t = threading.Thread(target=run)
    t.start()
    reads = []
    try:
        time.sleep(0.3)
        for _ in range(3):
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True, timeout=60)
            reads.append([float(x) for x in
                          out.stdout.strip().splitlines()[0].split(",")])
            time.sleep(0.1)
    finally:
        stop.set()
        t.join()
    return dict(sm_mhz=statistics.median(r[0] for r in reads),
                max_sm_mhz=reads[0][1], reads=[r[0] for r in reads])


def graph_ms_clock(torch, fn, flush):
    """(`graph_ms` of fn, `sm_clock` under back-to-back replays of the
    same graph, read just before they are timed): a kernel's time with
    the clock it ran at, since a card under its power limit clocks each
    kernel differently."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    clock = sm_clock(torch, g.replay)
    return time_ms(torch, g.replay, reps=20, warmup=1, flush=flush), clock


def bound3(nbytes, flops, exps, clock_mhz, sms) -> dict:
    """A head-dim-32 row's bound: the largest of the bytes over 3.35 TB/s,
    the operations over 989 TFLOP/s and the exponentials (one ex2 a live
    pair) over the MUFU rate, MUFU_EX2_PER_SM_CLOCK x `sms` x `clock_mhz`."""
    t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
         "operations": flops / BF16_FLOPS_PER_S * 1e3,
         "exponentials": exps / (MUFU_EX2_PER_SM_CLOCK * sms * clock_mhz
                                 * 1e6) * 1e3}
    by = max(t, key=t.get)
    return dict(bound_ms=t[by], bound_by=by, terms=t)


def d32_dense_rows(torch, flush, digests=None) -> dict:
    """K1, K2 and K3 alone at (d32a), bf16, causal and full: each
    kernel's device time from CUDA-graph replays with the SM clock under
    them (`graph_ms_clock`) and its thousands of clock cycles (ms x MHz),
    SDPA's forward and backward (`enable_gqa`; CUDA events around one
    call), the plain forward's and backward's times (causal) and the
    three-term bound (`bound3`) at the kernel's clock.  K2 and K3 take the
    plain forward's out and LSE in bf16, so their inputs are the same in
    every tree.  With a dict `digests`, adds a digest of each kernel's
    outputs (and of the causal p 0.1 calls: the dropout variants)."""
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd

    dev = torch.device("cuda")
    F = torch.nn.functional
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, S, Hq, Hk, D = D32A_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16) for s in ((B, S, Hq, D), (B, S, Hk, D),
                                  (B, S, Hk, D), (B, S, Hq, D)))
    scale = D ** -0.5
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    do_s = do.transpose(1, 2).contiguous()
    rows = {}
    for causal in (True, False):
        name = f"D 32 a {'causal' if causal else 'full'}"
        params = masklib.MaskParams(causal=causal)
        o16, l16 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params,
                                                 upcast=False)
        kargs = (q, k, v, do, l16.clamp_min(NEG_INF).contiguous(),
                 dbwd.softmax_delta(o16, do), None, scale, params, 0.0,
                 None, 0, None, Hq)
        if digests is not None:
            digests[f"K1 {name}"] = digest(
                torch, *dfwd.flash_attn_dense_fwd(q, k, v, scale, params))
            digests[f"K2 {name}"] = digest(torch, dbwd.dq_kernel(*kargs))
            digests[f"K3 {name}"] = digest(torch, *dbwd.dkv_kernel(*kargs))
        ms, clock = {}, {}
        for kid, fn in (
                ("K1", lambda: dfwd.flash_attn_dense_fwd(q, k, v, scale,
                                                         params)),
                ("K2", lambda: dbwd.dq_kernel(*kargs)),
                ("K3", lambda: dbwd.dkv_kernel(*kargs))):
            ms[kid], clock[kid] = graph_ms_clock(torch, fn, flush)
        row = dict(shape=[B, S, Hq, Hk, D], causal=causal)
        if causal:
            row["plain_fwd_ms"] = time_ms(
                torch, lambda: dfwd.flash_attn_dense_fwd_ref(
                    q, k, v, scale, params), reps=3, warmup=1, flush=flush)
            row["plain_bwd_ms"] = time_ms(
                torch, lambda: dbwd.flash_attn_dense_bwd_ref(
                    q, k, v, o16, do, l16, scale, params), reps=3, warmup=1,
                flush=flush)
        del o16, l16, kargs
        row["sdpa_fwd_ms"] = time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=True), flush=flush)
        o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                               enable_gqa=True)
        row["sdpa_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qs, ks, vs), do_s, retain_graph=True), flush=flush)
        del o_lib
        work = dense_work(B, S, Hq, Hk, D, causal=causal)
        pairs = B * Hq * (S * (S + 1) // 2 if causal else S * S)
        for kid in ("K1", "K2", "K3"):
            flops, nbytes = work[kid]
            mhz = clock[kid]["sm_mhz"]
            row[kid] = dict(ms=ms[kid], clock=clock[kid],
                            kcycles=ms[kid] * mhz, flops=flops, bytes=nbytes,
                            exps=pairs, **bound3(nbytes, flops, pairs, mhz,
                                                 sms))
        rows[name] = row
        print(f"{name} (B={B} S={S} Hq={Hq} Hk={Hk}, bf16, graph replays): "
              + ", ".join(
                  f"{kid} {row[kid]['ms']:.4f} ms at "
                  f"{row[kid]['clock']['sm_mhz']:.0f} MHz "
                  f"({row[kid]['kcycles']:.1f} kcycles; bound "
                  f"{row[kid]['bound_ms']:.4f}, {row[kid]['bound_by']}: "
                  + "/".join(f"{t:.4f}" for t in row[kid]["terms"].values())
                  + ")" for kid in ("K1", "K2", "K3")) +
              f"; sdpa fwd {row['sdpa_fwd_ms']:.4f} ms, bwd "
              f"{row['sdpa_bwd_ms']:.4f} ms", flush=True)
    if digests is not None:
        params = masklib.MaskParams(causal=True)
        kw = dict(dropout_p=DENSE_DROPOUT,
                  dropout_seed=torch.tensor([0x2468ACE1, 0x10000001],
                                            dtype=torch.int64))
        name = "D 32 a causal p=0.1"
        digests[f"K1 {name}"] = digest(torch, *dfwd.flash_attn_dense_fwd(
            q, k, v, scale, params, **kw))
        o16, l16 = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params,
                                                 upcast=False, **kw)
        dq, dk, dv = dbwd.flash_attn_dense_bwd(q, k, v, o16, do, l16, scale,
                                               params, **kw)
        digests[f"K2 {name}"] = digest(torch, dq)
        digests[f"K3 {name}"] = digest(torch, dk, dv)
    return rows


def d32_varlen_rows(torch, flush, digests=None) -> dict:
    """K5 at (d32b), non-causal, and K6 / K7 there with causal=True (fed
    the plain causal forward's out and LSE in bf16), each alone: device
    time from CUDA-graph replays (the wrapper's fills with the kernel) with
    the SM clock under them (`graph_ms_clock`), the three-term bound at
    that clock, the plain version's time, and varlen_attn's forward
    (non-causal) and backward (causal; K6 + K7 together).  With a dict
    `digests`, adds a digest of each kernel's outputs."""
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    H, D = D32B_HEADS, 32
    lens = d32b_lengths()
    T, ml = sum(lens), max(lens)
    cu = torch.tensor([0] + lens, device=dev).cumsum(0).to(torch.int32)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    q, k, v, do = (torch.randn((T, H, D), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    scale = D ** -0.5
    full, causal = masklib.MaskParams(), masklib.MaskParams(causal=True)
    fargs = (q, k, v, cu, cu, ml, ml, scale, full)
    o16, l16 = vl.flash_attn_varlen_fwd_ref(q, k, v, cu, cu, ml, ml, scale,
                                            causal, upcast=False)
    kargs = (q, k, v, do, l16.clamp_min(NEG_INF).contiguous(),
             vl.varlen_delta(o16, do), None, cu, cu, None, None, ml, ml,
             scale, causal, 0.0, None)
    calls = {"K5": lambda: vl.flash_attn_varlen_fwd(*fargs),
             "K6": lambda: vl.varlen_dq_kernel(*kargs),
             "K7": lambda: vl.varlen_dkv_kernel(*kargs)}
    plain = {"K5": time_ms(torch, lambda: vl.flash_attn_varlen_fwd_ref(
                 *fargs), reps=3, warmup=1, flush=flush)}
    plain["K6"] = plain["K7"] = time_ms(
        torch, lambda: vl.flash_attn_varlen_bwd_ref(
            q, k, v, o16, do, l16, cu, cu, ml, ml, scale, causal), reps=3,
        warmup=1, flush=flush)
    del o16, l16
    ql, kl, vl_ = (t.clone().requires_grad_() for t in (q, k, v))
    label, lib_fwd, _ = varlen_library(torch, ql, kl, vl_, cu, ml,
                                       causal=False)
    lib = {"K5": time_ms(torch, lib_fwd, flush=flush)}
    _, _, o_lib = varlen_library(torch, ql, kl, vl_, cu, ml)
    o_lib = o_lib[0] if isinstance(o_lib, tuple) else o_lib
    do_lib = do if o_lib.dim() == 3 else do.transpose(0, 1)[None]
    lib["K6"] = lib["K7"] = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (ql, kl, vl_), do_lib, retain_graph=True), flush=flush)
    del o_lib, do_lib, ql, kl, vl_
    work = {"K5": varlen_work(lens, H, H, D, causal=False)["K5"],
            **{kid: varlen_work(lens, H, H, D)[kid] for kid in ("K6", "K7")}}
    res = {}
    for kid, fn in calls.items():
        out = fn()
        if digests is not None:
            digests[f"{kid} D 32 b"] = digest(
                torch, *(out if isinstance(out, tuple) else (out,)))
        del out
        flops, nbytes = work[kid]
        pairs = flops // ({"K5": 4, "K6": 6, "K7": 8}[kid] * D)
        ms, clock = graph_ms_clock(torch, fn, flush)
        mhz = clock["sm_mhz"]
        res[kid] = dict(ms=ms, clock=clock, kcycles=ms * mhz, flops=flops,
                        bytes=nbytes, exps=pairs, plain_ms=plain[kid],
                        library_ms=lib[kid],
                        library=f"{label} {'fwd' if kid == 'K5' else 'bwd'}",
                        causal=kid != "K5",
                        **bound3(nbytes, flops, pairs, mhz, sms))
        print(f"{kid} D 32 b ({len(lens)} sequences of {min(lens)}-"
              f"{max(lens)} tokens, {T} tokens, {H}/{H} heads, "
              f"{'causal' if kid != 'K5' else 'non-causal'}, graph replays):"
              f" {ms:.4f} ms at {mhz:.0f} MHz ({ms * mhz:.1f} kcycles), "
              f"bound {res[kid]['bound_ms']:.4f} "
              f"ms ({res[kid]['bound_by']}), plain {plain[kid]:.4f} ms; "
              f"{res[kid]['library']} {lib[kid]:.4f} ms", flush=True)
    return res


def d16_rows(torch, flush, digests=None) -> dict:
    """(d16): K1 through flash_attn_func at 4 x 16 x 1024^2, D 16 and D
    32, causal and full, timed four ways: `measure`'s queue-delta time of
    a call (as sweep_dense times it), CUDA events around one call, a
    CUDA-graph replay of the wrapper (pad copies, kernel, slice) and a
    graph replay of the kernel alone on inputs already at D 32; beside
    SDPA's call."""
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
    from flash_attn_v100_tpu_torch.utils.benchmarking import measure

    dev = torch.device("cuda")
    F = torch.nn.functional
    B, S, H = D16_SHAPE
    rows = {}
    for D in (16, 32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 29)
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(3))
        q32, k32, v32 = (F.pad(t, (0, 32 - D)).contiguous()
                         for t in (q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        for causal in (True, False):
            name = f"D {D} {'causal' if causal else 'full'}"
            params = masklib.MaskParams(causal=causal)
            scale = D ** -0.5
            with torch.no_grad():
                call = lambda: flash_attn_func(q, k, v, causal=causal)
                if digests is not None:
                    digests[f"K1 d16 {name}"] = digest(torch, call())
                rows[name] = dict(
                    measure_ms=measure(call, iters=8, device=dev) * 1e3,
                    call_ms=time_ms(torch, call),
                    wrapper_graph_ms=graph_ms(
                        torch, lambda: dfwd.flash_attn_dense_fwd(
                            q, k, v, scale, params), flush=flush),
                    kernel_graph_ms=graph_ms(
                        torch, lambda: dfwd.flash_attn_dense_fwd(
                            q32, k32, v32, scale, params), flush=flush),
                    sdpa_measure_ms=measure(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal), iters=8,
                        device=dev) * 1e3)
            r = rows[name]
            print(f"d16 {name} (B={B} S={S} H={H}): flash_attn_func "
                  f"{r['measure_ms']:.4f} ms a call (queue delta), "
                  f"{r['call_ms']:.4f} (one call); graph replays: wrapper "
                  f"{r['wrapper_graph_ms']:.4f}, kernel alone "
                  f"{r['kernel_graph_ms']:.4f}; sdpa "
                  f"{r['sdpa_measure_ms']:.4f} a call", flush=True)
    return rows


# the paged prefills timed at D 32: k8_case's wave, and phase_d32's
# serving wave (six 1024-token prompts, no cached prefix)
D32_PREFILLS = {"prefill": dict(), "serve": dict(T=1024, prefix=(0,) * 6)}


def d32_paged_rows(torch, flush, digests=None) -> dict:
    """K8 and K8q fp8 alone at the encoders' 12/12 heads x 32 on each wave
    of D32_PREFILLS (k8_case): device time from CUDA-graph replays with
    the SM clock under them (`graph_ms_clock`), and with a dict `digests`
    a digest of each one's out and LSE."""
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl

    res = {}
    for wave, kw in D32_PREFILLS.items():
        _, _, _, qp, kp, vp, tail, _ = k8_case(torch, Hq=D32B_HEADS,
                                               Hk=D32B_HEADS, D=32, **kw)
        (kq, vq, ks, vs), _ = quant_pools(torch, kp, vp, "fp8")
        calls = {"K8": lambda: vl.flash_attn_varlen_fwd_paged(
                     qp, kp, vp, *tail),
                 "K8q fp8": lambda: vl.flash_attn_varlen_fwd_paged(
                     qp, kq, vq, *tail, k_scales=ks, v_scales=vs)}
        for kid, fn in calls.items():
            key = f"{kid} D 32 {wave}"
            if digests is not None:
                digests[key] = digest(torch, *fn())
            ms, clock = graph_ms_clock(torch, fn, flush)
            res[key] = dict(ms=ms, clock=clock, kcycles=ms * clock["sm_mhz"])
        del qp, kp, vp, kq, vq, ks, vs, tail, calls
    print(f"K8 / K8q fp8 D 32 ({D32B_HEADS}/{D32B_HEADS} heads, graph "
          f"replays): " + ", ".join(
              f"{k} {r['ms']:.4f} ms at {r['clock']['sm_mhz']:.0f} MHz "
              f"({r['kcycles']:.2f} kcycles)" for k, r in res.items()),
          flush=True)
    return res


def d32_times(torch) -> dict:
    """Head dim 32 of the `flash_attn_v100_tpu_torch` on sys.path: K1, K2,
    K3 at (d32a) (`d32_dense_rows`), K5 / K6 / K7 at (d32b)
    (`d32_varlen_rows`), K1 at (d16) (`d16_rows`) and K8 / K8q fp8 at the
    prefill waves (`d32_paged_rows`), with a digest of each kernel's
    outputs, to compare two trees in one call:
        python3 chip_smoke.py --d32-times TREE"""
    from flash_attn_v100_tpu_torch.ops.cuda import build

    build.build_all(["fwd", "bwd", "varlen_paged", "varlen_paged_quant"])
    flush = torch.empty(64 * 2 ** 20 // 4, device="cuda")
    digests = {}
    dense = d32_dense_rows(torch, flush, digests)
    varlen = d32_varlen_rows(torch, flush, digests)
    d16 = d16_rows(torch, flush, digests)
    paged = d32_paged_rows(torch, flush, digests)
    timed = {f"{kid} {name}": row[kid] for name, row in dense.items()
             for kid in ("K1", "K2", "K3")}
    timed.update({f"{kid} D 32 b": r for kid, r in varlen.items()})
    timed.update(paged)
    ms = {key: r["ms"] for key, r in timed.items()}
    ms.update({f"K1 d16 {name} {how}": r[how] for name, r in d16.items()
               for how in ("measure_ms", "kernel_graph_ms")})
    return {"digest": digests, "ms": ms,
            "kcycles": {key: r["kcycles"] for key, r in timed.items()},
            "sm_mhz": {key: r["clock"]["sm_mhz"] for key, r in timed.items()},
            "d32a": dense, "d32b": varlen, "d16": d16}


FP32_STEP_REPS = 3              # fp32 AdamW steps timed a tree (one untimed)


def fp32_turn_times(torch) -> dict:
    """The fp32 bodies of the `flash_attn_v100_tpu_torch` on sys.path: K1,
    K2 and K3 at the training shape, at FP32_D128 and at the training
    shape's heads x 32 (the (d32a) shape in fp32), K5 / K6 / K7 at
    `fp32_varlen`'s packed documents and K8 at k8_case's prefill wave, each
    as CUDA-graph replays with the SM clock read under them (ms and kcycles
    = ms x MHz) and a digest of its outputs; K2 / K3 and K6 / K7 take the plain forward's out
    and LSE, so their inputs are the same in every tree.  Then the
    FP32_LAYERS-layer fp32 TinyLlama AdamW step (make_train_step, B
    FP32_TRAIN_B x TRAIN_S; the median of FP32_STEP_REPS steps after one,
    CUDA events; a digest of the losses).  To compare two trees in one
    call, in turns:
        python3 chip_smoke.py --fp32-times TREE"""
    from flash_attn_v100_tpu_torch import ModelConfig
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl

    build.build_all(["fwd_f32", "bwd_f32"])
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    params = masklib.MaskParams(causal=True)
    digests, rows, lib = {}, {}, {}

    def timed(key, fn):
        digests[key] = digest(torch, *fn())
        ms, clock = graph_ms_clock(torch, fn, flush)
        rows[key] = dict(ms=ms, clock=clock, kcycles=ms * clock["sm_mhz"])
        print(f"fp32-times {key}: {ms:.4f} ms at {clock['sm_mhz']:.0f} MHz "
              f"({rows[key]['kcycles']:.1f} kcycles), digest "
              f"{digests[key]}", flush=True)

    for tag, (B, S, Hq, Hk, D), seed in (
            ("train", (TRAIN_B, TRAIN_S, 32, 4, 64), SEED + 10),
            ("D 128", FP32_D128, SEED + 23),
            ("D 32", (TRAIN_B, TRAIN_S, 32, 4, 32), SEED + 24)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do = (torch.randn((B, S, h, D), generator=gen, device=dev)
                       for h in (Hq, Hk, Hk, Hq))
        scale = D ** -0.5
        o, lse = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params)
        kargs = (q, k, v, do, lse.clamp_min(NEG_INF).contiguous(),
                 dbwd.softmax_delta(o, do), None, scale, params, 0.0, None,
                 0, None, Hq)
        del o, lse
        timed(f"K1 {tag}", lambda: dfwd.flash_attn_dense_fwd(q, k, v, scale,
                                                             params))
        timed(f"K2 {tag}", lambda: (dbwd.dq_kernel(*kargs),))
        timed(f"K3 {tag}", lambda: dbwd.dkv_kernel(*kargs))
        lib[tag] = fair_sdpa(torch, flush, q, k, v, do)
        print(f"fp32-times SDPA fp32 {tag}: " + ", ".join(
            f"{n} {t:.4f}" for n, t in lib[tag].items()), flush=True)
        del q, k, v, do, kargs
        torch.cuda.empty_cache()

    B, S, Hq, Hk, D = TRAIN_B, TRAIN_S, 32, 4, 64
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    lens = [n for row in packed_doc_lengths(B, S, SEED) for n in row]
    cu = torch.tensor([0] + lens, device=dev).cumsum(0).to(torch.int32)
    mx = max(lens)
    q, k, v, do = (torch.randn((sum(lens), h, D), generator=gen, device=dev)
                   for h in (Hq, Hk, Hk, Hq))
    scale = D ** -0.5
    o, lse = vl.flash_attn_varlen_fwd_ref(q, k, v, cu, cu, mx, mx, scale,
                                          params)
    bk = (q, k, v, do, lse.clamp_min(NEG_INF).contiguous(),
          vl.varlen_delta(o, do), None, cu, cu, None, None, mx, mx, scale,
          params, 0.0, None)
    timed("K5 packed", lambda: vl.flash_attn_varlen_fwd(
        q, k, v, cu, cu, mx, mx, scale, params))
    timed("K6 packed", lambda: (vl.varlen_dq_kernel(*bk),))
    timed("K7 packed", lambda: vl.varlen_dkv_kernel(*bk))
    del q, k, v, do, o, lse, bk
    _, _, _, q, kp, vp, tail, _ = k8_case(torch, torch.float32)
    timed("K8 wave", lambda: vl.flash_attn_varlen_fwd_paged(q, kp, vp,
                                                            *tail))
    del q, kp, vp, tail
    gc.collect()
    torch.cuda.empty_cache()

    cfg = ModelConfig.tinyllama_1b(dtype=torch.float32, n_layers=FP32_LAYERS)
    mparams = tm.init_params(cfg, seed=SEED, device=dev, lm_head=True)
    for t in tm.param_leaves(mparams):
        t.requires_grad_(True)
    step, init_opt = tm.make_train_step(cfg)
    opt = init_opt(mparams)
    tokens = torch.randint(0, cfg.vocab_size, (FP32_TRAIN_B, TRAIN_S + 1),
                           generator=torch.Generator().manual_seed(SEED)
                           ).to(dev)
    losses, step_ms = [], []
    for i in range(FP32_STEP_REPS + 1):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        loss, mparams, opt = step(mparams, opt, tokens)
        t1.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        if i:
            step_ms.append(t0.elapsed_time(t1))
    digests["step losses"] = digest(torch, torch.tensor(losses))
    step = dict(ms=statistics.median(step_ms), ms_repeats=step_ms,
                losses=losses, layers=FP32_LAYERS, B=FP32_TRAIN_B, S=TRAIN_S)
    print(f"fp32-times step: {FP32_LAYERS} layers, B {FP32_TRAIN_B} x "
          f"{TRAIN_S}: {step['ms']:.1f} ms ({[round(x, 1) for x in step_ms]}"
          f"), losses {losses}", flush=True)
    return {"digest": digests, "ms": {k_: r["ms"] for k_, r in rows.items()},
            "kcycles": {k_: r["kcycles"] for k_, r in rows.items()},
            "sm_mhz": {k_: r["clock"]["sm_mhz"] for k_, r in rows.items()},
            "sdpa_fp32": lib, "step": step}


def paged_times(torch) -> dict:
    """K8 and K8q (int8, fp8, int4 pools) of the `flash_attn_v100_tpu_torch`
    on sys.path at `phase_k8`'s shape (the same seeds, tables, pools and
    q), and K8 at the headline head shape (32 / 8 heads x 128, the same
    lengths): a digest of each kernel's out and LSE and the median of
    SPREAD_REPEATS repeats of SPREAD_REPS launches each, the five calls
    timed in turns, both as calls (`ms`) and as CUDA-graph replays of the
    call (`graph_ms`: its kernels' device time without the wrapper's host
    time):
        python3 chip_smoke.py --paged-times TREE"""
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl

    build.build_all(["varlen_paged", "varlen_paged_quant"])
    dev = torch.device("cuda")
    (B, T, _, _, _, ps), _, _, q, kp, vp, tail, ggen = k8_case(torch)
    n_pages = kp.shape[1]
    calls = {"K8 (bf16)": lambda: vl.flash_attn_varlen_fwd_paged(
        q, kp, vp, *tail)}
    for kind in QUANT_KINDS:
        (kq, vq, ks, vs), _ = quant_pools(torch, kp, vp, kind)
        calls[f"K8q {kind}"] = (
            lambda kq=kq, vq=vq, ks=ks, vs=vs: vl.flash_attn_varlen_fwd_paged(
                q, kq, vq, *tail, k_scales=ks, v_scales=vs))
    kp2, vp2 = make_pool(torch, ggen, dev, BENCH_HK, n_pages, ps, BENCH_D,
                         torch.bfloat16)
    q2 = torch.randn((B * T, BENCH_HQ, BENCH_D), generator=ggen,
                     device=dev).to(torch.bfloat16)
    tail2 = tail[:5] + (BENCH_D ** -0.5, tail[6])
    calls["K8 D 128"] = lambda: vl.flash_attn_varlen_fwd_paged(
        q2, kp2, vp2, *tail2)
    digests = {name: digest(torch, *fn()) for name, fn in calls.items()}
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    spread = {name: [] for name in calls}
    graph = {name: [] for name in calls}
    for _ in range(SPREAD_REPEATS):
        for name, fn in calls.items():
            spread[name].append(time_ms(torch, fn, reps=SPREAD_REPS,
                                        flush=flush))
            graph[name].append(graph_ms(torch, fn, reps=SPREAD_REPS,
                                        flush=flush))
    return {"digest": digests,
            "ms": {n: statistics.median(t) for n, t in spread.items()},
            "graph_ms": {n: statistics.median(t) for n, t in graph.items()},
            "ms_repeats": spread, "graph_ms_repeats": graph}


def probe_times(torch) -> dict:
    """P1-P3 and P4 of the `flash_attn_v100_tpu_torch` on sys.path: every
    row of `phase_probes` (each P1-P3 variant at its shapes, the same
    seeded inputs) and both P4 kernels at 4096^3, a digest of each row's
    outputs and the median of PROBE_ROUNDS rounds of PROBE_REPS launches,
    the rows timed in turns within a round (P4 with the L2 flushed, as in
    `phase_probes`); and P4's host time a call at 128 x 256 x 128 (the
    wrapper, its tensor maps and the launch, unsynchronised), to compare
    two trees of the port in one call:
        python3 chip_smoke.py --probe-times TREE"""
    from flash_attn_v100_tpu_torch.benchmarks import common, prof_int4_native
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import probe_int4 as p4
    from flash_attn_v100_tpu_torch.ops.cuda import probes

    build.build_all(["probes", "probe_int4"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data, calls, digests, flushed = {}, {}, {}, set()
    for suite, name, probe, key in probe_cases(probes):
        B, Hq, Hk, M, N = PROBE_SHAPES[key]
        if key not in data:
            data[key] = [torch.randn((B * h, n, 128), generator=gen,
                                     device=dev).to(torch.bfloat16)
                         for h, n in ((Hq, M), (Hk, N), (Hk, N))]
        q, k, v = common.operands(probe, *data[key], B)
        scale = probes.SCALE if suite == "P1" else probes.SCALE_LOG2
        call = functools.partial(probes.flash_step, q, k, v, probe, scale,
                                 **common.stream_kwargs(probe, M, N, dev))
        label = f"{suite} {name} ({key} shape)"
        out = call()
        digests[label] = digest(torch, *(out if probe.lse else (out,)))
        calls[label] = call
    large = prof_int4_native.operands(dev, INT4_LARGE, INT4_LARGE,
                                      INT4_LARGE)
    small = prof_int4_native.operands(dev, 128, 256, 128)
    host_us = {}
    for name, fn, pack in (("int4xint4", p4.int4_matmul, True),
                           ("int8xint4", p4.int8_int4_matmul, False)):
        label = f"P4 {name} ({INT4_LARGE}^3)"
        a = p4.pack_int4(large[0]) if pack else large[0]
        calls[label] = functools.partial(fn, a, large[1])
        digests[label] = digest(torch, calls[label]())
        flushed.add(label)
        a_s = p4.pack_int4(small[0]) if pack else small[0]
        for _ in range(10):
            fn(a_s, small[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(a_s, small[1])
        host_us[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    ms = {label: [] for label in calls}
    for _ in range(PROBE_ROUNDS):
        for label, fn in calls.items():
            ms[label].append(time_ms(torch, fn, reps=PROBE_REPS,
                                     flush=flush if label in flushed
                                     else None))
    return {"digest": digests,
            "ms": {n: statistics.median(t) for n, t in ms.items()},
            "ms_repeats": ms, "host_us": host_us}


def gpu_clocks() -> str:
    """The card's SM clock and power draw now, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# the JAX package's long-context decode metric (bench.py:157-220): B 8,
# context 32768, 32 / 8 heads x 128, HND pools, table arange, page 512
# (int4: 2048)
LONG_B, LONG_CTX, LONG_HQ, LONG_HK, LONG_D = 8, 32768, 32, 8, 128


def long_decode_case(torch, ggen, kind=None):
    """(L): q (B, 1, Hq, D) and the pools of one kind over the full
    context; returns (q, k_cache, v_cache, kwargs of flash_attn_with_kvcache,
    the bytes the call must read)."""
    from flash_attn_v100_tpu_torch.ops import quant
    dev = torch.device("cuda")
    B, ctx, Hq, Hk, D = LONG_B, LONG_CTX, LONG_HQ, LONG_HK, LONG_D
    ps = 2048 if kind == "int4" else 512
    P = B * ctx // ps
    q = torch.randn((B, 1, Hq, D), generator=ggen, device=dev).to(
        torch.bfloat16)
    kw = dict(cache_seqlens=torch.full((B,), ctx, dtype=torch.int32,
                                       device=dev),
              block_table=torch.arange(P, dtype=torch.int32,
                                       device=dev).reshape(B, -1),
              causal=True, kv_cache_layout="HND")
    pools = []
    for _ in range(2):
        x = torch.randn((Hk, P, ps, D), generator=ggen, device=dev).to(
            torch.bfloat16)
        if kind is not None:
            x = quant.quantize_kv(x, quant_dtype(torch, kind))
        pools.append(x)
    if kind is None:
        kc, vc = pools
        nbytes = 2 * B * ctx * Hk * D * 2
    else:
        (kc, ks), (vc, vs) = pools
        kw.update(k_scales=ks, v_scales=vs)
        nbytes = 2 * B * ctx * Hk * ((D // 2 if kind == "int4" else D) + 4)
    return q, kc, vc, kw, nbytes


DECODE_ROUNDS = 3              # --decode-times: rounds in turns of each call
# --decode-times' head-dim rows: MiniLM-L6's 12/12 x 32 and Gemma-2B's 8/1
# x 256 at (e)'s lengths, and Gemma-2B and Gemma-7B (google/gemma-7b
# config.json: 16 heads, 16 kv heads, head_dim 256) at an 8192-token
# context
D32_DECODE = (12, 12, 32)
D256_DECODE = (8, 1, 256)
D256_MHA_DECODE = (16, 16, 256)
D256_CTX = 8192


def decode_times(torch, rows: str = "") -> dict:
    """K4 and K4q of the `flash_attn_v100_tpu_torch` on sys.path, through
    the public decode call flash_attn_with_kvcache(q, k_cache, v_cache,
    cache_seqlens=, block_table=, causal=True, kv_cache_layout="HND") (no
    append; scales for K4q) and through paged_decode_attention alone
    (`core`, partials unmerged), at
      (e) phase_k4's engine decode step (B 8, 32 / 4 heads x 64, page 128,
          lens 600-2000): K4 bf16 and fp32, K4q x 3 with bf16 q and with
          fp32 q;
      (p) the engine's short-prompt prefill on the K4 route (B 2, T_new
          64, lens 64 / 364): K4 bf16 and fp32;
      (L) the 32k-context decode of LONG_*: bf16, int8, fp8 (page 512),
          int4 (page 2048) and fp32 (page 512);
      (e) at D32_DECODE's and D256_DECODE's heads (bf16), and D256_DECODE
          and D256_MHA_DECODE at B 8 x D256_CTX tokens (page 128); these
          rows also time the launch with the merge (`merged`), with one
          split (`merged s1`) and, at D 256, the sweep's ring alone
          (`copies`, benchmarks/variants.py::decode_ablation).
    Each call is timed as a call (`ms`) and as CUDA-graph replays
    (`graph_ms`, with `kcycles`: ms x the SM clock nvidia-smi reads under
    the call's own replays), DECODE_ROUNDS rounds in turns of SPREAD_REPS
    launches, the L2 flushed before each by zeroing 64 MB, and as graph
    replays after a flush that reads 64 MB (`graph_ms_clean`: no dirty
    lines left to write back inside the call); a digest of each call's out,
    each row's bytes bound (every live K / V byte, scale, q and out byte
    once over 3.35 TB/s), SDPA over the pre-gathered KV in the pools'
    dtype beside the fp32 and head-dim rows (`sdpa` calls), and the SM
    clock and power
    draw before and after each round.  ROWS, where given, keeps only the
    rows whose names hold it (e.g. "K4 fp32"), for quick turns of a body's
    variants:
        python3 chip_smoke.py --decode-times TREE [ROWS]"""
    from flash_attn_v100_tpu_torch.ops import kvcache as kv
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec

    # (the sweep's K4 ablation where the tree has one)
    build.build_all(["decode", "decode_quant", "decode_f32"],
                    variants=[("decode", "sweep")] * ("decode" in
                                                      build.VARIANTS))
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ggen = torch.Generator(device=dev).manual_seed(SEED)
    calls, bounds, plains = {}, {}, {}

    def add(name, q, kc, vc, lens, tbl, t_new, group, scales=None,
            split=False):
        """`{name} api` and `{name} core`; with `split` also the launch
        with the merge (`merged`), its plain twin merged (`plain_ms`:
        CUDA events around eager calls), the merge of one split (`merged
        s1`) and,
        where the sweep's ablation takes the shape (bf16, D 256), the ring
        alone (`copies`): where the call's time goes"""
        skw = {} if scales is None else dict(k_scales=scales[0],
                                             v_scales=scales[1])
        calls[f"{name} api"] = lambda: kv.flash_attn_with_kvcache(
            q, kc, vc, cache_seqlens=lens, block_table=tbl, causal=True,
            kv_cache_layout="HND", **skw)
        B, _, Hq, D = q.shape
        Hk = kc.shape[0]
        Rq = max(-(-group * t_new // 8) * 8, 8)
        rows = q.transpose(1, 2).reshape(B, Hk, group * t_new, D)
        if Rq != group * t_new:
            rows = torch.cat([rows, rows.new_zeros(
                B, Hk, Rq - group * t_new, D)], dim=2)
        params = masklib.MaskParams(causal=t_new > 1, window_right=0)
        int4 = scales is not None and kc.dtype == torch.int8 and \
            scales[0].shape[-2] == 2 * kc.shape[-2]
        args = (rows, kc[None], vc[None], tbl, lens, None)
        kw = dict(qpos_vec=lens - t_new, softmax_scale=D ** -0.5,
                  params=params, t_new=t_new, group=group,
                  k_scales=None if scales is None else scales[0][None],
                  v_scales=None if scales is None else scales[1][None],
                  int4=int4)
        calls[f"{name} core"] = lambda: dec.paged_decode_attention(*args,
                                                                   **kw)
        if split:
            calls[f"{name} merged"] = \
                lambda: dec.paged_decode_attention_merged(*args, **kw)
            plains[name] = lambda: dec.merge_partials(
                *dec.paged_decode_attention_ref(*args, **kw))
            calls[f"{name} merged s1"] = \
                lambda: dec.paged_decode_attention_merged(
                    *args, **dict(kw, num_splits=1))
            if D == 256 and kc.dtype == torch.bfloat16 and Rq <= 16 and \
                    "decode" in build.VARIANTS:
                from flash_attn_v100_tpu_torch.benchmarks import variants
                abl = (rows, kc[None], vc[None], tbl, lens, group)
                calls[f"{name} copies"] = lambda: variants.decode_ablation(
                    *abl, "copies")
        per_key = D * kc.element_size() if scales is None else (
            (D // 2 if int4 else D) + 4)
        nbytes = (2 * int(lens.sum()) * Hk * per_key
                  + 2 * q.numel() * q.element_size())
        bounds[name] = nbytes / HBM_BYTES_PER_S * 1e3

    def add_sdpa(name, q, kp, vp, lens, tbl, ps, t_new, group):
        """SDPA in the pools' dtype over the rows' KV gathered beforehand
        (the library call of the same function), as `{name} sdpa`"""
        B, T, Hq, D = q.shape
        Hk = kp.shape[0]
        kc, vc = gather_kv(torch, kp, vp, tbl, lens, ps)
        q = q.to(kp.dtype)
        lens_d = lens.to(dev, torch.long)
        if t_new == 1:
            qr = q.transpose(1, 2).reshape(B, Hk, group, D)
            calls[f"{name} sdpa"] = decode_sdpa(torch, qr, kc, vc, lens_d,
                                                group)
        else:
            calls[f"{name} sdpa"] = prefill_sdpa(
                torch, q.reshape(B * T, Hq, D), kc, vc, lens.cpu() - T, T)

    # (e) and (p): phase_k4's pool and tables (same seeds)
    B, Hk, group, D, ps, max_pages = 8, 4, 8, 64, 128, 16
    lens = torch.randint(600, 2001, (B,), generator=gen)
    tbl, n_pages = paged_tables(torch, gen, lens, ps, max_pages, dev)
    kp, vp = make_pool(torch, ggen, dev, Hk, n_pages, ps, D, torch.bfloat16)
    q = torch.randn((B, 1, Hk * group, D), generator=ggen, device=dev).to(
        torch.bfloat16)
    lens_d = lens.to(dev, torch.int32)
    add("e K4 bf16", q, kp, vp, lens_d, tbl, 1, group)
    qpools = {}
    for kind in QUANT_KINDS:
        (kq, vq, ks, vs), _ = quant_pools(torch, kp, vp, kind)
        qpools[kind] = (kq, vq, ks, vs)
        add(f"e K4q {kind}", q, kq, vq, lens_d, tbl, 1, group, (ks, vs))
    plens = torch.tensor([64, 364])
    ptbl = paged_tables(torch, gen, plens, ps, max_pages, dev)[0]
    pq = torch.randn((2, 64, Hk * group, D), generator=ggen,
                     device=dev).to(torch.bfloat16)
    add("p K4 bf16", pq, kp, vp, plens.to(dev, torch.int32), ptbl, 64, group)
    # (L)
    for kind in (None,) + QUANT_KINDS:
        lq, lk, lv, lkw, nbytes = long_decode_case(torch, ggen, kind)
        name = f"L K4{'q ' + kind if kind else ' bf16'}"
        sc = ((lkw["k_scales"], lkw["v_scales"]) if kind else None)
        add(name, lq, lk, lv, lkw["cache_seqlens"], lkw["block_table"], 1,
            LONG_HQ // LONG_HK, sc)
        del lq, lk, lv, lkw
    # fp32 (K4 fp32, K4q's fp32-q instantiations): (e), (p) and (L)
    kp32, vp32, q32, pq32 = kp.float(), vp.float(), q.float(), pq.float()
    add("e K4 fp32", q32, kp32, vp32, lens_d, tbl, 1, group)
    add_sdpa("e K4 fp32", q32, kp32, vp32, lens, tbl, ps, 1, group)
    for kind, (kq, vq, ks, vs) in qpools.items():
        add(f"e K4q fp32 q {kind}", q32, kq, vq, lens_d, tbl, 1, group,
            (ks, vs))
    add("p K4 fp32", pq32, kp32, vp32, plens.to(dev, torch.int32), ptbl, 64,
        group)
    add_sdpa("p K4 fp32", pq32, kp32, vp32, plens, ptbl, ps, 64, group)
    Lq, Lk, Lv, Lkw, _ = long_decode_case(torch, ggen)
    Lk, Lv = Lk.float(), Lv.float()
    add("L K4 fp32", Lq.float(), Lk, Lv, Lkw["cache_seqlens"],
        Lkw["block_table"], 1, LONG_HQ // LONG_HK)
    add_sdpa("L K4 fp32", Lq, Lk, Lv, Lkw["cache_seqlens"].cpu(),
             Lkw["block_table"], 512, 1, LONG_HQ // LONG_HK)
    del Lq, Lkw
    # head dims 32 and 256 (16-bit) at (e)'s lengths and tables; D 256 also
    # at its 8192-token context, at Gemma-2B's heads and at Gemma-7B's
    for tag, (Hq_, Hk_, D_) in (("D32", D32_DECODE), ("D256", D256_DECODE)):
        hk, hv = make_pool(torch, ggen, dev, Hk_, n_pages, ps, D_,
                           torch.bfloat16)
        hq = torch.randn((B, 1, Hq_, D_), generator=ggen, device=dev).to(
            torch.bfloat16)
        add(f"e K4 {tag} bf16", hq, hk, hv, lens_d, tbl, 1, Hq_ // Hk_,
            split=True)
        add_sdpa(f"e K4 {tag} bf16", hq, hk, hv, lens, tbl, ps, 1,
                 Hq_ // Hk_)
    clens = torch.full((B,), D256_CTX)
    ctbl, c_pages = paged_tables(torch, gen, clens, ps, D256_CTX // ps, dev)
    for tag, (Hq_, Hk_, D_) in (("D256", D256_DECODE),
                                ("D256 MHA", D256_MHA_DECODE)):
        ck, cv = make_pool(torch, ggen, dev, Hk_, c_pages, ps, D_,
                           torch.bfloat16)
        cq = torch.randn((B, 1, Hq_, D_), generator=ggen, device=dev).to(
            torch.bfloat16)
        add(f"8k K4 {tag} bf16", cq, ck, cv, clens.to(dev, torch.int32),
            ctbl, 1, Hq_ // Hk_, split=True)
        add_sdpa(f"8k K4 {tag} bf16", cq, ck, cv, clens, ctbl, ps, 1,
                 Hq_ // Hk_)
    calls = {name: fn for name, fn in calls.items() if rows in name}

    digests = {}
    for name, fn in calls.items():
        out = fn()
        digests[name] = digest(torch, *(out if isinstance(out, tuple)
                                        else (out,)))
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    # the read flush: the L2 left full of clean lines.  Zeroing `flush`
    # leaves up to 50 MB of dirty lines, whose write-back to HBM falls
    # inside the timed call and shares its bandwidth.
    flush_sum = torch.empty((), device=dev)

    def read_flush():
        torch.sum(flush, dim=0, out=flush_sum)
    spread = {name: [] for name in calls}
    graph = {name: [] for name in calls}
    graph_clean = {name: [] for name in calls}
    kcyc = {name: [] for name in calls}
    clocks = []
    for _ in range(DECODE_ROUNDS):
        before = gpu_clocks()
        for name, fn in calls.items():
            spread[name].append(time_ms(torch, fn, reps=SPREAD_REPS,
                                        flush=flush))
            g_ms, clock = graph_ms_clock(torch, fn, flush)
            graph[name].append(g_ms)
            kcyc[name].append(g_ms * clock["sm_mhz"])
            graph_clean[name].append(graph_ms(torch, fn, flush=read_flush))
        clocks.append((before, gpu_clocks()))
    med = statistics.median
    plain_ms = {name: statistics.median(
        time_ms(torch, fn, reps=5, flush=flush) for _ in range(DECODE_ROUNDS))
        for name, fn in plains.items() if rows in name}
    return {"digest": digests,
            "ms": {n: med(t) for n, t in spread.items()},
            "graph_ms": {n: med(t) for n, t in graph.items()},
            "kcycles": {n: med(t) for n, t in kcyc.items()},
            "graph_ms_clean": {n: med(t) for n, t in graph_clean.items()},
            "bound_ms": bounds, "ms_repeats": spread,
            "graph_ms_repeats": graph, "kcycles_repeats": kcyc,
            "graph_ms_clean_repeats": graph_clean,
            "plain_ms": plain_ms, "clocks": clocks}


# ------------------------------------------ serving, all four pools in turns

def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return dict(median=statistics.median(xs), q1=q[0], q3=q[2])


def serve_times(torch, rounds: int) -> dict:
    """Steady decode tok/s and TTFT p50 of the engine runs' traffic from a
    bf16 pool and from each quantized pool, the four engines run in turns
    (the order reversed every other round) `rounds` times after one round
    that warms up, to read the pools' difference against the spread of
    each (a decode step is host-bound, so one run of each does not
    settle it):
        python3 chip_smoke.py --serve-times ROUNDS"""
    from flash_attn_v100_tpu_torch import ModelConfig
    from flash_attn_v100_tpu_torch.models.transformer import init_params
    from flash_attn_v100_tpu_torch.ops.cuda import build

    build.build_all(["decode", "varlen_paged", "decode_quant",
                     "varlen_paged_quant"])
    cfg = ModelConfig.tinyllama_1b()
    params = init_params(cfg, seed=SEED, device="cuda", lm_head=True)
    kinds = ("bf16",) + QUANT_KINDS
    runs = {k: dict(decode_tok_s=[], ttft_p50_ms=[]) for k in kinds}
    for i in range(rounds + 1):
        for kind in (kinds if i % 2 == 0 else kinds[::-1]):
            eng = make_engine(torch, params, cfg,
                              None if kind == "bf16" else kind)
            out, rids, (_, t_a, t_b), (tok_a, tok_b) = serve_traffic(
                torch, eng, cfg)
            assert sorted(out) == sorted(rids), "every request must finish"
            if i:
                runs[kind]["decode_tok_s"].append((tok_b - tok_a)
                                                  / (t_b - t_a))
                runs[kind]["ttft_p50_ms"].append(statistics.median(
                    eng.ttft(r) for r in rids) * 1e3)
            del eng
            torch.cuda.empty_cache()
    return {kind: dict(r, **{f"{m}_quartiles": quartiles(r[m])
                             for m in ("decode_tok_s", "ttft_p50_ms")})
            for kind, r in runs.items()}


# -------------------------------------------------------------------- main

def print_build_logs(build, libs):
    """Each library of `libs` ((name, variant) pairs): its kernels'
    register range, any stack or spills, and whether ptxas serialized a
    wgmma (C7520), from nvcc's log."""
    for name, variant in libs:
        log = build.build_log(name, variant).splitlines()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in log
                if "registers" in ln and "Used " in ln]
        stack = [ln.strip() for ln in log if "stack frame" in ln
                 and not ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                               "spill stores, 0 bytes spill")]
        print(f"build {name}{'' if variant is None else '-' + variant}: "
              f"{len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
              f"stack/spills: {stack or 'none'}, wgmma serialized (C7520): "
              f"{any('C7520' in ln for ln in log)}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    times = {"--dense-times": dense_times, "--varlen-times": varlen_times,
             "--paged-times": paged_times, "--decode-times": decode_times,
             "--probe-times": probe_times, "--d32-times": d32_times,
             "--fp32-times": fp32_turn_times}
    if sys.argv[1:2] and sys.argv[1] in times:
        sys.path.insert(0, sys.argv[2])
        res = times[sys.argv[1]](torch, *sys.argv[3:])
        print(json.dumps(dict(res, tree=sys.argv[2], card=card_line())))
        return 0
    if sys.argv[1:2] == ["--measure-child"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        measure = phase_measure(torch)
        sweeps = phase_sweeps(torch, measure)
        print("measure-child: " + json.dumps(dict(measure=measure,
                                                  sweeps=sweeps),
                                             default=str), flush=True)
        return 0
    if sys.argv[1:2] == ["--dropin-child"]:
        print("dropin-child: " + json.dumps(dropin_child(torch, sys.argv[2])))
        return 0
    if sys.argv[1:2] == ["--serve-times"]:
        res = serve_times(torch, int(sys.argv[2]))
        print(json.dumps(dict(res, card=card_line())))
        return 0
    from flash_attn_v100_tpu_torch.ops.cuda import build

    card = card_line()
    print(f"card: {card}", flush=True)
    # fp32 matmuls stay full fp32 (no TF32) in the plain references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t_start = t0 = time.perf_counter()
    # the shipped libraries and the sweeps' variant libraries, every nvcc
    # at once
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc per translation "
          f"unit, concurrent: {built})", flush=True)
    # the sweep libraries, first loaded by phase_sweeps, build beside the
    # card's phases (K4's ablation, read by --decode-times only, is not
    # built here)
    from concurrent.futures import ThreadPoolExecutor
    sweeps_built = [v for v in build.all_variants() if v[0] != "decode"]
    sweep_pool = ThreadPoolExecutor(1)
    sweep_build = sweep_pool.submit(build.build_all, [],
                                    variants=sweeps_built)
    sweep_pool.shutdown(wait=False)
    print_build_logs(build, [(n, None) for n in build.SOURCES])
    # the D 256 and D 32 kernels' SASS (cuobjdump: one thread a library),
    # read beside the card's phases
    sass = kernel_sass(build)

    laps = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - laps[-1]:.1f} s ({now - t_start:.1f} s "
              f"from the build on)", flush=True)
        laps.append(now)

    flush = torch.empty(64 * 2 ** 20 // 4, device="cuda")   # > 50 MB L2
    dense = phase_dense(torch, flush)
    lap("dense")
    d256 = d256_checks(torch, flush, sass)
    lap("d256 kernels")
    d32 = d32_checks(torch, flush, sass)
    lap("d32 kernels")
    torch.cuda.empty_cache()
    varlen = phase_varlen(torch, flush)
    lap("varlen")
    torch.cuda.empty_cache()
    dropin = phase_dropin(torch)
    lap("dropin")
    torch.cuda.empty_cache()
    k4 = phase_k4(torch, flush)
    k8 = phase_k8(torch, flush)
    quant = phase_quant(torch, flush)
    lap("k4, k8, quant")
    k4["ms_repeats"] = quant["spread"]["K4 (bf16)"]
    # K4's time as K4q's: the median of the repeats timed in turns
    k4["ms"] = statistics.median(k4["ms_repeats"])
    k4["graph_ms"] = quant["graph"]["K4 (bf16)"]
    k8["ms_repeats"] = quant["spread"]["K8 (bf16)"]
    # K8's time as K8q's: the median of the repeats timed in turns
    k8["ms"] = statistics.median(k8["ms_repeats"])
    k8["graph_ms"] = quant["graph"]["K8 (bf16)"]
    for kind in QUANT_KINDS:
        quant["K8q"][kind]["occupancy"] = k8["quant_occupancy"][kind]
        quant["K4q"][kind]["occupancy"] = k4["quant_occupancy"][kind]
    probes = phase_probes(torch, flush)
    lap("probes")
    torch.cuda.empty_cache()
    fp32 = phase_fp32(torch, flush)
    lap("fp32")
    gc.collect()
    torch.cuda.empty_cache()
    del flush
    from flash_attn_v100_tpu_torch import ModelConfig
    cfg = ModelConfig.tinyllama_1b()
    train = phase_train(torch, cfg)
    torch.cuda.empty_cache()
    phase_lora(torch, cfg, train)
    lap("train, lora")
    torch.cuda.empty_cache()
    eng = phase_engine(torch, cfg)
    torch.cuda.empty_cache()
    phase_hf_serve(torch, cfg, eng)
    torch.cuda.empty_cache()
    eng_q = phase_engine_quant(torch, cfg, eng)
    lap("engine, hf_serve, engine_quant")
    torch.cuda.empty_cache()
    phase_parallel(torch, eng, eng_q)
    lap("parallel")
    # what the kernels line needs; the rest of the engines' and models'
    # results leave the card before phase_ring's ranks start
    path_launches = dict(train=train["launches"], decode=eng["launches"],
                         quant={kind: eng_q[kind]["launches"]
                                for kind in QUANT_KINDS})
    del train, eng, eng_q
    gc.collect()
    torch.cuda.empty_cache()
    ring = phase_ring(torch)
    lap("ring")
    gc.collect()
    torch.cuda.empty_cache()
    d256_path = phase_d256(torch)
    lap("d256")
    d32_path = phase_d32(torch)
    lap("d32")
    bench = phase_bench(torch)
    lap("bench")
    scripts = phase_scripts(torch, bench["dryrun"])
    lap("scripts")
    print(f"build of the sweep libraries (beside the phases): "
          f"{sweep_build.result()}", flush=True)
    print_build_logs(build, sweeps_built)
    child = phase_measure_fresh(torch)
    measure, sweeps = child["measure"], child["sweeps"]
    lap("measure, sweeps")

    rows = [
            ("K1 flash_attn_dense_fwd", dense["K1"], "fwd.cu",
             "flash_attn_v100_tpu/ops/pallas/fwd.py:152",
             path_launches["train"]["K1"]),
            ("K2 flash_attn_dense_bwd (dq)", dense["K2"], "bwd.cu",
             "flash_attn_v100_tpu/ops/pallas/bwd.py:122",
             path_launches["train"]["K2"]),
            ("K3 flash_attn_dense_bwd (dk, dv)", dense["K3"], "bwd.cu",
             "flash_attn_v100_tpu/ops/pallas/bwd.py:330",
             path_launches["train"]["K3"]),
            ("K5 flash_attn_varlen_fwd", varlen["K5"], "fwd.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:289",
             varlen["launches"]["K5"]),
            ("K6 flash_attn_varlen_bwd (dq)", varlen["K6"], "bwd.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:1160",
             varlen["launches"]["K6"]),
            ("K7 flash_attn_varlen_bwd (dk, dv)", varlen["K7"], "bwd.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:1343",
             varlen["launches"]["K7"]),
            ("K4 paged_decode_attention", k4, "decode.cu",
             "flash_attn_v100_tpu/ops/pallas/decode.py:72",
             path_launches["decode"]["decode"]),
            ("K8 flash_attn_varlen_fwd_paged", k8, "varlen_paged.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:947",
             path_launches["decode"]["varlen"])]
    for kind in QUANT_KINDS:
        rows.append((f"K4q paged_decode_attention ({kind} pool)",
                     quant["K4q"][kind], "decode_quant.cu",
                     "flash_attn_v100_tpu/ops/pallas/decode.py:72",
                     path_launches["quant"][kind]["decode"]))
    for kind in QUANT_KINDS:
        rows.append((f"K8q flash_attn_varlen_fwd_paged ({kind} pool)",
                     quant["K8q"][kind], "varlen_paged_quant.cu",
                     "flash_attn_v100_tpu/ops/pallas/varlen.py:947",
                     path_launches["quant"][kind]["varlen"]))
    kernels = []
    for name, res, src, replaces, launches in rows:
        row = dict(
            name=name, route="cuda",
            source=f"flash_attn_v100_tpu_torch/csrc/{src}", replaces=replaces,
            launches=launches, max_abs_err=res["max_abs_err"],
            max_abs_err_gate=res["gate"],
            ms=res["ms"], plain_ms=res["plain_ms"],
            bound_ms=res["bound_ms"], bound_by=res["bound_by"],
            library_ms=res["library_ms"])
        for key in ("ms_repeats", "graph_ms", "occupancy", "bench_shape",
                    "case_b", "long_context"):
            if key in res:
                row[key] = res[key]
        if name[:2] in ring["launches"]:
            row["ring_launches"] = ring["launches"][name[:2]]
        # launches of the drop-in phase: (a) through the `flash_attn` name,
        # (b) the oracle suite
        row["oracle_launches"] = dropin[
            name[:2] if name[2] == " " else
            f"{name[:3]} {name.split('(')[1].split()[0]}"]
        if "oracle_err" in res:
            row["oracle_err"] = res["oracle_err"]
            row["library"] = "SDPA over the dequantized, pre-gathered KV"
        kernels.append(row)
    # head dim 256: times at Gemma-2B's attention, B 4 x 2048, causal
    # (d256_checks), launches from phase_d256's training and serving runs
    for kid, name, src, replaces, launches in (
            ("K1", "flash_attn_dense_fwd", "fwd.cu",
             "flash_attn_v100_tpu/ops/pallas/fwd.py:152",
             d256_path["train"]["launches"]["K1"]),
            ("K2", "flash_attn_dense_bwd (dq)", "bwd.cu",
             "flash_attn_v100_tpu/ops/pallas/bwd.py:122",
             d256_path["train"]["launches"]["K2"]),
            ("K3", "flash_attn_dense_bwd (dk, dv)", "bwd.cu",
             "flash_attn_v100_tpu/ops/pallas/bwd.py:330",
             d256_path["train"]["launches"]["K3"]),
            ("K8", "flash_attn_varlen_fwd_paged", "varlen_paged.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:947",
             d256_path["serve"]["launches"]["varlen"])):
        r = d256[kid]
        kernels.append(dict(
            name=f"{kid} {name} (D 256)", route="cuda",
            source=f"flash_attn_v100_tpu_torch/csrc/{src}",
            replaces=replaces, launches=launches,
            max_abs_err=r["max_abs_err"], max_abs_err_gate=r["gate"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            hgmma=d256["hgmma"].get(kid), occupancy=r.get("occupancy")))
    # head dim 32: K1-K3 at (d32a) causal and K5-K7 at (d32b) (d32_checks),
    # launches from phase_d32's training (K1-K3) and serving (K8) runs and
    # from the encoders' path of d32_checks (K5-K7); the exponentials' bound
    # beside the kernels line's
    for kid, name, src, replaces, launches in (
            ("K1", "flash_attn_dense_fwd", "fwd.cu",
             "flash_attn_v100_tpu/ops/pallas/fwd.py:152",
             d32_path["train"]["launches"]["K1"]),
            ("K2", "flash_attn_dense_bwd (dq)", "bwd.cu",
             "flash_attn_v100_tpu/ops/pallas/bwd.py:122",
             d32_path["train"]["launches"]["K2"]),
            ("K3", "flash_attn_dense_bwd (dk, dv)", "bwd.cu",
             "flash_attn_v100_tpu/ops/pallas/bwd.py:330",
             d32_path["train"]["launches"]["K3"]),
            ("K5", "flash_attn_varlen_fwd", "fwd.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:289",
             d32["launches_b"]["K5"]),
            ("K6", "flash_attn_varlen_bwd (dq)", "bwd.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:1160",
             d32["launches_b"]["K6"]),
            ("K7", "flash_attn_varlen_bwd (dk, dv)", "bwd.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:1343",
             d32["launches_b"]["K7"]),
            ("K8", "flash_attn_varlen_fwd_paged", "varlen_paged.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:947",
             d32_path["serve"]["launches"]["varlen"])):
        r = d32[kid]
        row = dict(
            name=f"{kid} {name} (D 32)", route="cuda",
            source=f"flash_attn_v100_tpu_torch/csrc/{src}",
            replaces=replaces, launches=launches,
            max_abs_err=r["max_abs_err"], max_abs_err_gate=r["gate"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"])
        if "bound3" in r:
            row["bound3"] = r["bound3"]
            row["bound3_max_sm_mhz"] = r["bound3_clock_mhz"]
        kernels.append(row)
    # the fp32 bodies: each instantiation's worst output against its gate
    for name, outs, src, replaces in (
            ("K1 flash_attn_dense_fwd", ("K1", "K1 lse"), "fwd_f32.cu",
             "flash_attn_v100_tpu/ops/pallas/fwd.py:152"),
            ("K2 flash_attn_dense_bwd (dq)", ("K2 dq",), "bwd_f32.cu",
             "flash_attn_v100_tpu/ops/pallas/bwd.py:122"),
            ("K3 flash_attn_dense_bwd (dk, dv)", ("K3 dk", "K3 dv"),
             "bwd_f32.cu", "flash_attn_v100_tpu/ops/pallas/bwd.py:330"),
            ("K5 flash_attn_varlen_fwd", ("K5",), "fwd_f32.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:289"),
            ("K6 flash_attn_varlen_bwd (dq)", ("K6 dq",), "bwd_f32.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:1160"),
            ("K7 flash_attn_varlen_bwd (dk, dv)", ("K7 dk", "K7 dv"),
             "bwd_f32.cu", "flash_attn_v100_tpu/ops/pallas/varlen.py:1343"),
            ("K4 paged_decode_attention", ("K4", "K4 lse"), "decode_f32.cu",
             "flash_attn_v100_tpu/ops/pallas/decode.py:72"),
            ("K8 flash_attn_varlen_fwd_paged", ("K8", "K8 lse"),
             "fwd_f32.cu", "flash_attn_v100_tpu/ops/pallas/varlen.py:947")):
        kid = name[:2]
        worst = max((fp32["errs"][o] for o in outs),
                    key=lambda r: r["err"] / r["gate"])
        t = fp32["times"][kid]
        kernels.append(dict(
            name=f"{name} (fp32)", route="cuda",
            source=f"flash_attn_v100_tpu_torch/csrc/{src}",
            replaces=replaces, launches=fp32["launches"][kid],
            max_abs_err=worst["err"], max_abs_err_gate=worst["gate"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            library=t["library"], ffma_bound_ms=t["ffma_bound_ms"],
            split_bound_ms=t["split_bound_ms"],
            **{key: t[key] for key in ("library_gqa_ms", "graph_ms")
               if key in t},
            error_vs="the fp64 oracle", gate=FP32_GATE))
    # K4q / K8q's fp32-q instantiations: launches from the tiny model's
    # engine runs over each pool
    for kid, name, src, replaces, route in (
            ("K4q", "paged_decode_attention", "decode_quant.cu",
             "flash_attn_v100_tpu/ops/pallas/decode.py:72", "decode"),
            ("K8q", "flash_attn_varlen_fwd_paged", "varlen_paged_quant.cu",
             "flash_attn_v100_tpu/ops/pallas/varlen.py:947", "varlen")):
        for kind in QUANT_KINDS:
            r = fp32["quant"][kid][kind]
            kernels.append(dict(
                name=f"{kid} fp32 {kind} {name} (fp32 q, {kind} pool)",
                route="cuda", source=f"flash_attn_v100_tpu_torch/csrc/{src}",
                replaces=replaces,
                launches=fp32["quant_launches"][kind][route],
                max_abs_err=r["max_abs_err"], max_abs_err_gate=r["gate"],
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                library="fp32 SDPA over the dequantized, pre-gathered KV",
                oracle_err=r["oracle_err"], gate=QUANT_GATE))
    for res in probes:
        row = dict(name=res["name"], route="cuda",
                   source=f"flash_attn_v100_tpu_torch/csrc/{res['source']}",
                   replaces=res["replaces"], launches=res["launches"],
                   max_abs_err=res["max_abs_err"],
                   max_abs_err_gate=res["gate"], ms=res["ms"],
                   plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                   bound_by=res["bound_by"], library_ms=res["library_ms"])
        for key in ("ms_repeats", "row_ratio", "lse_rel", "shape", "sass",
                    "flags", "bound_ms_int8_rate", "ops_peak",
                    "small_graph_ms"):
            if key in res:
                row[key] = res[key]
        if res["library_ms"] is not None:
            row["library"] = ("torch._int_mm on the int8-unpacked operands"
                              if res["suite"] == "P4" else
                              "SDPA, enable_gqa, non-causal")
        kernels.append(row)
    print(f"bench headline: {json.dumps(bench['headline'])}", flush=True)
    print(f"scripts: {json.dumps(scripts)}", flush=True)
    print(f"measure: {json.dumps(measure, default=str)}", flush=True)
    print(f"sweeps: {json.dumps(sweeps, default=str)}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the build "
          f"on", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
