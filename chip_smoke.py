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
    (their device time without the wrapper's host time).
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
TinyLlama width on seq 2 x model 2 against the unsharded run, with each
rank's K1-K3 launch counts.  Then the cost probes P1-P4 (`phase_probes`,
run after the quantized kernels): each probe variant's SASS holds the
tensor-core (HGMMA) and exp2 (MUFU.EX2) instructions its stages claim,
the four probe scripts (`python -m flash_attn_v100_tpu_torch.benchmarks.*`)
run as the probes' main path, and every variant is held against its plain
twin at the TPU scripts' shapes and timed in turns beside SDPA (P1-P3) or
torch._int_mm (P4).  Last, `phase_bench` runs the port's bench
(`python -m flash_attn_v100_tpu_torch.bench`: its headline JSON line must
carry a value > 0) and the three examples as subprocesses on the card
(train_seq_parallel on 2 gloo ranks).  Prints the card, a `kernels` JSON
line, and as its last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
Any failed phase raises and the script exits non-zero; with no GPU, or
without the package beside it, it exits non-zero and prints no result.

    python3 chip_smoke.py --dense-times TREE

instead times K1-K3 of the port found in the directory TREE (a checkout,
e.g. of a parent commit) at the training shape and prints a digest of each
kernel's outputs, to compare two trees on one card in one call;

    python3 chip_smoke.py --varlen-times TREE

does the same for K5-K7 at the varlen phase's packed documents, and

    python3 chip_smoke.py --paged-times TREE

for K8 and K8q (int8, fp8, int4) at the K8 phase's shape and K8 at the
headline head shape (32 / 8 heads x 128), timed in turns;

    python3 chip_smoke.py --decode-times TREE

for K4 and K4q (int8, fp8, int4) through flash_attn_with_kvcache and
paged_decode_attention at the engine's decode step, its short-prompt
prefill and a 32k-context decode, with the SM clock and power around
each round.

    python3 chip_smoke.py --serve-times ROUNDS

instead serves the engine runs' traffic from a bf16, an int8, an fp8 and
an int4 pool in turns, ROUNDS times each after a warm-up round, and prints
each pool's decode tok/s and TTFT p50 with their medians and quartiles.
"""

from __future__ import annotations

import contextlib
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
    is flushed before each timed call when `flush` is given."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
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
    """K4 and K4q (each payload kind) in bf16 at D 64 / 128, in 16-row
    blocks (Rq <= 16: the warps split the keys) and 64-row ones:
    registers, local memory, dynamic shared memory (without the page
    table), threads and resident blocks a multiprocessor, from
    `fa_decode_occupancy` / `fa_decode_quant_occupancy`.  Asserts no local
    memory, and >= 8 resident warps at 16 rows."""
    import ctypes
    from flash_attn_v100_tpu_torch.ops.cuda.decode import KIND_CODE
    res = {}
    for name in ("K4",) + tuple(f"K4q {kind}" for kind in QUANT_KINDS):
        for D in (64, 128):
            for rows in (16, 64):
                out = (ctypes.c_int * 5)()
                at = ctypes.addressof(out)
                if name == "K4":
                    rc = build.load("decode").fa_decode_occupancy(0, D, rows,
                                                                  at)
                else:
                    rc = build.load("decode_quant").fa_decode_quant_occupancy(
                        KIND_CODE[name.split()[1]], 0, D, rows, at)
                build.check(rc, f"{name} occupancy")
                blocks, smem, threads, regs, local = out
                o = res[(name, D, rows)] = dict(
                    registers=regs, local_bytes=local, smem_bytes=smem,
                    threads=threads, blocks_per_sm=blocks,
                    warps_per_sm=blocks * threads // 32)
                print(f"{name} occupancy (bf16, D {D}, {rows}-row blocks): "
                      f"{regs} registers, local memory {local} B, {smem} B "
                      f"dynamic shared memory and {threads} threads a block, "
                      f"{blocks} blocks = {o['warps_per_sm']} warps resident "
                      f"a multiprocessor", flush=True)
                assert local == 0, f"{name} D {D} rows {rows} spills"
                assert rows > 16 or o["warps_per_sm"] >= 8, \
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

def k8_case(torch):
    """The engine's prefill wave as K8 sees it: 4 sequences of 512 new
    tokens behind cached prefixes 0/300/0/300, 32/4 heads x 64, page 128,
    bf16, from fixed seeds.  Returns (sizes (B, T, Hq, Hk, D, ps), prefix,
    seqlens, q, kp, vp, the call's arguments after the pools, the CUDA
    generator for more inputs)."""
    from flash_attn_v100_tpu_torch.ops import masks as masklib

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    ggen = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, T, Hq, Hk, D, ps = 4, 512, 32, 4, 64, 128
    prefix = torch.tensor([0, 300, 0, 300])
    seqlens = prefix + T
    max_k = int(seqlens.max())
    tbl, n_pages = paged_tables(torch, gen, seqlens, ps, -(-max_k // ps),
                                dev)
    kp, vp = make_pool(torch, ggen, dev, Hk, n_pages, ps, D, torch.bfloat16)
    q = torch.randn((B * T, Hq, D), generator=ggen, device=dev).to(
        torch.bfloat16)
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


def dense_work(B, S, Hq, Hk, D):
    """(flops, bytes) of K1, K2 and K3 for a causal B x S x Hq x D call:
    4, 6 and 8 flops x D per live (q row, key) pair (2, 3 and 4 products),
    each input read once and each output written once."""
    pairs = B * Hq * S * (S + 1) // 2
    q_bytes, kv_bytes, row_bytes = B * S * Hq * D * 2, B * S * Hk * D * 2, \
        B * Hq * S * 4
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


def varlen_work(lens, Hq, Hk, D):
    """(flops, bytes) of K5, K6 and K7 for causal self-attention over
    sequences of `lens`: dense_work's rule per sequence (4, 6 and 8 flops x
    D per live (q row, key) pair), each input read once and each output
    written once."""
    pairs = Hq * sum(n * (n + 1) // 2 for n in lens)
    T = sum(lens)
    q_bytes, kv_bytes, row_bytes = T * Hq * D * 2, T * Hk * D * 2, T * Hq * 4
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


def varlen_library(torch, q, k, v, cu, max_len):
    """The library yardstick for causal varlen attention: one call of
    torch.nn.attention.varlen.varlen_attn where the installed torch has it,
    else SDPA (`enable_gqa`) with a boolean block-diagonal causal mask over
    the packed sequence.  Returns (label, forward fn, output)."""
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
            kw["window_size"] = (-1, 0)
        else:
            kw["is_causal"] = True

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
    mask = (seg[:, None] == seg[None, :]) & (pos[None, :] <= pos[:, None])
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


def serve_traffic(torch, eng, cfg):
    """The engine runs' traffic: N_LONG prompts of LONG_LEN tokens
    prefilled in one step (the K8 route), then SHORT_LENS prompts beside
    their decodes (the K4 route), N_NEW greedy tokens each.  Returns (the
    outputs, the request ids, the host clock at submit / after the second
    step / at the end, the tokens generated at the last two)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    long_prompts = [rng.integers(1, cfg.vocab_size, LONG_LEN).tolist()
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
# (c): TinyLlama-1.1B width, B 2 x 2049 tokens (1024 rows a rank after the
# shift), three AdamW steps through make_train_step(mesh=) on seq 2 x
# model 2
RT_MESH, RT_B, RT_S, RT_STEPS, RT_LAYERS = (1, 2, 2), 2, 2048, 3, 22
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
    from flash_attn_v100_tpu_torch import ModelConfig
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.parallel import make_mesh
    cfg = ModelConfig.tinyllama_1b()
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
    from flash_attn_v100_tpu_torch import ModelConfig
    from flash_attn_v100_tpu_torch.models import transformer as tm
    from flash_attn_v100_tpu_torch.ops import flash_attention as fa_mod
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    from flash_attn_v100_tpu_torch.parallel.mesh import AXES, Mesh
    cfg = ModelConfig.tinyllama_1b()
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
    planted fault of RT_FAULTS, which the gates must catch.  Plain twins
    are never called in a rank.  Returns the launch counts for the kernels
    line."""
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

    print(f"ring (c) make_train_step(mesh=) at TinyLlama-1.1B width (22 "
          f"layers, bf16), B {RT_B} x {RT_S + 1} tokens: the step-1 loss "
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
S4_PEAK = "none listed"   # the H100 data sheet lists no int4 rate
PROBE_ROUNDS, PROBE_REPS = 3, 10


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
    probe scripts run as their main path."""
    import re

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
    sass4 = subprocess.run(
        [str(build.Path(build.nvcc_path()).with_name("cuobjdump")), "-sass",
         str(build.library_path("probe_int4"))], capture_output=True,
        text=True, check=True, timeout=300).stdout
    imma = {k: sass4.count(k) for k in sorted(set(re.findall(
        r"IMMA\.\S+", sass4)))}
    print(f"probe_int4 SASS tensor-core instructions: {imma} (an s4 IMMA "
          f"{'present' if any('S4' in k for k in imma) else 'absent'})",
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
    for name, fn, twin_fn, pack in (
            ("int4xint4", p4.int4_matmul, p4.int4_matmul_ref, True),
            ("int8xint4", p4.int8_int4_matmul, p4.int8_int4_matmul_ref,
             False)):
        errs = []
        for q8, kp in (small, large):
            a = p4.pack_int4(q8) if pack else q8
            out = fn(a, kp)
            torch.cuda.synchronize()
            errs.append(int((out - twin_fn(a, kp)).abs().max()))
        assert errs == [0, 0], f"P4 {name}: not exact {errs}"
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
        print(f"P4 {name}: exact at 128x256x128 and {INT4_LARGE}^3; "
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
            small_graph_ms=small_ms, sass_imma=imma))
    return rows


def phase_bench(torch):
    """The port's bench (`python -m flash_attn_v100_tpu_torch.bench`) and
    the three examples, each a subprocess on the card: the bench must exit
    0 with its JSON line's value > 0, each example 0 with its shapes
    printed; train_seq_parallel spawns 2 gloo ranks sharing the card."""
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
    secs = {}
    for name, lines in want.items():
        t1 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", f"flash_attn_v100_tpu_torch.examples.{name}"],
            capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S)
        secs[name] = time.perf_counter() - t1
        assert r.returncode == 0, f"{name} exited {r.returncode}: {r.stderr[-2000:]}"
        for want_line in lines:
            assert want_line in r.stdout, f"{name}: no {want_line!r} in {r.stdout!r}"
        print(f"example {name} ({secs[name]:.1f} s): "
              f"{' | '.join(r.stdout.strip().splitlines())}", flush=True)
    return dict(headline=head[-1], bench_s=time.perf_counter() - t0,
                example_s=secs)


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
    0.1 (K1: out and LSE; K2: dq; K3: dk and dv) and their times, and K1's
    time at the headline prefill shape, to compare two trees of the port
    in one call:
        python3 chip_smoke.py --dense-times TREE
    K2 and K3 take the plain forward's out and LSE in bf16, not K1's, so
    their inputs are the same in every tree."""
    from flash_attn_v100_tpu_torch.config import NEG_INF
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd

    build.build_all(["fwd", "bwd"])
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
    return {"digest": digests, "ms": ms}


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
    return {"digest": digests, "ms": ms}


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


def decode_times(torch) -> dict:
    """K4 and K4q of the `flash_attn_v100_tpu_torch` on sys.path, through
    the public decode call flash_attn_with_kvcache(q, k_cache, v_cache,
    cache_seqlens=, block_table=, causal=True, kv_cache_layout="HND") (no
    append; scales for K4q) and through paged_decode_attention alone
    (`core`, partials unmerged), at
      (e) phase_k4's engine decode step (B 8, 32 / 4 heads x 64, page 128,
          lens 600-2000): K4 and K4q x 3;
      (p) the engine's short-prompt prefill on the K4 route (B 2, T_new
          64, lens 64 / 364): K4;
      (L) the 32k-context decode of LONG_*: bf16, int8, fp8 (page 512)
          and int4 (page 2048).
    Each call is timed as a call (`ms`) and as CUDA-graph replays
    (`graph_ms`), SPREAD_REPEATS rounds in turns of SPREAD_REPS launches,
    the L2 flushed before each; a digest of each call's out, and the SM
    clock and power draw before and after each round:
        python3 chip_smoke.py --decode-times TREE"""
    from flash_attn_v100_tpu_torch.ops import kvcache as kv
    from flash_attn_v100_tpu_torch.ops import masks as masklib
    from flash_attn_v100_tpu_torch.ops.cuda import build
    from flash_attn_v100_tpu_torch.ops.cuda import decode as dec

    build.build_all(["decode", "decode_quant"])
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ggen = torch.Generator(device=dev).manual_seed(SEED)
    calls, bounds = {}, {}

    def add(name, q, kc, vc, lens, tbl, t_new, group, scales=None):
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
        calls[f"{name} core"] = lambda: dec.paged_decode_attention(
            rows, kc[None], vc[None], tbl, lens, None,
            qpos_vec=lens - t_new, softmax_scale=D ** -0.5, params=params,
            t_new=t_new, group=group,
            k_scales=None if scales is None else scales[0][None],
            v_scales=None if scales is None else scales[1][None], int4=int4)

    # (e) and (p): phase_k4's pool and tables (same seeds)
    B, Hk, group, D, ps, max_pages = 8, 4, 8, 64, 128, 16
    lens = torch.randint(600, 2001, (B,), generator=gen)
    tbl, n_pages = paged_tables(torch, gen, lens, ps, max_pages, dev)
    kp, vp = make_pool(torch, ggen, dev, Hk, n_pages, ps, D, torch.bfloat16)
    q = torch.randn((B, 1, Hk * group, D), generator=ggen, device=dev).to(
        torch.bfloat16)
    lens_d = lens.to(dev, torch.int32)
    add("e K4 bf16", q, kp, vp, lens_d, tbl, 1, group)
    for kind in QUANT_KINDS:
        (kq, vq, ks, vs), _ = quant_pools(torch, kp, vp, kind)
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
        bounds[name] = nbytes / HBM_BYTES_PER_S * 1e3
    digests = {}
    for name, fn in calls.items():
        out = fn()
        digests[name] = digest(torch, *(out if isinstance(out, tuple)
                                        else (out,)))
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    spread = {name: [] for name in calls}
    graph = {name: [] for name in calls}
    clocks = []
    for _ in range(SPREAD_REPEATS):
        before = gpu_clocks()
        for name, fn in calls.items():
            spread[name].append(time_ms(torch, fn, reps=SPREAD_REPS,
                                        flush=flush))
            graph[name].append(graph_ms(torch, fn, reps=SPREAD_REPS,
                                        flush=flush))
        clocks.append((before, gpu_clocks()))
    return {"digest": digests,
            "ms": {n: statistics.median(t) for n, t in spread.items()},
            "graph_ms": {n: statistics.median(t) for n, t in graph.items()},
            "bound_ms": bounds, "ms_repeats": spread,
            "graph_ms_repeats": graph, "clocks": clocks}


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

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    times = {"--dense-times": dense_times, "--varlen-times": varlen_times,
             "--paged-times": paged_times, "--decode-times": decode_times}
    if sys.argv[1:2] and sys.argv[1] in times:
        sys.path.insert(0, sys.argv[2])
        res = times[sys.argv[1]](torch)
        print(json.dumps(dict(res, tree=sys.argv[2], card=card_line())))
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
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc per source, "
          f"concurrent: {built})", flush=True)
    for name in build.SOURCES:
        log = build.build_log(name).splitlines()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in log
                if "registers" in ln and "Used " in ln]
        stack = [ln.strip() for ln in log if "stack frame" in ln
                 and not ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                               "spill stores, 0 bytes spill")]
        print(f"build {name}: {len(regs)} kernels, registers "
              f"{min(regs)}-{max(regs)}, stack/spills: {stack or 'none'}",
              flush=True)

    flush = torch.empty(64 * 2 ** 20 // 4, device="cuda")   # > 50 MB L2
    dense = phase_dense(torch, flush)
    torch.cuda.empty_cache()
    varlen = phase_varlen(torch, flush)
    torch.cuda.empty_cache()
    k4 = phase_k4(torch, flush)
    k8 = phase_k8(torch, flush)
    quant = phase_quant(torch, flush)
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
    torch.cuda.empty_cache()
    del flush
    from flash_attn_v100_tpu_torch import ModelConfig
    cfg = ModelConfig.tinyllama_1b()
    train = phase_train(torch, cfg)
    torch.cuda.empty_cache()
    phase_lora(torch, cfg, train)
    torch.cuda.empty_cache()
    eng = phase_engine(torch, cfg)
    torch.cuda.empty_cache()
    phase_hf_serve(torch, cfg, eng)
    torch.cuda.empty_cache()
    eng_q = phase_engine_quant(torch, cfg, eng)
    torch.cuda.empty_cache()
    phase_parallel(torch, eng, eng_q)
    # what the kernels line needs; the rest of the engines' and models'
    # results leave the card before phase_ring's ranks start
    path_launches = dict(train=train["launches"], decode=eng["launches"],
                         quant={kind: eng_q[kind]["launches"]
                                for kind in QUANT_KINDS})
    del train, eng, eng_q
    gc.collect()
    torch.cuda.empty_cache()
    ring = phase_ring(torch)
    gc.collect()
    torch.cuda.empty_cache()
    bench = phase_bench(torch)

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
        if "oracle_err" in res:
            row["oracle_err"] = res["oracle_err"]
            row["library"] = "SDPA over the dequantized, pre-gathered KV"
        kernels.append(row)
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
                    "small_graph_ms", "sass_imma"):
            if key in res:
                row[key] = res[key]
        if res["library_ms"] is not None:
            row["library"] = ("torch._int_mm on the int8-unpacked operands"
                              if res["suite"] == "P4" else
                              "SDPA, enable_gqa, non-causal")
        kernels.append(row)
    print(f"bench headline: {json.dumps(bench['headline'])}", flush=True)
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
