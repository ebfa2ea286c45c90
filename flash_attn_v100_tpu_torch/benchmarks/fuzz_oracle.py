"""Randomized differential testing against the fp32 oracle, on the card.

The counterpart of the JAX repository's `benchmarks/fuzz_oracle.py`: it
draws the same (op, shape, feature) configurations and the same inputs, in
the same order from the same `np.random.default_rng(seed * 100003 + i)`,
including the awkward cases fixed test matrices avoid (unaligned sequence
lengths, M != N alignments, zero-length packed sequences, leftpad and
seqused_k combinations, single-head and MQA extremes), and gates every one
with the reference's relative-tolerance rule (utils/testing.py).  A fixed
seed makes a failure reproducible: rerun with the printed trial id.

    python -m flash_attn_v100_tpu_torch.benchmarks.fuzz_oracle [n_trials] [seed]
"""

from __future__ import annotations

import sys
import traceback

import numpy as np
import torch

from flash_attn_v100_tpu_torch.benchmarks.common import normal, run_device
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.reference import (
    mha_reference, mha_reference_kvcache, mha_reference_varlen)
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func
from flash_attn_v100_tpu_torch.utils.testing import assert_fwd_close

DS = [32, 40, 64, 96, 128, 256]


def sample_features(r):
    causal = bool(r.integers(0, 2))
    window = (-1, -1)
    if r.integers(0, 3) == 0:
        wl = int(r.integers(0, 300))
        wr = -1 if causal or r.integers(0, 2) else int(r.integers(0, 64))
        window = (wl, wr)
    softcap = 0.0 if r.integers(0, 3) else float(r.choice([8.0, 30.0]))
    alibi = (not softcap) and r.integers(0, 4) == 0
    return causal, window, softcap, alibi


def _f32(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(dev)


def _i32(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32).to(dev)


def trial_dense(r, mk, dev):
    B = int(r.integers(1, 4))
    Hk = int(r.choice([1, 2, 4]))
    group = int(r.choice([1, 2, 4]))
    Hq = Hk * group
    D = int(r.choice(DS))
    M = int(r.integers(1, 700))
    N = M if r.integers(0, 2) else int(r.integers(1, 700))
    causal, window, softcap, alibi = sample_features(r)
    slopes = _f32(r.uniform(0.01, 0.3, (B, Hq)), dev) if alibi else None
    q, k, v = mk(B, M, Hq, D), mk(B, N, Hk, D), mk(B, N, Hk, D)
    kw = dict(causal=causal, window_size=window, softcap=softcap,
              alibi_slopes=slopes)
    out = flash_attn_func(q, k, v, **kw)
    ref32 = mha_reference(q, k, v, upcast=True, **kw)
    refnat = mha_reference(q, k, v, upcast=False, **kw)
    assert_fwd_close(out, ref32, refnat,
                     f"dense B{B} M{M} N{N} Hq{Hq}/{Hk} D{D} "
                     f"{dict(kw, alibi_slopes=alibi)}")


def trial_varlen(r, mk, dev):
    Hk = int(r.choice([1, 2, 4]))
    Hq = Hk * int(r.choice([1, 2, 4]))
    D = int(r.choice(DS))
    nseq = int(r.integers(1, 6))
    lens = [int(x) for x in r.integers(0, 500, nseq)]  # zero-length allowed
    if sum(lens) == 0:
        lens[0] = 7
    Tq = sum(lens)
    causal, window, softcap, alibi = sample_features(r)
    slopes = _f32(r.uniform(0.01, 0.3, (Hq,)), dev) if alibi else None
    cu = _i32(np.concatenate([[0], np.cumsum(lens)]), dev)
    seqused = None
    if r.integers(0, 3) == 0:
        seqused = _i32([max(1, int(r.integers(1, L + 1))) if L else 0
                        for L in lens], dev)
    q, k, v = mk(Tq, Hq, D), mk(Tq, Hk, D), mk(Tq, Hk, D)
    kw = dict(causal=causal, window_size=window, softcap=softcap)
    out = flash_attn_varlen_func(
        q, k, v, cu, cu, max(lens), max(lens), alibi_slopes=slopes,
        seqused_k=seqused, **kw)
    ref32 = mha_reference_varlen(q, k, v, cu, cu, upcast=True,
                                 alibi_slopes=slopes, seqused_k=seqused, **kw)
    refnat = mha_reference_varlen(q, k, v, cu, cu, upcast=False,
                                  alibi_slopes=slopes, seqused_k=seqused, **kw)
    assert_fwd_close(out, ref32, refnat,
                     f"varlen lens={lens} Hq{Hq}/{Hk} D{D} alibi={alibi} "
                     f"seqused={seqused is not None} {kw}")


def trial_kvcache(r, mk, dev):
    B = int(r.integers(1, 4))
    Hk = int(r.choice([1, 2, 4]))
    Hq = Hk * int(r.choice([1, 2, 4]))
    D = int(r.choice([32, 64, 128, 256]))
    N = int(r.integers(64, 900))
    T_new = int(r.choice([0, 1, 1, 1, 3, 7]))
    causal, window, softcap, _ = sample_features(r)
    cs_np = r.integers(T_new and 1, max(2, N - T_new), B)
    cs = _i32(cs_np, dev)
    leftpad = None
    if r.integers(0, 4) == 0:
        # used cache span is [leftpad, leftpad + cs + T_new) -- keep it in N
        leftpad = _i32(
            [int(r.integers(0, max(1, min(int(c) // 2, N - T_new - int(c))
                                   + 1))) for c in cs_np], dev)
    rotary = r.integers(0, 3) == 0
    cos = sin = None
    if rotary:
        rot_dim = D - (D % 16) or 16
        if rot_dim > D:
            rotary, cos, sin = False, None, None
        else:
            ang = r.uniform(0, 3, (N + 8, rot_dim // 2))
            cos, sin = _f32(np.cos(ang), dev), _f32(np.sin(ang), dev)
    interleaved = bool(r.integers(0, 2))
    kc, vc = mk(B, N, Hk, D), mk(B, N, Hk, D)
    q = mk(B, max(T_new, 1), Hq, D)
    kn = vn = None
    if T_new > 0:
        kn, vn = mk(B, T_new, Hk, D), mk(B, T_new, Hk, D)
    else:
        q = mk(B, int(r.integers(1, 5)), Hq, D)
    kw = dict(causal=causal, window_size=window, softcap=softcap,
              rotary_interleaved=interleaved)
    # the port appends in place: the oracle keeps the untouched caches
    res = flash_attn_with_kvcache(
        q, kc.clone(), vc.clone(), k=kn, v=vn, rotary_cos=cos,
        rotary_sin=sin, cache_seqlens=cs, cache_leftpad=leftpad, **kw)
    out = res[0] if isinstance(res, tuple) else res
    ref32, _, _ = mha_reference_kvcache(
        q, kc, vc, k_new=kn, v_new=vn, rotary_cos=cos, rotary_sin=sin,
        cache_seqlens=cs, cache_leftpad=leftpad, upcast=True, **kw)
    refnat, _, _ = mha_reference_kvcache(
        q, kc, vc, k_new=kn, v_new=vn, rotary_cos=cos, rotary_sin=sin,
        cache_seqlens=cs, cache_leftpad=leftpad, upcast=False, **kw)
    lp = None if leftpad is None else leftpad.tolist()
    assert_fwd_close(out, ref32, refnat,
                     f"kvcache B{B} N{N} Tn{T_new} Hq{Hq}/{Hk} D{D} "
                     f"cs={cs_np.tolist()} lp={lp} rot={rotary} {kw}")


TRIALS = {"dense": trial_dense, "varlen": trial_varlen,
          "kvcache": trial_kvcache}


def main(n: int = 30, seed: int = 0, device: str = "cuda") -> int:
    """Run trials 0 .. n - 1 of `seed`; prints a line a trial and the
    summary, returns the number that failed."""
    dev = run_device(device)
    fails = 0
    for i in range(n):
        r = np.random.default_rng(seed * 100003 + i)

        def mk(*s):
            return normal(r, s, dev)
        kind = ("dense", "varlen", "kvcache")[int(r.integers(0, 3))]
        try:
            TRIALS[kind](r, mk, dev)
            print(f"trial {i:3d} {kind:8s} OK", flush=True)
        except AssertionError as e:
            fails += 1
            print(f"trial {i:3d} {kind:8s} FAIL: {e}", flush=True)
        except Exception as e:  # noqa: BLE001  (each trial reports its own)
            fails += 1
            print(f"trial {i:3d} {kind:8s} ERROR: {type(e).__name__}: {e}",
                  flush=True)
            traceback.print_exc()
    print(f"fuzz_oracle: {n - fails}/{n} passed", flush=True)
    return fails


if __name__ == "__main__":
    sys.exit(1 if main(int(sys.argv[1]) if len(sys.argv) > 1 else 30,
                       int(sys.argv[2]) if len(sys.argv) > 2 else 0) else 0)
