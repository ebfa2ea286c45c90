"""The port's CUDA kernels (K4 decode, K8 paged prefill) and the entry points
that reach them, on the card, against their plain PyTorch versions on the
same device.  Every test takes the `cuda` fixture, which skips where no CUDA
device is present; on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks.)

Gates: kernel outputs and LSEs by the tolerance model of utils/testing.py
(error against the fp32 plain version within 2x the same-dtype plain
version's error + 1e-5); an LSE of -inf (no live key) must match exactly;
appended cache payloads without rotary bit-equal to the CPU append.
"""

import numpy as np
import pytest
import torch

from flash_attn_v100_tpu_torch import ModelConfig, ServingEngine
from flash_attn_v100_tpu_torch.models import transformer as tmodel
from flash_attn_v100_tpu_torch.ops import kvcache as kv
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import build
from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
from flash_attn_v100_tpu_torch.runtime import engine as eng_mod
from flash_attn_v100_tpu_torch.utils.testing import (
    assert_close_rel, assert_fwd_close)

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}
HEAD_DIMS = (32, 64, 128, 256)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()          # both kernels, nvcc processes in parallel
    return torch.device("cuda")


def _gate_lse(lse, lse32, lse_nat, name):
    fin = torch.isfinite(lse32)
    assert torch.equal(fin, torch.isfinite(lse)), f"{name}: -inf rows differ"
    if fin.any():
        assert_fwd_close(lse[fin], lse32[fin], lse_nat[fin], name=name)


# ------------------------------------------------------------------ K4

# name: (group, t_new, num_splits, mask kwargs, leftpad, alibi, layout)
DECODE_CASES = {
    "t1": (8, 1, 0, dict(window_right=0), False, False, "pool"),
    "t1_leftpad_splits3": (8, 1, 3, dict(window_right=0), True, False,
                           "pool"),
    "t4_window_softcap_alibi": (
        8, 4, 0, dict(causal=True, window_left=40, window_right=0,
                      softcap=20.0), True, True, "pool"),
    "t1_empty_row_splits1": (8, 1, 1, dict(window_right=0), False, False,
                             "pool"),
    "t16_group4_contiguous": (4, 16, 0, dict(causal=True, window_right=0),
                              False, False, "contiguous"),
}


def _decode_inputs(name, dtype, D, dev):
    group, t_new, splits, mkw, leftpad, alibi, layout = DECODE_CASES[name]
    rng = np.random.default_rng(7)
    B, Hk, ps, max_pages = 3, 2, 32, 8
    cap = ps * max_pages
    n_rows = group * t_new
    Rq = max(-(-n_rows // 8) * 8, 8)
    lens = rng.integers(t_new + 1, cap - 40, B).astype(np.int32)
    lp = (rng.integers(0, 40, B) if leftpad else np.zeros(B)).astype(np.int32)
    if name.startswith("t1_empty_row"):
        lens[0] = 0
    q = rng.standard_normal((B, Hk, Rq, D)).astype(np.float32)
    q[:, :, n_rows:] = 0.0
    if layout == "contiguous":
        # a contiguous (B, Hk, N, D) cache seen as pages: id b * nb + i
        k = rng.standard_normal((B, Hk, cap, D)).astype(np.float32)
        v = rng.standard_normal((B, Hk, cap, D)).astype(np.float32)
        k, v = (x.reshape(B, Hk, max_pages, ps, D) for x in (k, v))
        tbl = (np.arange(B)[:, None] * max_pages
               + np.arange(max_pages)[None]).astype(np.int32)
    else:
        P = B * max_pages + 1
        k = rng.standard_normal((1, Hk, P, ps, D)).astype(np.float32)
        v = rng.standard_normal((1, Hk, P, ps, D)).astype(np.float32)
        tbl = rng.permutation(np.arange(1, P)).reshape(B, max_pages)
        tbl = tbl.astype(np.int32)
    slopes = rng.uniform(0.01, 0.2, (B, Hk, Rq, 1)).astype(np.float32)

    def t(x, dt=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)

    args = (t(q, dtype), t(k, dtype), t(v, dtype), t(tbl), t(lens), t(lp))
    kw = dict(qpos_vec=t(lens - t_new), softmax_scale=D ** -0.5,
              params=masklib.MaskParams(has_alibi=alibi, **mkw), t_new=t_new,
              group=group, num_splits=splits,
              alibi_slopes_rows=t(slopes) if alibi else None)
    return args, kw


@pytest.mark.parametrize("name", list(DECODE_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_decode_kernel_matches_plain(cuda, dt, D, name):
    args, kw = _decode_inputs(name, DTYPES[dt], D, cuda)
    before = dec.paged_decode_attention.launches
    o, lse = dec.merge_partials(*dec.paged_decode_attention(*args, **kw))
    torch.cuda.synchronize()
    assert dec.paged_decode_attention.launches == before + 1
    o32, lse32 = dec.merge_partials(*dec.paged_decode_attention_ref(
        *args, **kw))
    onat, lsenat = dec.merge_partials(*dec.paged_decode_attention_ref(
        *args, upcast=False, **kw))
    assert_fwd_close(o, o32, onat, name=f"K4 {name} out")
    _gate_lse(lse, lse32, lsenat, f"K4 {name} lse")
    if name.startswith("t1_empty_row"):
        assert torch.isneginf(lse[0]).all() and not o[0].any()


# ------------------------------------------------------------------ K8

# name: (q lens, cache prefixes, leftpad, seqused cut, page size, mask kwargs,
#        alibi)
VARLEN_CASES = {
    "causal_prefix": ([100, 1, 71], [0, 130, 257], None, None, 128,
                      dict(causal=True, window_right=0), False),
    "window_softcap_alibi": ([64, 129, 33], [5, 0, 300], None, None, 128,
                             dict(causal=True, window_left=50,
                                  window_right=0, softcap=20.0), True),
    "seqused_leftpad": ([90, 40, 17], [60, 200, 3], [0, 7, 19], [0, 5, 20],
                        128, dict(causal=True, window_right=0), False),
    "ps256_empty_rows": ([0, 80, 30], [10, 0, 140], None, [0, 0, 170], 256,
                         dict(causal=True, window_right=0), False),
}


def _varlen_inputs(name, dtype, D, dev):
    qlens, prefix, lp, cut, ps, mkw, alibi = VARLEN_CASES[name]
    rng = np.random.default_rng(11)
    Hq, Hk = 8, 2
    qlens, prefix = np.asarray(qlens), np.asarray(prefix)
    B = len(qlens)
    lp = np.zeros(B, np.int64) if lp is None else np.asarray(lp)
    seqlens = lp + prefix + qlens
    seqused = None if cut is None else seqlens - np.asarray(cut)
    max_k = int(seqlens.max())
    mp = -(-max_k // ps)
    P = B * mp + 1
    k = rng.standard_normal((Hk, P, ps, D)).astype(np.float32)
    v = rng.standard_normal((Hk, P, ps, D)).astype(np.float32)
    tbl = rng.permutation(np.arange(1, P)).reshape(B, mp).astype(np.int32)
    q = rng.standard_normal((int(qlens.sum()), Hq, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    slopes = rng.uniform(0.01, 0.2, (B, Hq)).astype(np.float32)

    def t(x, dt=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)

    def i32(x):
        return None if x is None else t(np.asarray(x, np.int32))

    args = (t(q, dtype), t(k, dtype), t(v, dtype), t(tbl), t(cu),
            i32(seqlens), int(qlens.max()), max_k, D ** -0.5,
            masklib.MaskParams(has_alibi=alibi, **mkw))
    kw = dict(alibi_slopes=t(slopes) if alibi else None,
              seqused_k=i32(seqused),
              leftpad_k=None if VARLEN_CASES[name][2] is None else i32(lp))
    return args, kw


@pytest.mark.parametrize("name", list(VARLEN_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_varlen_kernel_matches_plain(cuda, dt, D, name):
    args, kw = _varlen_inputs(name, DTYPES[dt], D, cuda)
    before = vl.flash_attn_varlen_fwd_paged.launches
    out, lse = vl.flash_attn_varlen_fwd_paged(*args, **kw)
    torch.cuda.synchronize()
    assert vl.flash_attn_varlen_fwd_paged.launches == before + 1
    o32, lse32 = vl.flash_attn_varlen_fwd_paged_ref(*args, **kw)
    onat, lsenat = vl.flash_attn_varlen_fwd_paged_ref(*args, upcast=False,
                                                      **kw)
    assert_fwd_close(out, o32, onat, name=f"K8 {name} out")
    _gate_lse(lse, lse32, lsenat, f"K8 {name} lse")


def test_kernels_reject_fp32_and_bad_shapes(cuda):
    args, kw = _decode_inputs("t1", torch.float32, 64, cuda)
    with pytest.raises(TypeError):
        dec.paged_decode_attention(*args, **kw)
    args, kw = _decode_inputs("t1", torch.bfloat16, 48, cuda)
    with pytest.raises(ValueError):
        dec.paged_decode_attention(*args, **kw)
    args, kw = _varlen_inputs("causal_prefix", torch.float32, 64, cuda)
    with pytest.raises(TypeError):
        vl.flash_attn_varlen_fwd_paged(*args, **kw)


# ------------------------------------------------- flash_attn_with_kvcache

def _plain(upcast):
    def decode(*a, **k):
        return dec.paged_decode_attention_ref(*a, upcast=upcast, **k)

    def varlen(*a, **k):
        return vl.flash_attn_varlen_fwd_paged_ref(*a, upcast=upcast, **k)
    return decode, varlen


# name: (paged, layout, T_new, append, rotary, dtype, extra kwargs)
KVCACHE_CASES = {
    "paged_nhd_decode_append_rotary": (True, "NHD", 1, True, "half", "bf16",
                                       {}),
    "paged_hnd_varlen_route_append_rotary": (True, "HND", 256, True,
                                             "interleaved", "bf16", {}),
    "paged_hnd_varlen_route_append": (True, "HND", 256, True, None, "fp16",
                                      dict(window_size=(100, -1))),
    "contig_hnd_append_leftpad_window": (
        False, "HND", 3, True, None, "fp16",
        dict(cache_leftpad=[4, 0, 9], window_size=(10, -1))),
    "contig_nhd_batch_idx_softcap_alibi": (
        False, "NHD", 2, True, "interleaved", "bf16",
        dict(cache_batch_idx=[2, 0, 1], softcap=8.0, alibi=True)),
    "paged_hnd_no_append_lse_splits2": (True, "HND", 1, False, None, "bf16",
                                        dict(num_splits=2)),
}


def _kvcache_inputs(name):
    paged, layout, T, append, rotary, dt, extra = KVCACHE_CASES[name]
    rng = np.random.default_rng(21)
    Hq, Hk, D = 8, 2, 64
    varlen = T * (Hq // Hk) >= kv.VARLEN_PREFILL_MIN_ROWS
    B, ps = (2, 128) if varlen else (3, 16)
    kw = dict(causal=True, kv_cache_layout=layout, return_softmax_lse=True)
    if paged:
        P, mp = 10, 4 if varlen else 8
        shape = (P, ps, Hk, D) if layout == "NHD" else (Hk, P, ps, D)
        kw["block_table"] = np.stack(
            [rng.permutation(np.arange(1, P))[:mp] for _ in range(B)]
        ).astype(np.int32)
        cap = mp * ps
    else:
        N = 64
        shape = (B, N, Hk, D) if layout == "NHD" else (B, Hk, N, D)
        cap = N - 12
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    kc, vc = mk(*shape), mk(*shape)
    cs = rng.integers(5, cap - T, size=B).astype(np.int32)
    q = mk(B, T, Hq, D)
    new = (mk(B, T, Hk, D), mk(B, T, Hk, D)) if append else (None, None)
    if rotary:
        ang = rng.uniform(0, 2 * np.pi, (cap + T, D // 2))
        kw.update(rotary_cos=np.cos(ang).astype(np.float32),
                  rotary_sin=np.sin(ang).astype(np.float32),
                  rotary_interleaved=rotary == "interleaved")
    extra = dict(extra)
    if extra.pop("alibi", False):
        kw["alibi_slopes"] = rng.uniform(0.01, 0.2, (B, Hq)).astype(np.float32)
    for key in ("cache_leftpad", "cache_batch_idx"):
        if key in extra:
            extra[key] = np.asarray(extra[key], np.int32)
    kw.update(extra)
    return DTYPES[dt], q, kc, vc, new, cs, kw, varlen


def _kvcache_call(dev, dtype, q, kc, vc, new, cs, kw):
    def t(x, dt=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)

    caches = (t(kc, dtype), t(vc, dtype))
    tkw = {k: (t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    res = kv.flash_attn_with_kvcache(
        t(q, dtype), *caches, k=None if new[0] is None else t(new[0], dtype),
        v=None if new[1] is None else t(new[1], dtype),
        cache_seqlens=t(cs), **tkw)
    return res, caches


@pytest.mark.parametrize("name", list(KVCACHE_CASES))
def test_kvcache_kernels_match_plain(cuda, name, monkeypatch):
    dtype, q, kc, vc, new, cs, kw, varlen = _kvcache_inputs(name)
    counter = (vl.flash_attn_varlen_fwd_paged if varlen
               else dec.paged_decode_attention)
    before = counter.launches
    res, caches = _kvcache_call(cuda, dtype, q, kc, vc, new, cs, kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1, "the call took the wrong route"
    plain = {}
    for upcast in (True, False):
        with monkeypatch.context() as m:
            fd, fv = _plain(upcast)
            m.setattr(kv, "paged_decode_attention", fd)
            m.setattr(kv, "flash_attn_varlen_fwd_paged", fv)
            plain[upcast] = _kvcache_call(cuda, dtype, q, kc, vc, new, cs,
                                          kw)[0]
    assert len(res) == (3 if new[0] is not None else 2)
    assert_fwd_close(res[0], plain[True][0], plain[False][0],
                     name=f"{name} out")
    _gate_lse(res[1], plain[True][1], plain[False][1], f"{name} lse")
    if new[0] is not None:
        assert res[2][0] is caches[0] and res[2][1] is caches[1]
        if "rotary_cos" not in kw:
            # the append is a copy: bit-equal to the CPU append
            cpu_res, _ = _kvcache_call(torch.device("cpu"), dtype, q, kc, vc,
                                       new, cs, kw)
            assert torch.equal(res[2][0].cpu(), cpu_res[2][0])
            assert torch.equal(res[2][1].cpu(), cpu_res[2][1])


# ------------------------------------------------------- model and engine

def _tiny(dtype):
    # group 8 at head_dim 64, as TinyLlama; a 128-token prefill folds to
    # 1024 q rows and takes the K8 route
    return ModelConfig.tiny(vocab_size=512, dim=256, n_layers=2, n_heads=16,
                            n_kv_heads=2, head_dim=64, ffn_dim=512,
                            max_seq_len=512, dtype=dtype)


def test_decode_step_contiguous_matches_plain(cuda, monkeypatch):
    cfg = _tiny(torch.bfloat16)
    params = tmodel.init_params(cfg, seed=3, device=cuda)
    rng = np.random.default_rng(3)
    steps = [rng.integers(0, cfg.vocab_size, (2, 5)),
             rng.integers(0, cfg.vocab_size, (2, 1))]

    def run():
        caches = tmodel.init_kv_caches(cfg, 2, 64, device=cuda)
        cs = torch.zeros(2, dtype=torch.int32, device=cuda)
        outs = []
        for toks in steps:
            logits, caches = tmodel.decode_step(
                params, caches, torch.from_numpy(toks).to(cuda), cs, cfg)
            outs.append(logits)
            cs = cs + toks.shape[1]
        return outs

    before = dec.paged_decode_attention.launches
    got = run()
    assert dec.paged_decode_attention.launches - before == 2 * cfg.n_layers
    plain = {}
    for upcast in (True, False):
        with monkeypatch.context() as m:
            m.setattr(kv, "paged_decode_attention", _plain(upcast)[0])
            plain[upcast] = run()
    for i, logits in enumerate(got):
        assert_close_rel(logits, plain[True][i], plain[False][i], 2.0, 1e-5,
                         name=f"decode_step {i} logits")


def test_engine_fp16_runs_both_kernels(cuda):
    cfg = _tiny(torch.float16)
    params = tmodel.init_params(cfg, seed=4, device=cuda, lm_head=True)
    eng = ServingEngine(params, cfg, max_batch=4, num_pages=16,
                        page_size=128, device=cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (128, 100, 9)]
    calls0 = dict(eng_mod.paged_forward.calls)
    launches0 = (dec.paged_decode_attention.launches,
                 vl.flash_attn_varlen_fwd_paged.launches)
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    out = eng.run_to_completion()
    calls = {r: eng_mod.paged_forward.calls[r] - calls0[r]
             for r in ("decode", "varlen")}
    launches = {"decode": dec.paged_decode_attention.launches - launches0[0],
                "varlen": vl.flash_attn_varlen_fwd_paged.launches
                - launches0[1]}
    assert sorted(out) == sorted(rids)
    for rid in rids:
        assert len(out[rid]) == 6
        assert all(0 <= tok < cfg.vocab_size for tok in out[rid])
    for route in ("decode", "varlen"):
        assert calls[route] > 0
        assert launches[route] == cfg.n_layers * calls[route]
