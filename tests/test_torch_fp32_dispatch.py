"""fp32 through the port's entry points, on the CPU: fp32 CPU tensors reach
the kernels' plain versions through flash_attn_func, flash_attn_varlen_func
(packed K/V and the block-table route), flash_attn_with_kvcache (the
decode and the paged-prefill routes), paged_forward and the serving
engine, and no kernel launch is counted; fp32 q over int8 / fp8 / int4
pools reaches K4q's and K8q's plain twins with fp32 outputs; fp64 (also
over quantized pools) and mixed dtypes raise TypeError before any launch
(inputs on the meta device, which takes the wrappers' kernel path without
a card); each forward wrapper (K1, K5, K8, K4) calls the fp32 body's entry
point for fp32 inputs and the 16-bit library's for bf16, and the K4q / K8q
wrappers their quant library's entry with dtype code 2 for fp32 q, with as
many arguments as the entry's ctypes signature (a stand-in library
records the call); and the zero padding that takes a head dim the kernels
do not take (16) to theirs keeps every pool payload's values.  The
fp32 numbers against the JAX package are the other test_torch_* files'
(ModelConfig.tiny is fp32)."""

import types

import numpy as np
import pytest
import torch

from flash_attn_v100_tpu_torch import ModelConfig, ServingEngine
from flash_attn_v100_tpu_torch.models import transformer as tt
from flash_attn_v100_tpu_torch.ops import kvcache as kv
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops import quant
from flash_attn_v100_tpu_torch.ops.cuda import build
from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.ops.reference import mha_reference
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func
from flash_attn_v100_tpu_torch.runtime.engine import paged_forward

torch.set_num_threads(1)

TWINS = {"K1": dfwd.flash_attn_dense_fwd_ref,
         "K2/K3": dbwd.flash_attn_dense_bwd_ref,
         "K4": dec.paged_decode_attention_ref,
         "K5": vl.flash_attn_varlen_fwd_ref,
         "K6/K7": vl.flash_attn_varlen_bwd_ref,
         "K8": vl.flash_attn_varlen_fwd_paged_ref}


def _launches():
    return (dfwd.flash_attn_dense_fwd.launches, dbwd.dq_kernel.launches,
            dbwd.dkv_kernel.launches, dec.paged_decode_attention.launches,
            vl.flash_attn_varlen_fwd.launches, vl.varlen_dq_kernel.launches,
            vl.varlen_dkv_kernel.launches,
            vl.flash_attn_varlen_fwd_paged.launches)


class _Counts:
    """The plain versions' calls and the kernels' launches around a
    block."""

    def __enter__(self):
        self.calls = {k: f.calls for k, f in TWINS.items()}
        self.launches = _launches()
        return self

    def __exit__(self, *exc):
        self.delta = {k: f.calls - self.calls[k] for k, f in TWINS.items()}
        assert _launches() == self.launches


def _rand(rng, *shape, dtype=torch.float32, dev="cpu"):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype)


# --------------------------------------------------- CPU: the plain versions

def test_flash_attn_func_fp32_takes_the_plain_versions():
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, *s).requires_grad_() for s in
               ((2, 40, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32)))
    with _Counts() as c:
        out = flash_attn_func(q, k, v, causal=True)
        out.sum().backward()
    assert c.delta["K1"] == 1 and c.delta["K2/K3"] == 1
    assert out.dtype == torch.float32 and q.grad.dtype == torch.float32
    ref = mha_reference(q.detach(), k.detach(), v.detach(), causal=True)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)


def _packed(rng, lens, Hq=4, Hk=2, D=32):
    T = sum(lens)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      dtype=torch.int32)
    return (_rand(rng, T, Hq, D), _rand(rng, T, Hk, D), _rand(rng, T, Hk, D),
            cu)


def test_varlen_func_fp32_packed_route():
    q, k, v, cu = _packed(np.random.default_rng(1), [17, 40, 3])
    q.requires_grad_()
    with _Counts() as c:
        out = flash_attn_varlen_func(q, k, v, cu, cu, 40, 40, causal=True)
        out.sum().backward()
    assert c.delta["K5"] == 1 and c.delta["K6/K7"] == 1
    assert out.dtype == q.grad.dtype == torch.float32


def test_varlen_func_fp32_block_table_route():
    rng = np.random.default_rng(2)
    q = _rand(rng, 20, 4, 32)
    k_pool, v_pool = _rand(rng, 5, 128, 2, 32), _rand(rng, 5, 128, 2, 32)
    cu_q = torch.tensor([0, 12, 20], dtype=torch.int32)
    cu_k = torch.tensor([0, 140, 150], dtype=torch.int32)
    tbl = torch.tensor([[3, 1], [0, 4]], dtype=torch.int32)
    with _Counts() as c:
        out = flash_attn_varlen_func(q, k_pool, v_pool, cu_q, cu_k, 12, 140,
                                     causal=True, block_table=tbl)
    assert c.delta["K8"] == 1 and out.dtype == torch.float32
    assert torch.isfinite(out).all()


def _kvcache(rng, T_new, page_size=128, pages=3):
    B, Hq, Hk, D = 2, 4, 2, 32
    q = _rand(rng, B, T_new, Hq, D)
    kc = _rand(rng, B * pages, page_size, Hk, D)
    vc = _rand(rng, B * pages, page_size, Hk, D)
    new = _rand(rng, B, T_new, Hk, D), _rand(rng, B, T_new, Hk, D)
    tbl = torch.arange(B * pages, dtype=torch.int32).view(B, pages)
    lens = torch.tensor([50, 200], dtype=torch.int32)
    return q, kc, vc, new, tbl, lens


def test_kvcache_fp32_decode_route():
    q, kc, vc, (kn, vn), tbl, lens = _kvcache(np.random.default_rng(3), 1)
    with _Counts() as c:
        out = kv.flash_attn_with_kvcache(q, kc, vc, kn, vn,
                                         cache_seqlens=lens, block_table=tbl,
                                         causal=True)[0]
    assert c.delta["K4"] == 1 and c.delta["K8"] == 0
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_kvcache_fp32_paged_prefill_route(monkeypatch):
    monkeypatch.setattr(kv, "VARLEN_PREFILL_MIN_ROWS", 16)
    q, kc, vc, (kn, vn), tbl, lens = _kvcache(np.random.default_rng(4), 9)
    with _Counts() as c:
        out = kv.flash_attn_with_kvcache(q, kc, vc, kn, vn,
                                         cache_seqlens=lens, block_table=tbl,
                                         causal=True)[0]
    assert c.delta["K8"] == 1 and c.delta["K4"] == 0
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def _tiny():
    cfg = ModelConfig.tiny(n_layers=2)
    return cfg, tt.init_params(cfg, seed=0, device="cpu")


def test_paged_forward_fp32_takes_the_plain_versions():
    cfg, params = _tiny()
    assert cfg.dtype == torch.float32
    Hk, D, ps = cfg.n_kv_heads, cfg.head_dim, 16
    k_pool = torch.zeros((Hk, cfg.n_layers * 8, ps, D))
    v_pool = torch.zeros_like(k_pool)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int64))
    tbl = torch.arange(8, dtype=torch.int32).view(2, 4)
    lens = torch.zeros(2, dtype=torch.int32)
    with _Counts() as c:
        logits = paged_forward(params, k_pool, v_pool, toks, lens, tbl,
                               cfg)[0]
    assert sum(c.delta.values()) == cfg.n_layers
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_engine_fp32_serves_through_the_plain_versions():
    cfg, params = _tiny()
    eng = ServingEngine(params, cfg, max_batch=2, num_pages=16,
                        page_size=16, device="cpu", use_native=False)
    rng = np.random.default_rng(6)
    with _Counts() as c:
        for n in (12, 30):
            eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                       max_new_tokens=4)
        done = eng.run_to_completion()
    assert c.delta["K4"] > 0 and c.delta["K1"] == 0
    assert sorted(len(r) for r in done.values()) == [4, 4]


# ----------------------------------------- the kernel path: what raises

META = torch.device("meta")


def _dense_meta(dtype, kdtype=None):
    q = torch.empty((1, 64, 4, 64), device=META, dtype=dtype)
    k = torch.empty((1, 64, 2, 64), device=META, dtype=kdtype or dtype)
    return q, k, k.clone()


def _packed_meta(dtype, kdtype=None):
    q = torch.empty((64, 4, 64), device=META, dtype=dtype)
    k = torch.empty((64, 2, 64), device=META, dtype=kdtype or dtype)
    cu = torch.tensor([0, 64], dtype=torch.int32, device=META)
    return q, k, k.clone(), cu


def _paged_meta(dtype, kdtype=None):
    q = torch.empty((64, 4, 64), device=META, dtype=dtype)
    pool = torch.empty((2, 2, 128, 64), device=META, dtype=kdtype or dtype)
    tbl = torch.zeros((1, 2), dtype=torch.int32, device=META)
    cu = torch.tensor([0, 64], dtype=torch.int32, device=META)
    return q, pool, pool.clone(), tbl, cu


def _decode_meta(dtype, kdtype=None):
    q = torch.empty((1, 2, 8, 64), device=META, dtype=dtype)
    pool = torch.empty((1, 2, 4, 32, 64), device=META, dtype=kdtype or dtype)
    tbl = torch.zeros((1, 4), dtype=torch.int32, device=META)
    lens = torch.tensor([60], dtype=torch.int32, device=META)
    return q, pool, pool.clone(), tbl, lens


PARAMS = masklib.MaskParams(causal=True)


def _call(entry, dtype, kdtype=None):
    if entry == "K1":
        q, k, v = _dense_meta(dtype, kdtype)
        return dfwd.flash_attn_dense_fwd(q, k, v, 0.125, PARAMS)
    if entry == "K2/K3":
        q, k, v = _dense_meta(dtype, kdtype)
        lse = torch.empty((1, 4, 64), device=META)
        return dbwd.flash_attn_dense_bwd(q, k, v, q, q, lse, 0.125, PARAMS)
    if entry == "K5":
        q, k, v, cu = _packed_meta(dtype, kdtype)
        return vl.flash_attn_varlen_fwd(q, k, v, cu, cu, 64, 64, 0.125,
                                        PARAMS)
    if entry == "K6/K7":
        q, k, v, cu = _packed_meta(dtype, kdtype)
        lse = torch.empty((4, 64), device=META)
        return vl.flash_attn_varlen_bwd(q, k, v, q, q, lse, cu, cu, 64, 64,
                                        0.125, PARAMS)
    if entry == "K8":
        q, kp, vp, tbl, cu = _paged_meta(dtype, kdtype)
        lens = torch.tensor([256], dtype=torch.int32, device=META)
        return vl.flash_attn_varlen_fwd_paged(q, kp, vp, tbl, cu, lens, 64,
                                              256, 0.125, PARAMS)
    q, kp, vp, tbl, lens = _decode_meta(dtype, kdtype)
    return dec.paged_decode_attention(q, kp, vp, tbl, lens, None,
                                      softmax_scale=0.125, params=PARAMS,
                                      t_new=1, group=4)


ENTRIES = ["K1", "K2/K3", "K4", "K5", "K6/K7", "K8"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_fp64_raises(entry):
    with pytest.raises(TypeError):
        _call(entry, torch.float64)


@pytest.mark.parametrize("entry", ENTRIES)
def test_mixed_dtypes_raise(entry):
    with pytest.raises(TypeError):
        _call(entry, torch.float32, torch.bfloat16)


# ------------------------------------ fp32 q over quantized pools (K4q, K8q)

QUANT_KINDS = ("int8", "fp8", "int4")
QUANT_ENTRIES = {"K4q": ("decode_quant", "fa_decode_quant_launch"),
                 "K8q": ("varlen_paged_quant", "fa_varlen_paged_quant_launch")}


def _quant_pool(kind, shape, device):
    """A payload pool of `kind` for the 16-bit-shaped `shape` (tokens on
    axis -2) and its (..., page_size, 1) fp32 scales: quantized from
    seeded values on the CPU, or empty on the meta device."""
    if device == META:
        rows = shape[-2] // 2 if kind == "int4" else shape[-2]
        dt = torch.float8_e4m3fn if kind == "fp8" else torch.int8
        pool = torch.empty((*shape[:-2], rows, shape[-1]), device=META,
                           dtype=dt)
        return pool, torch.empty((*shape[:-1], 1), device=META)
    x = torch.from_numpy(np.random.default_rng(len(kind)).standard_normal(
        shape).astype(np.float32))
    return quant.quantize_kv(x, {"int8": torch.int8, "int4": "int4",
                                 "fp8": torch.float8_e4m3fn}[kind])


def _quant_call(entry, kind, dtype, device):
    """K4q (paged_decode_attention) or K8q (flash_attn_varlen_fwd_paged) on
    q of `dtype` over `kind` pools on `device`."""
    rng = np.random.default_rng(7)
    if entry == "K4q":
        q = torch.from_numpy(rng.standard_normal((1, 2, 8, 64))).to(
            device=device, dtype=dtype)
        (kp, ks), (vp, vs) = (_quant_pool(kind, (1, 2, 4, 32, 64), device)
                              for _ in range(2))
        tbl = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32, device=device)
        lens = torch.tensor([100], dtype=torch.int32, device=device)
        return dec.paged_decode_attention(
            q, kp, vp, tbl, lens, None, softmax_scale=0.125, params=PARAMS,
            t_new=1, group=4, k_scales=ks, v_scales=vs, int4=kind == "int4")
    q = torch.from_numpy(rng.standard_normal((64, 4, 64))).to(
        device=device, dtype=dtype)
    (kp, ks), (vp, vs) = (_quant_pool(kind, (2, 2, 128, 64), device)
                          for _ in range(2))
    tbl = torch.tensor([[1, 0]], dtype=torch.int32, device=device)
    cu = torch.tensor([0, 64], dtype=torch.int32, device=device)
    lens = torch.tensor([200], dtype=torch.int32, device=device)
    return vl.flash_attn_varlen_fwd_paged(q, kp, vp, tbl, cu, lens, 64, 256,
                                          0.125, PARAMS, k_scales=ks,
                                          v_scales=vs)


def _quant_launches():
    return (sum(dec.paged_decode_attention.quant_launches.values()),
            sum(vl.flash_attn_varlen_fwd_paged.quant_launches.values()))


@pytest.mark.parametrize("kind", QUANT_KINDS)
@pytest.mark.parametrize("entry", list(QUANT_ENTRIES))
def test_fp32_q_over_quantized_pools_reaches_the_twins(entry, kind):
    """fp32 CPU q over an int8 / fp8 / int4 pool: the plain twin at the
    kernel's P grouping, fp32 out and LSE, finite, no launch counted."""
    twin = TWINS["K4" if entry == "K4q" else "K8"]
    calls, before = twin.calls, _quant_launches()
    out, lse = _quant_call(entry, kind, torch.float32, "cpu")
    assert twin.calls == calls + 1 and _quant_launches() == before
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert torch.isfinite(out).all() and out.abs().sum() > 0
    again = _quant_call(entry, kind, torch.float32, "cpu")
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("kind", QUANT_KINDS)
@pytest.mark.parametrize("entry", list(QUANT_ENTRIES))
def test_fp64_q_over_quantized_pools_raises(entry, kind):
    with pytest.raises(TypeError):
        _quant_call(entry, kind, torch.float64, META)


# ------------------------------- the kernel path: which entry is called

class _Library:
    """Stands in for a kernel library: records (library, entry, number of
    arguments) and returns cudaSuccess."""

    def __init__(self, name, log):
        self.name, self.log = name, log

    def __getattr__(self, fn):
        def call(*args):
            self.log.append((self.name, fn, len(args)))
            return 0
        return call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("entry,lib16,fn16,lib32,fn32", [
    ("K1", "fwd", "fa_fwd_launch", "fwd_f32", "fa_fwd_f32_launch"),
    ("K5", "fwd", "fa_varlen_fwd_launch", "fwd_f32",
     "fa_varlen_fwd_f32_launch"),
    ("K8", "varlen_paged", "fa_varlen_paged_launch", "fwd_f32",
     "fa_varlen_paged_f32_launch"),
    ("K4", "decode", "fa_decode_launch", "decode_f32",
     "fa_decode_f32_launch"),
])
def test_forward_wrappers_call_the_dtype_s_entry(monkeypatch, entry, lib16,
                                                 fn16, lib32, fn32, dtype):
    log = []
    monkeypatch.setattr(build, "load", lambda name: _Library(name, log))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    before = _launches()
    _call(entry, dtype)
    lib, fn = (lib32, fn32) if dtype == torch.float32 else (lib16, fn16)
    assert log == [(lib, fn, len(build.SIGNATURES[lib][fn][0]))]
    assert sum(_launches()) == sum(before) + 1


class _ArgsLibrary(_Library):
    """_Library that records the arguments themselves."""

    def __getattr__(self, fn):
        def call(*args):
            self.log.append((self.name, fn, args))
            return 0
        return call


@pytest.mark.parametrize("kind", QUANT_KINDS)
@pytest.mark.parametrize("entry", list(QUANT_ENTRIES))
def test_quant_wrappers_pass_dtype_code_2_for_fp32_q(monkeypatch, entry,
                                                     kind):
    """On the kernel path, fp32 q over a quantized pool calls the quant
    library's entry with dtype code 2 and as many arguments as codes 0
    (bf16) and 1 (fp16) give it and its ctypes signature says, and counts
    one launch of its kind."""
    log = []
    monkeypatch.setattr(build, "load", lambda name: _ArgsLibrary(name, log))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    lib, fn = QUANT_ENTRIES[entry]
    launches = (dec.paged_decode_attention if entry == "K4q"
                else vl.flash_attn_varlen_fwd_paged).quant_launches
    for dtype, code in ((torch.bfloat16, 0), (torch.float16, 1),
                        (torch.float32, 2)):
        before = launches[kind]
        log.clear()
        out, lse = _quant_call(entry, kind, dtype, META)
        assert launches[kind] == before + 1
        (name, called, args), = log
        assert (name, called) == (lib, fn)
        assert len(args) == len(build.SIGNATURES[lib][fn][0])
        assert args[:2] == (dec.KIND_CODE[kind], code)
        assert lse.dtype == torch.float32
        if entry == "K8q":   # (K4q's partials are fp32 for any q)
            assert out.dtype == dtype


@pytest.mark.parametrize("kind", [None] + list(QUANT_KINDS))
def test_pad_pool_head_dim_adds_zero_columns(kind):
    """flash_attn_with_kvcache pads a head dim the kernels do not take (16)
    to theirs on CUDA: the padded pool's payload reads as the original in
    the first columns and as zeros past them (int4: a byte of two zero
    nibbles), its scales untouched."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 3, 8, 16)).astype(np.float32))
    if kind is None:
        pool, scales = x, None
    else:
        pool, scales = _quant_pool(kind, x.shape, "cpu")
    padded = kv.pad_pool_head_dim(pool, 32, int4=kind == "int4")
    assert padded.shape == (*pool.shape[:-1], 32)
    assert padded.dtype == pool.dtype
    if kind is None:
        assert torch.equal(padded[..., :16], pool) and not padded[..., 16:].any()
        return
    deq = quant.dequantize_kv(padded, scales, torch.float32,
                              int4=kind == "int4")
    want = quant.dequantize_kv(pool, scales, torch.float32,
                               int4=kind == "int4")
    assert torch.equal(deq[..., :16], want)
    assert not deq[..., 16:].any()
    assert kv.pad_pool_head_dim(pool, 16) is pool
