"""The port's serving path over quantized pools (int8, fp8 e4m3, int4) on
the tiny fp32 config: paged_forward logits against the JAX package's
(prefill + two decode steps, P grouped and the KV range split as JAX
groups and splits them); ServingEngine tokens against a direct
paged_forward loop in the port (the structure of the JAX package's
test_engine_int4_kv_pool); prefix-cache page copies carry the scales."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.runtime import engine as jengine
from flash_attn_v100_tpu_torch import ServingEngine as TorchEngine
from flash_attn_v100_tpu_torch.ops import quant as tq
from flash_attn_v100_tpu_torch.ops.cuda import decode as tdec
from flash_attn_v100_tpu_torch.ops.cuda import varlen as tvl
from flash_attn_v100_tpu_torch.runtime import engine as tengine

import torch_engine_scenarios as sc

torch.set_num_threads(1)

KINDS = {"int8": (torch.int8, jnp.int8),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
         "int4": ("int4", "int4")}
# logits: fp32 rounding of the scores, the softmax and the sums (~1e-6);
# the quantized roundings of q and P agree once both sides group P and
# split the KV range alike
LOGITS_ATOL = 1e-5
# the appended K/V come from projections that differ in the last fp32 bit
# between XLA and torch: a value on a rounding boundary lands one quantized
# step apart (one fp8 byte in 7168 here), and a scale (amax / qmax) an ulp or two
BYTE_SHARE = 1e-3
SCALE_RTOL = 1e-5


def _jax_num_splits(num_splits, B, Hk, Rq, max_pages, device):
    """The JAX decode kernel's split rule (one head block at these sizes).
    The split count is a tiling choice, but fp8's bf16 rounding of P reads
    the running max of its split, so both sides must split alike."""
    S = num_splits if num_splits > 0 else max(1, min(8 // max(B, 1),
                                                     max_pages))
    return min(S, max_pages)


def _pools(kind, Hk, P_f, ps, D):
    tdt, jdt = KINDS[kind]
    rows = ps // 2 if kind == "int4" else ps
    shape, sshape = (Hk, P_f, rows, D), (Hk, P_f, ps, 1)
    pdt = torch.int8 if kind == "int4" else tdt
    jpdt = jnp.int8 if kind == "int4" else jdt
    return ((jnp.zeros(shape, jpdt), jnp.zeros(shape, jpdt),
             jnp.ones(sshape), jnp.ones(sshape)),
            [torch.zeros(shape, dtype=pdt), torch.zeros(shape, dtype=pdt),
             torch.ones(sshape), torch.ones(sshape)])


@pytest.mark.parametrize("kind", list(KINDS))
def test_paged_forward_quant_logits_match_jax(kind, monkeypatch):
    monkeypatch.setattr(tdec, "P_TILE", None)
    monkeypatch.setattr(tvl, "P_TILE", None)
    monkeypatch.setattr(tdec, "resolve_num_splits", _jax_num_splits)
    (jcfg, jparams), (tcfg, tparams) = sc.make_models()
    L, Hk, D, ps, npg = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim, 8, 6
    rng = np.random.default_rng(61)
    tbl = np.asarray([[1, 2, 3, 0, 0, 0, 0, 0], [4, 5, 0, 0, 0, 0, 0, 0]],
                     np.int32)
    steps = [(rng.integers(0, 64, (2, 8)), np.asarray([0, 0], np.int32)),
             (rng.integers(0, 64, (2, 1)), np.asarray([8, 5], np.int32)),
             (rng.integers(0, 64, (2, 1)), np.asarray([9, 6], np.int32))]
    jpools, tpools = _pools(kind, Hk, (npg + 1) * L, ps, D)
    jfwd = jax.jit(jengine.paged_forward, static_argnames=("cfg",))
    for toks, cs in steps:
        jl, *jpools = jfwd(jparams, *jpools[:2], jnp.asarray(toks, jnp.int32),
                           jnp.asarray(cs), jnp.asarray(tbl), cfg=jcfg,
                           k_scales=jpools[2], v_scales=jpools[3])
        tl, *tout = tengine.paged_forward(
            tparams, *tpools[:2], torch.from_numpy(toks),
            torch.from_numpy(cs), torch.from_numpy(tbl), tcfg,
            k_scales=tpools[2], v_scales=tpools[3])
        assert all(a is b for a, b in zip(tout, tpools)), "in place"
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGITS_ATOL)
        for t, j in zip(tpools[:2], jpools[:2]):
            j = np.asarray(j)
            j = j.view(np.uint8) if j.dtype.name == "float8_e4m3fn" else j
            diff = tq.payload_bytes(t).numpy() != j
            assert diff.mean() <= BYTE_SHARE
        for t, j in zip(tpools[2:], jpools[2:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       rtol=SCALE_RTOL, atol=0)
    # the pools' unwritten rows stay as allocated: zeros and scales of one
    assert not tq.payload_bytes(tpools[0])[:, :L].any()
    assert (tpools[2][:, :L] == 1).all()


def _direct_generate(params, cfg, prompt, n_new, num_pages, page_size,
                     kind):
    """Greedy decode through paged_forward with the engine's shapes
    (max_batch 1, bucketed prefill, full block table)."""
    _, pools = _pools(kind, cfg.n_kv_heads, (num_pages + 1) * cfg.n_layers,
                      page_size, cfg.head_dim)
    mp = cfg.max_seq_len // page_size
    bt = torch.arange(1, mp + 1, dtype=torch.int32)[None]
    T = TorchEngine._bucket(len(prompt))
    toks = torch.zeros((1, T), dtype=torch.long)
    toks[0, :len(prompt)] = torch.tensor(prompt)
    kw = dict(k_scales=pools[2], v_scales=pools[3])
    logits = tengine.paged_forward(params, *pools[:2], toks,
                                   torch.zeros(1, dtype=torch.int32), bt, cfg,
                                   **kw)[0]
    out = [int(logits[0, len(prompt) - 1].argmax())]
    for i in range(n_new - 1):
        cs = torch.tensor([len(prompt) + i], dtype=torch.int32)
        logits = tengine.paged_forward(params, *pools[:2],
                                       torch.tensor([[out[-1]]]), cs, bt,
                                       cfg, **kw)[0]
        out.append(int(logits[0, 0].argmax()))
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_engine_quant_matches_direct_paged_forward(kind):
    """The engine's bookkeeping (pages, append positions, fused decode
    windows) reproduces a direct paged_forward loop exactly."""
    _, (cfg, params) = sc.make_models()
    for prompt in ([3, 1, 4, 1, 5, 9], [2, 7, 1]):
        ref = _direct_generate(params, cfg, prompt, 6, 16, 8, kind)
        eng = TorchEngine(params, cfg, max_batch=1, num_pages=16,
                          page_size=8, device="cpu",
                          kv_dtype=KINDS[kind][0])
        assert eng.quantized and eng.kv_int4 == (kind == "int4")
        assert eng.k_pool.shape[-2] == (4 if kind == "int4" else 8)
        rid = eng.submit(prompt, max_new_tokens=6)
        assert eng.run_to_completion()[rid] == ref


@pytest.mark.parametrize("kind", ["fp8", "int4"])
def test_engine_prefix_copy_carries_scales(kind):
    """A prefix-cache hit copies the source pages' payload AND scales (all
    layers) to the new sequence's pages; with its copied prefix the second
    request's tokens equal a run without the prefix cache."""
    _, (cfg, params) = sc.make_models()
    eng = TorchEngine(params, cfg, max_batch=2, num_pages=16, page_size=8,
                      device="cpu", kv_dtype=KINDS[kind][0])
    g = torch.Generator().manual_seed(3)
    for pool in (eng.k_pool, eng.v_pool):
        tq.payload_bytes(pool).copy_(torch.randint(
            0, 120, pool.shape, generator=g).to(torch.uint8))
    for sc_pool in (eng.k_scales, eng.v_scales):
        sc_pool.copy_(torch.rand(sc_pool.shape, generator=g))
    src, dst = torch.tensor([3, 5, 0, 0]), torch.tensor([7, 2, 0, 0])
    before = [t.clone() for t in (eng.k_pool, eng.v_pool, eng.k_scales,
                                  eng.v_scales)]
    eng._copy_pages(src, dst)
    L = cfg.n_layers
    for t, old in zip((eng.k_pool, eng.v_pool, eng.k_scales, eng.v_scales),
                      before):
        t, old = tq.payload_bytes(t), tq.payload_bytes(old)
        for s, d in ((3, 7), (5, 2)):
            assert torch.equal(t[:, d * L:(d + 1) * L],
                               old[:, s * L:(s + 1) * L])
        assert torch.equal(t[:, L:2 * L], old[:, L:2 * L])   # untouched

    prefix = sc.prng_prompt(16, 7)

    def script(e):
        a = e.submit(prefix + [5, 9], max_new_tokens=8)
        e.step()
        return {"a": a, "b": e.submit(prefix + [2], max_new_tokens=4)}

    kw = dict(max_batch=2, num_pages=16, page_size=8,
              kv_dtype=KINDS[kind][0])
    hit = sc.run(TorchEngine, params, cfg, script, **kw)
    miss = sc.run(TorchEngine, params, cfg, script, prefix_cache=False, **kw)
    assert hit[1]["prefix_hits"] == 1 and miss[1]["prefix_hits"] == 0
    assert hit[0] == miss[0]
