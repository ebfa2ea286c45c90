"""Shared cases of tests/test_torch_kvcache_quant*.py: one
flash_attn_with_kvcache call over a quantized cache through the JAX
package and the port, fp32 q, on the decode route, P grouped as JAX groups
it (per page: the port's P_TILE set to None).  Outputs and LSE within 1e-5
(exact integer products on both sides), the updated payloads and scales
bit-equal (no rotary), the int4 partner nibble kept, and the JAX package's
oracle gates: 0.1 (int8, fp8) and 0.3 (int4) against fp32 attention on the
float caches."""

import jax.numpy as jnp
import numpy as np
import torch

from flash_attn_v100_tpu import flash_attn_with_kvcache as jax_kvcache
from flash_attn_v100_tpu.ops import quant as jq
from flash_attn_v100_tpu_torch import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops import quant as tq
from flash_attn_v100_tpu_torch.ops.cuda import decode as tdec
from flash_attn_v100_tpu_torch.ops.reference import mha_reference_kvcache

torch.set_num_threads(1)

ATOL = 1e-5
KINDS = {"int8": (torch.int8, jnp.int8),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
         "int4": ("int4", "int4")}
GATE = {"int8": 0.1, "fp8": 0.1, "int4": 0.3}


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return tq.payload_bytes(a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def run_case(kind, cache, layout, append, monkeypatch):
    """cache "paged" or "contiguous", layout "NHD" or "HND"; append: two
    new tokens per row, rows at an even and an odd offset."""
    monkeypatch.setattr(tdec, "P_TILE", None)
    rng = np.random.default_rng(53)
    B, T, Hq, Hk, D = 2, 2, 4, 2, 32
    tdt, jdt = KINDS[kind]
    if cache == "paged":
        ps, P, mp = 16, 9, 4
        shape = (P, ps, Hk, D)
        tbl = rng.permutation(np.arange(1, P))[:B * mp].reshape(
            B, mp).astype(np.int32)
        extra = dict(block_table=tbl)
    else:
        shape = (B, 64, Hk, D)
        extra = {}
    kf, vf = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if layout == "HND":             # (Hk, P, ps, D) / (B, Hk, N, D)
        perm = (2, 0, 1, 3) if cache == "paged" else (0, 2, 1, 3)
        kf, vf = (np.ascontiguousarray(x.transpose(perm)) for x in (kf, vf))
    tok_axis = 1 if layout == "NHD" else 2
    (jk, jks), (jv, jvs) = (jq.quantize_kv(jnp.asarray(x), jdt,
                                           token_axis=tok_axis)
                            for x in (kf, vf))
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    new = [rng.standard_normal((B, T, Hk, D)).astype(np.float32)
           for _ in range(2)] if append else [None, None]
    cs = np.asarray([30, 17], np.int32)     # appends at an even, an odd row
    kw = dict(causal=True, kv_cache_layout=layout, return_softmax_lse=True)

    jres = jax_kvcache(
        jnp.asarray(q), jk, jv,
        *[None if x is None else jnp.asarray(x) for x in new],
        cache_seqlens=jnp.asarray(cs), k_scales=jks, v_scales=jvs,
        **{k: jnp.asarray(v) for k, v in extra.items()}, **kw)
    tcaches = [tq.payload_from_numpy(np.asarray(a))
               for a in (jk, jv, jks, jvs)]
    before = [t.clone() for t in tcaches]
    tres = flash_attn_with_kvcache(
        torch.from_numpy(q), tcaches[0], tcaches[1],
        *[None if x is None else torch.from_numpy(x) for x in new],
        cache_seqlens=torch.from_numpy(cs), k_scales=tcaches[2],
        v_scales=tcaches[3],
        **{k: torch.from_numpy(v) for k, v in extra.items()}, **kw)
    assert len(tres) == len(jres)
    np.testing.assert_allclose(tres[0].numpy(), np.asarray(jres[0]),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tres[1].numpy(), np.asarray(jres[1]),
                               rtol=0, atol=ATOL)
    if append:
        assert all(a is b for a, b in zip(tres[2], tcaches)), "in place"
        for got, want in zip(tres[2], jres[2]):
            assert np.array_equal(_bytes(got), _bytes(want))
        if kind == "int4":
            # the partner of each appended token keeps its nibble
            ax = tok_axis if cache == "paged" else (1 if layout == "NHD"
                                                     else 2)
            old, upd = (tq.unpack_int4_tokens(x, axis=ax)
                        for x in (before[0], tcaches[0]))
            for b, t0 in enumerate(cs):
                for t in (t0 - 1, t0 + T):       # the byte partners
                    if cache == "paged":
                        sel = [slice(None)] * 4
                        sel[0 if layout == "HND" else 2] = slice(None)
                        page = tbl[b, t // ps]
                        idx = ((page, t % ps) if layout == "NHD"
                               else (slice(None), page, t % ps))
                    else:
                        idx = ((b, t) if layout == "NHD"
                               else (b, slice(None), t))
                    assert torch.equal(old[idx], upd[idx])
    # the oracle: fp32 attention on the float caches (and new tokens)
    if layout == "HND":
        inv = (1, 2, 0, 3) if cache == "paged" else (0, 2, 1, 3)
        kf, vf = (x.transpose(inv) for x in (kf, vf))
    if cache == "paged":
        kf, vf = (x[tbl].reshape(B, -1, Hk, D) for x in (kf, vf))
    ref = mha_reference_kvcache(
        torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(kf)),
        torch.from_numpy(np.ascontiguousarray(vf)),
        *[None if x is None else torch.from_numpy(x) for x in new],
        cache_seqlens=torch.from_numpy(cs), causal=True)[0]
    err = float((tres[0] - ref).abs().max())
    assert err <= GATE[kind], (kind, err)
