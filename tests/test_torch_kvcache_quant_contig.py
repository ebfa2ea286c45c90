"""Port flash_attn_with_kvcache over quantized contiguous caches (int8, fp8 e4m3,
int4) against the JAX package's, NHD and HND layouts, without an append
and with a 2-token append at an even and at an odd offset; the checks and
tolerances are tests/torch_kvcache_quant_cases.py's.  Also the port's
int4 pair append against its read-modify-write and the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.ops import kvcache as jkv
from flash_attn_v100_tpu_torch.ops import kvcache as tkv

import torch_kvcache_quant_cases as qc


@pytest.mark.parametrize("append", [False, True])
@pytest.mark.parametrize("layout", ["NHD", "HND"])
@pytest.mark.parametrize("kind", list(qc.KINDS))
def test_kvcache_quant_contiguous_matches_jax(kind, layout, append, monkeypatch):
    qc.run_case(kind, "contiguous", layout, append, monkeypatch)


def test_int4_pair_append_matches_rmw():
    """The pair append and the read-modify-write give byte-identical pools
    for every start parity, including boundary tokens whose partner is an
    old token, and both equal the JAX package's (its
    test_int4_pair_append_matches_rmw inputs)."""
    rng = np.random.default_rng(59)
    B, T, Hk, D, ps, P = 3, 7, 2, 8, 8, 8
    pool0 = rng.integers(-128, 128, (Hk, P, ps // 2, D)).astype(np.int8)
    vals = rng.integers(-8, 8, (B, T, Hk, D)).astype(np.int8)
    pos = np.asarray([0, 3, 5])[:, None] + np.arange(T)[None]
    page_ids = (pos // ps + 2 * np.arange(B)[:, None]).astype(np.int32)
    off = (pos % ps).astype(np.int32)
    want = np.asarray(jkv._int4_append_paged(
        jnp.asarray(pool0), jnp.asarray(vals), jnp.asarray(page_ids),
        jnp.asarray(off)))
    for fn in (tkv._int4_rmw_paged, tkv._int4_append_paged):
        pool = torch.from_numpy(pool0.copy())
        fn(pool, torch.from_numpy(vals), torch.from_numpy(page_ids),
           torch.from_numpy(off))
        assert np.array_equal(pool.numpy(), want), fn.__name__
    # one token a row: the read-modify-write alone
    want1 = np.asarray(jkv._int4_rmw_paged(
        jnp.asarray(pool0), jnp.asarray(vals[:, :1]),
        jnp.asarray(page_ids[:, :1]), jnp.asarray(off[:, :1])))
    pool = torch.from_numpy(pool0.copy())
    tkv._int4_append_paged(pool, torch.from_numpy(vals[:, :1]),
                           torch.from_numpy(page_ids[:, :1]),
                           torch.from_numpy(off[:, :1]))
    assert np.array_equal(pool.numpy(), want1)

    poolc0 = rng.integers(-128, 128, (B, Hk, 16, D)).astype(np.int8)
    vc = np.ascontiguousarray(vals.transpose(0, 2, 1, 3))
    b_ix = np.arange(B, dtype=np.int32)
    want = np.asarray(jkv._int4_append_contig(
        jnp.asarray(poolc0), jnp.asarray(vc),
        jnp.asarray(b_ix)[:, None, None], jnp.asarray(pos, jnp.int32)))
    for fn in (tkv._int4_rmw_contig, tkv._int4_append_contig):
        pool = torch.from_numpy(poolc0.copy())
        fn(pool, torch.from_numpy(vc), torch.from_numpy(b_ix),
           torch.from_numpy(pos.astype(np.int32)))
        assert np.array_equal(pool.numpy(), want), fn.__name__
