"""Head dim 32 (and 16, which the forward kernel reads at 32 without
padded copies) through the port's public functions against the JAX
package's (Pallas interpret mode), fp32, same numpy inputs: the plain
versions of K1-K3 (flash_attn_func), K5-K7 (flash_attn_varlen_func,
non-causal at the small encoders' 12/12 heads) and K8
(flash_attn_with_kvcache's paged prefill route); the model's loss and
gradients are in test_torch_head_dim_32_model.py.  These twins are
what the card's tests hold the head-dim-32 wgmma kernels
(csrc/fwd_body.cuh, csrc/bwd.cu dkv_kernel on 64-byte-swizzled tiles)
against.

Tolerances (tests/torch_dense_cases.py, torch_varlen_cases.py): out and
LSE 1e-5, gradients 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dense_cases as dc
import torch_varlen_cases as vc
from flash_attn_v100_tpu import flash_attn_with_kvcache as jax_kvcache
from flash_attn_v100_tpu_torch import flash_attn_with_kvcache as torch_kvcache
from flash_attn_v100_tpu_torch.ops import kvcache as tkv
from flash_attn_v100_tpu_torch.ops.cuda import varlen as tvl

torch.set_num_threads(1)

# name: (B, Hq, Hk, M, N, D, kwargs)
DENSE = {
    "causal_gqa_m_lt_n_d32": (1, 4, 1, 128, 192, 32, dict(causal=True)),
    "causal_gqa_m_lt_n_d16": (1, 4, 1, 128, 192, 16, dict(causal=True)),
    "window_softcap_d32": (1, 2, 1, 128, 128, 32,
                           dict(window_size=(31, 16), softcap=30.0)),
}


@pytest.mark.parametrize("name", list(DENSE))
def test_flash_attn_func_head_dim_32_matches_jax(name):
    dc.check_flash_attn_func(*DENSE[name])


def test_flash_attn_varlen_func_head_dim_32_non_causal_matches_jax():
    """The encoders' pattern: non-causal self-attention over packed
    sequences at 12 q and 12 kv heads."""
    vc.check_varlen([70, 30, 45], [70, 30, 45], {}, hq=12, hk=12, d=32)


def test_kvcache_paged_k8_route_head_dim_32_matches_jax(monkeypatch):
    """A paged HND cache with 128-token pages, 16 new tokens appended for
    each of 2 sequences at group 4: the route threshold lowered to 8 rows
    sends the port through K8's plain version (counted), JAX through its
    own route; out and LSE within 1e-5, the appended pages bit-equal."""
    hits = []
    orig = tvl.flash_attn_varlen_fwd_paged_ref
    monkeypatch.setattr(tvl, "flash_attn_varlen_fwd_paged_ref",
                        lambda *a, **k: hits.append(1) or orig(*a, **k))
    monkeypatch.setattr(tkv, "VARLEN_PREFILL_MIN_ROWS", 8)
    rng = np.random.default_rng(32)
    B, T, Hq, Hk, ps, P, mp, D = 2, 16, 4, 1, 128, 5, 2, 32
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    kc, vc_ = mk(Hk, P, ps, D), mk(Hk, P, ps, D)
    table = np.stack([rng.permutation(np.arange(1, P))[:mp]
                      for _ in range(B)]).astype(np.int32)
    cs = np.asarray([37, 201], np.int32)
    q, kn, vn = mk(B, T, Hq, D), mk(B, T, Hk, D), mk(B, T, Hk, D)
    kw = dict(causal=True, kv_cache_layout="HND", return_softmax_lse=True)
    jres = jax_kvcache(*(jnp.asarray(x) for x in (q, kc, vc_)),
                       k=jnp.asarray(kn), v=jnp.asarray(vn),
                       cache_seqlens=jnp.asarray(cs),
                       block_table=jnp.asarray(table), **kw)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc_.copy())
    tres = torch_kvcache(torch.from_numpy(q), tk, tv, k=torch.from_numpy(kn),
                         v=torch.from_numpy(vn),
                         cache_seqlens=torch.from_numpy(cs),
                         block_table=torch.from_numpy(table), **kw)
    assert hits, "the paged prefill must take the K8 route"
    for got, want, what in zip(tres[:2], jres[:2], ("out", "lse")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=vc.OUT_ATOL, err_msg=what)
    (k2, v2), (jk2, jv2) = tres[2], jres[2]
    assert np.array_equal(k2.numpy(), np.asarray(jk2))
    assert np.array_equal(v2.numpy(), np.asarray(jv2))

