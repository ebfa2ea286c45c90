"""Head dim 256 through the port's public functions against the JAX
package's (Pallas interpret mode), fp32, same numpy inputs: the plain
versions of K1-K3 (flash_attn_func), K5-K7 (flash_attn_varlen_func), K8
(flash_attn_with_kvcache's paged prefill route) and the model's loss and
gradients.  These twins are what the card's tests hold the head-dim-256
wgmma kernels (csrc/fwd_body.cuh, csrc/bwd.cu dkv_split_kernel) against.

Tolerances (tests/torch_dense_cases.py, torch_varlen_cases.py): out and
LSE 1e-5, gradients 1e-4; the model's loss 1e-5 and gradients 1e-4
(tests/test_torch_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dense_cases as dc
import torch_varlen_cases as vc
from flash_attn_v100_tpu import flash_attn_with_kvcache as jax_kvcache
from flash_attn_v100_tpu.models import transformer as jt
from flash_attn_v100_tpu_torch import flash_attn_with_kvcache as torch_kvcache
from flash_attn_v100_tpu_torch.models import transformer as tt
from flash_attn_v100_tpu_torch.ops import kvcache as tkv
from flash_attn_v100_tpu_torch.ops.cuda import varlen as tvl

torch.set_num_threads(1)

D = 256

# name: (B, Hq, Hk, M, N, D, kwargs)
DENSE = {
    "causal_gqa_m_lt_n": (1, 4, 1, 128, 192, D, dict(causal=True)),
    "window_softcap": (1, 2, 1, 128, 128, D,
                       dict(window_size=(31, 16), softcap=30.0)),
}


@pytest.mark.parametrize("name", list(DENSE))
def test_flash_attn_func_head_dim_256_matches_jax(name):
    dc.check_flash_attn_func(*DENSE[name])


def test_flash_attn_varlen_func_head_dim_256_matches_jax():
    vc.check_varlen([70, 30], [70, 30], dict(causal=True), hq=2, hk=1,
                    d=D)


def test_kvcache_paged_k8_route_head_dim_256_matches_jax(monkeypatch):
    """A paged HND cache with 128-token pages, 16 new tokens appended for
    each of 2 sequences at group 4: the route threshold lowered to 8 rows
    sends the port through K8's plain version (counted), JAX through its
    own route; out and LSE within 1e-5, the appended pages bit-equal."""
    hits = []
    orig = tvl.flash_attn_varlen_fwd_paged_ref
    monkeypatch.setattr(tvl, "flash_attn_varlen_fwd_paged_ref",
                        lambda *a, **k: hits.append(1) or orig(*a, **k))
    monkeypatch.setattr(tkv, "VARLEN_PREFILL_MIN_ROWS", 8)
    rng = np.random.default_rng(256)
    B, T, Hq, Hk, ps, P, mp = 2, 16, 4, 1, 128, 5, 2
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


def _leaves_j(tree):
    return [np.asarray(x) for x in (tree["embed"], tree["ln_f"])] + [
        np.asarray(lp[k]) for lp in tree["layers"] for k in sorted(lp)]


def test_tiny_model_head_dim_256_loss_and_grads_match_jax():
    """ModelConfig.tiny(head_dim=256, n_heads=2, n_kv_heads=1): JAX's
    weights carried across by params_from_jax, the same tokens; loss 1e-5,
    every gradient 1e-4."""
    shape = dict(head_dim=D, n_heads=2, n_kv_heads=1)
    cfg_j, cfg_t = jt.ModelConfig.tiny(**shape), tt.ModelConfig.tiny(**shape)
    params_j = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    tokens = np.random.default_rng(3).integers(
        0, cfg_j.vocab_size, (2, 33)).astype(np.int32)
    loss_j, g_j = jax.value_and_grad(jt.loss_fn)(
        params_j, jnp.asarray(tokens), cfg_j, interpret=True)
    params_t = tt.params_from_jax(jax.device_get(params_j), device="cpu",
                                  requires_grad=True)
    loss_t = tt.loss_fn(params_t, torch.from_numpy(tokens), cfg_t)
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5
    assert params_t["layers"][0]["wq"].shape == (cfg_t.dim, 2 * D)
    for p, gj in zip(tt.param_leaves(params_t), _leaves_j(g_j)):
        np.testing.assert_allclose(p.grad.numpy(), gj, rtol=0, atol=1e-4)
