"""The port's LoRA fine-tuning (integrations/lora.py) on its own and against
the JAX package's, on ModelConfig.tiny() (fp32; one layer against JAX) with the same weights
(params_from_jax), the same adapters (lora_from_jax) and the same tokens;
the JAX side runs its Pallas kernels in interpret mode.

Tolerances (fp32): a fresh adapter's merge leaves the logits within 1e-6;
JAX's lora_loss 1e-5 and its adapter gradients 1e-4; losses over three
AdamW steps 1e-4, adapters within 3 x lr absolute (torch's AdamW and
optax.adamw are the same update in a different rounding order, and an
update is at most lr an element: a gradient near 0 can flip its sign)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.integrations import lora as jlora
from flash_attn_v100_tpu.models import transformer as jt
from flash_attn_v100_tpu_torch.integrations import lora as tlora
from flash_attn_v100_tpu_torch.models import transformer as tt

torch.set_num_threads(1)

LR = 2e-4
# the JAX comparisons' model: one layer keeps JAX's interpret-mode compile
# of the forward and backward short
CFG_T = tt.ModelConfig.tiny(n_layers=1)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_merge_of_a_fresh_adapter_is_the_identity():
    cfg = tt.ModelConfig.tiny()
    params = tt.init_params(cfg, seed=0, device="cpu")
    lcfg = tlora.LoraConfig(rank=4)
    lora = tlora.lora_init(params, lcfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, 32), 4))
    with torch.no_grad():
        base = tt.forward(params, toks, cfg)
        merged = tt.forward(tlora.merge(params, lora, lcfg), toks, cfg)
    np.testing.assert_allclose(merged.numpy(), base.numpy(), rtol=0,
                               atol=1e-6)


def test_training_reduces_the_loss():
    cfg = tt.ModelConfig.tiny(n_layers=2)
    params = tt.init_params(cfg, seed=0, device="cpu")
    lcfg = tlora.LoraConfig(rank=4, alpha=8.0)
    lora = tlora.lora_init(params, lcfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (4, 33), 5))
    step, init_opt = tlora.make_lora_train_step(cfg, lcfg)
    opt = init_opt(lora)
    before = [t.clone() for t in tt.param_leaves(params)]
    losses = []
    for _ in range(8):
        loss, lora, opt = step(lora, opt, params, toks)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.05, losses
    for a, b in zip(tt.param_leaves(params), before):
        assert torch.equal(a, b) and a.grad is None and not a.requires_grad


def test_only_b_has_a_gradient_at_the_first_step():
    """B = 0 at init, so dL/dA = (dL/dW) B^T scale is exactly 0."""
    cfg = tt.ModelConfig.tiny(n_layers=1)
    params = tt.init_params(cfg, seed=0, device="cpu")
    lcfg = tlora.LoraConfig(rank=2, targets=("wq", "wv"))
    lora = tlora.lora_init(params, lcfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 17), 6))
    leaves = tlora.lora_leaves(lora)
    grads = torch.autograd.grad(
        tlora.lora_loss(lora, params, toks, cfg, lcfg), leaves)
    names = [(n, k) for ad in lora["layers"] for n in sorted(ad)
             for k in ("a", "b")]
    assert len(grads) == 4
    for (name, k), g in zip(names, grads):
        if k == "a":
            assert torch.count_nonzero(g) == 0, name
        else:
            assert float(g.abs().max()) > 0, name


@pytest.fixture(scope="module")
def jax_setup():
    """Tiny JAX params, JAX-initialized adapters with B made nonzero (so
    that dL/dA is too) and the tokens."""
    cfg_j = jt.ModelConfig.tiny(n_layers=1)
    params_j = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    lcfg_j = jlora.LoraConfig(rank=4, alpha=8.0)
    lora_j = jlora.lora_init(jax.random.PRNGKey(1), params_j, lcfg_j)
    rng = np.random.default_rng(8)
    for ad in lora_j["layers"]:
        for w in ad.values():
            w["b"] = jnp.asarray(
                rng.standard_normal(w["b"].shape).astype(np.float32) * 0.05)
    return cfg_j, params_j, lcfg_j, lora_j, _tokens(cfg_j, (2, 33), 9)


def _port(params_j, lora_j, lcfg_j):
    params = tt.params_from_jax(jax.device_get(params_j), device="cpu")
    lora = tlora.lora_from_jax(jax.device_get(lora_j), device="cpu")
    lcfg = tlora.LoraConfig(rank=lcfg_j.rank, alpha=lcfg_j.alpha,
                            targets=tuple(lcfg_j.targets))
    return params, lora, lcfg


def _jax_leaves(lora_j):
    return [np.asarray(ad[n][k]) for ad in lora_j["layers"]
            for n in sorted(ad) for k in ("a", "b")]


def test_loss_and_adapter_grads_match_jax(jax_setup):
    cfg_j, params_j, lcfg_j, lora_j, toks = jax_setup
    params, lora, lcfg = _port(params_j, lora_j, lcfg_j)
    loss_j, g_j = jax.value_and_grad(jlora.lora_loss)(
        lora_j, params_j, jnp.asarray(toks), cfg_j, lcfg_j)
    loss_t = tlora.lora_loss(lora, params, torch.from_numpy(toks),
                             CFG_T, lcfg)
    g_t = torch.autograd.grad(loss_t, tlora.lora_leaves(lora))
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5
    for a, b in zip(g_t, _jax_leaves(g_j)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)
    assert max(float(np.abs(b).max()) for b in _jax_leaves(g_j)) > 1e-3


def test_adamw_steps_match_jax(jax_setup):
    cfg_j, params_j, lcfg_j, lora_j, toks = jax_setup
    params, lora, lcfg = _port(params_j, lora_j, lcfg_j)
    lora_j = jax.tree.map(jnp.copy, lora_j)    # the jitted step donates
    step_j, opt_j = jlora.make_lora_train_step(cfg_j, lcfg_j)
    state_j = opt_j.init(lora_j)
    step_t, init_t = tlora.make_lora_train_step(CFG_T, lcfg)
    opt_t = init_t(lora)
    start = [t.detach().clone() for t in tlora.lora_leaves(lora)]
    for _ in range(3):
        loss_j, lora_j, state_j = step_j(lora_j, state_j, params_j,
                                         jnp.asarray(toks), None)
        loss_t, lora, opt_t = step_t(lora, opt_t, params,
                                     torch.from_numpy(toks))
        assert abs(float(loss_t) - float(loss_j)) <= 1e-4
    for a, b, a0 in zip(tlora.lora_leaves(lora), _jax_leaves(lora_j),
                        start):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=3 * LR)
        # the gate is the size of three updates: hold the updates too,
        # which move every leaf by about 3 lr and agree in nearly every
        # element
        up_t, up_j = (a.detach() - a0).numpy(), b - a0.numpy()
        assert np.abs(up_j).mean() > LR
        assert (np.abs(up_t - up_j) > LR / 10).mean() <= 0.01
