"""The port's optimizer steps (models/transformer.py: sgd_train_step,
make_train_step with AdamW) against the JAX package's, on
ModelConfig.tiny() (fp32, 2 layers) with the same weights (params_from_jax)
and the same tokens (2, 33); the JAX side runs its Pallas kernels in
interpret mode.

Tolerances (fp32): SGD losses and params 1e-5; AdamW losses 1e-5 and
params 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.models import transformer as jt
from flash_attn_v100_tpu_torch.models import transformer as tt

torch.set_num_threads(1)

CFG_J = jt.ModelConfig.tiny()
CFG_T = tt.ModelConfig.tiny()


@pytest.fixture(scope="module")
def setup():
    params_j = jt.init_params(jax.random.PRNGKey(0), CFG_J)
    tokens = np.random.default_rng(3).integers(
        0, CFG_J.vocab_size, (2, 33)).astype(np.int32)
    return params_j, tokens


def _torch_params(params_j, requires_grad=False):
    return tt.params_from_jax(jax.device_get(params_j), device="cpu",
                              requires_grad=requires_grad)


def _assert_params_close(params_t, params_j, atol):
    leaves_j = [params_j["embed"], params_j["ln_f"]] + [
        lp[k] for lp in params_j["layers"] for k in sorted(lp)]
    for a, b in zip(tt.param_leaves(params_t), leaves_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=atol)


def test_sgd_steps_match_jax(setup):
    params_j, tokens = setup
    params_t = _torch_params(params_j)
    toks_t = torch.from_numpy(tokens)
    for _ in range(2):
        loss_j, params_j = jt.sgd_train_step(params_j, jnp.asarray(tokens),
                                             CFG_J, lr=5e-2, interpret=True)
        loss_t, params_t = tt.sgd_train_step(params_t, toks_t, CFG_T, lr=5e-2)
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5
    _assert_params_close(params_t, params_j, 1e-5)


def test_adamw_steps_match_jax(setup):
    params_j, tokens = setup
    params_t = _torch_params(params_j, requires_grad=True)
    params_j = jax.tree.map(jnp.copy, params_j)    # the jitted step donates
    step_j, opt_j = jt.make_train_step(CFG_J, interpret=True)
    state_j = opt_j.init(params_j)
    step_t, init_t = tt.make_train_step(CFG_T)
    opt_t = init_t(params_t)
    losses = []
    for _ in range(3):
        loss_j, params_j, state_j = step_j(params_j, state_j,
                                           jnp.asarray(tokens), None)
        loss_t, params_t, opt_t = step_t(params_t, opt_t,
                                         torch.from_numpy(tokens))
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5
        losses.append(float(loss_t))
    assert losses[2] < losses[0]
    _assert_params_close(params_t, params_j, 1e-4)
