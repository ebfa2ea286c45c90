"""The port's training forward and backward (models/transformer.py:
forward, loss_fn) against the JAX package's, on ModelConfig.tiny() (fp32,
2 layers) with the same weights (params_from_jax) and the same tokens
(2, 33).  Attention runs through K1-K3's plain versions here and through the
Pallas kernels in interpret mode on the JAX side.  The optimizer steps are
in test_torch_train_steps.py.

Tolerances (fp32): logits 1e-4, loss 1e-5, gradients 1e-4."""

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


def _leaves_j(tree):
    return [np.asarray(x) for x in (tree["embed"], tree["ln_f"])] + [
        np.asarray(lp[k]) for lp in tree["layers"] for k in sorted(lp)]


def test_forward_logits_match_jax(setup):
    params_j, tokens = setup
    lj = np.asarray(jt.forward(params_j, jnp.asarray(tokens), CFG_J,
                               interpret=True))
    lt = tt.forward(_torch_params(params_j), torch.from_numpy(tokens), CFG_T)
    assert lt.dtype == torch.float32 and lt.shape == lj.shape
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=1e-4)


def test_loss_and_grads_match_jax(setup):
    params_j, tokens = setup
    loss_j, g_j = jax.value_and_grad(jt.loss_fn)(
        params_j, jnp.asarray(tokens), CFG_J, interpret=True)
    params_t = _torch_params(params_j, requires_grad=True)
    loss_t = tt.loss_fn(params_t, torch.from_numpy(tokens), CFG_T)
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5
    for p, gj in zip(tt.param_leaves(params_t), _leaves_j(g_j)):
        np.testing.assert_allclose(p.grad.numpy(), gj, rtol=0, atol=1e-4)


def test_forward_dropout_matches_jax_seeds(setup):
    """Dropout 0.1 with JAX's per-layer seeds key_data(fold_in(key, i))[:2]:
    the same keep masks, so the same logits."""
    params_j, tokens = setup
    cfg_j = jt.ModelConfig.tiny(dropout_p=0.1)
    cfg_t = tt.ModelConfig.tiny(dropout_p=0.1)
    key = jax.random.PRNGKey(7)
    lj = np.asarray(jt.forward(params_j, jnp.asarray(tokens), cfg_j,
                               rng_key=key, interpret=True))
    seeds = np.stack([
        np.asarray(jax.random.key_data(jax.random.fold_in(key, i))
                   ).reshape(-1)[:2] for i in range(cfg_j.n_layers)])
    lt = tt.forward(_torch_params(params_j), torch.from_numpy(tokens), cfg_t,
                    dropout_seeds=seeds)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=1e-4)
    l_nodrop = tt.forward(_torch_params(params_j), torch.from_numpy(tokens),
                          CFG_T)
    assert (lt - l_nodrop).abs().max() > 1e-2, "dropout had no effect"


def test_training_entry_points_reject_mesh(setup):
    params_j, tokens = setup
    with pytest.raises(NotImplementedError):
        tt.forward(_torch_params(params_j), torch.from_numpy(tokens), CFG_T,
                   mesh=object())
    with pytest.raises(NotImplementedError):
        tt.make_train_step(CFG_T, mesh=object())


def test_rope_tables_match_jax_on_the_named_device():
    """rope_tables places its tables on the device it is given (the GPU by
    default, like every entry point); here the CPU, named explicitly."""
    cos_j, sin_j = jt.rope_tables(CFG_J, 64)
    cos_t, sin_t = tt.rope_tables(CFG_T, 64, device="cpu")
    assert cos_t.device.type == "cpu" and cos_t.dtype == torch.float32
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=0,
                               atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tt.rope_tables(CFG_T, 64)
