"""ModelConfig.tiny(head_dim=32)'s loss and gradients through the port
(the plain versions of K1-K3 on the CPU) against the JAX package's
(Pallas interpret mode), the same weights and tokens: loss 1e-5, every
gradient 1e-4 (tests/test_torch_train.py's gates).  The card's tests hold
the head-dim-32 kernels against these plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flash_attn_v100_tpu.models import transformer as jt
from flash_attn_v100_tpu_torch.models import transformer as tt

torch.set_num_threads(1)


def _leaves_j(tree):
    return [np.asarray(x) for x in (tree["embed"], tree["ln_f"])] + [
        np.asarray(lp[k]) for lp in tree["layers"] for k in sorted(lp)]


def test_tiny_model_head_dim_32_loss_and_grads_match_jax():
    """ModelConfig.tiny(head_dim=32) at the small encoders' attention
    widths (dim 384, 12 heads x 32, all of them kv heads): JAX's weights
    carried across by params_from_jax, the same tokens; loss 1e-5, every
    gradient 1e-4."""
    shape = dict(head_dim=32, dim=384, n_heads=12, n_kv_heads=12)
    cfg_j, cfg_t = jt.ModelConfig.tiny(**shape), tt.ModelConfig.tiny(**shape)
    params_j = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    tokens = np.random.default_rng(4).integers(
        0, cfg_j.vocab_size, (2, 33)).astype(np.int32)
    loss_j, g_j = jax.value_and_grad(jt.loss_fn)(
        params_j, jnp.asarray(tokens), cfg_j, interpret=True)
    params_t = tt.params_from_jax(jax.device_get(params_j), device="cpu",
                                  requires_grad=True)
    loss_t = tt.loss_fn(params_t, torch.from_numpy(tokens), cfg_t)
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5
    assert params_t["layers"][0]["wq"].shape == (cfg_t.dim, 12 * 32)
    for p, gj in zip(tt.param_leaves(params_t), _leaves_j(g_j)):
        np.testing.assert_allclose(p.grad.numpy(), gj, rtol=0, atol=1e-4)
