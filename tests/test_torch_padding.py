"""The port's pad/unpad helpers (ops/padding.py) against the JAX package's
(ops/padding.py there), values and gradients: the gather, the scatter, the
gather with a residual (its two cotangents add), unpad_input,
unpad_input_for_concatenated_sequences and pad_input; then the slice end
to end, unpad_input -> flash_attn_varlen_func -> pad_input -> loss ->
backward, against the same in JAX with jax.grad.  Helpers are exact (fp32
values and gradients equal); the slice within 1e-5 (loss) and 1e-4
(gradients), fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flash_attn_v100_tpu import flash_attn_varlen_func as jax_varlen
from flash_attn_v100_tpu.ops import padding as jpad
from flash_attn_v100_tpu_torch.ops import padding as tpad
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func

torch.set_num_threads(1)

RNG = np.random.default_rng(31)
X = RNG.standard_normal((3, 16, 2, 4)).astype(np.float32)
MASK = (np.arange(16)[None, :] < np.asarray([5, 16, 9])[:, None]).astype(
    np.int32)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _eq(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_array_equal(a, np.asarray(b))


def test_index_first_axis_and_put_match_jax():
    x = X.reshape(48, 2, 4)
    idx = np.asarray([3, 0, 47, 12, 5], np.int64)
    g = RNG.standard_normal((5, 2, 4)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a: jpad.index_first_axis(a, jnp.asarray(idx)),
                       jnp.asarray(x))
    xt = _t(x, True)
    y_t = tpad.index_first_axis(xt, torch.from_numpy(idx))
    y_t.backward(torch.from_numpy(g))
    _eq(y_t, y_j)
    _eq(xt.grad, vjp(jnp.asarray(g))[0])          # zero-filled scatter

    vals = g
    gz = RNG.standard_normal((48, 2, 4)).astype(np.float32)
    z_j, vjp = jax.vjp(lambda a: jpad.index_put_first_axis(
        a, jnp.asarray(idx), 48), jnp.asarray(vals))
    vt = _t(vals, True)
    z_t = tpad.index_put_first_axis(vt, torch.from_numpy(idx), 48)
    z_t.backward(torch.from_numpy(gz))
    _eq(z_t, z_j)
    _eq(vt.grad, vjp(jnp.asarray(gz))[0])          # gather


def test_index_first_axis_residual_matches_jax():
    x = X.reshape(48, 8)
    idx = np.asarray([7, 1, 30], np.int64)
    g_out = RNG.standard_normal((3, 8)).astype(np.float32)
    g_res = RNG.standard_normal((48, 8)).astype(np.float32)
    (y_j, r_j), vjp = jax.vjp(lambda a: jpad.index_first_axis_residual(
        a, jnp.asarray(idx)), jnp.asarray(x))
    xt = _t(x, True)
    y_t, r_t = tpad.index_first_axis_residual(xt, torch.from_numpy(idx))
    torch.autograd.backward((y_t, r_t), (torch.from_numpy(g_out),
                                         torch.from_numpy(g_res)))
    _eq(y_t, y_j)
    _eq(r_t, r_j)
    _eq(xt.grad, vjp((jnp.asarray(g_out), jnp.asarray(g_res)))[0])


def test_unpad_and_pad_input_match_jax():
    un_j, idx_j, cu_j, max_j, lens_j = jpad.unpad_input(jnp.asarray(X),
                                                        jnp.asarray(MASK))
    xt = _t(X, True)
    un_t, idx_t, cu_t, max_t, lens_t = tpad.unpad_input(
        xt, torch.from_numpy(MASK))
    _eq(un_t, un_j)
    _eq(idx_t, idx_j)
    _eq(cu_t, cu_j)
    _eq(lens_t, lens_j)
    assert max_t == max_j == 16 and cu_t.dtype == torch.int32
    back_t = tpad.pad_input(un_t, idx_t, 3, 16)
    g = RNG.standard_normal(X.shape).astype(np.float32)
    back_t.backward(torch.from_numpy(g))
    _eq(back_t, jpad.pad_input(un_j, idx_j, 3, 16))
    _eq(back_t, X * MASK[:, :, None, None])
    _eq(xt.grad, g * MASK[:, :, None, None])


def test_unpad_input_for_concatenated_sequences_matches_jax():
    aml = np.asarray([[3, 2, 0, 0], [4, 0, 0, 0], [1, 1, 1, 0]], np.int32)
    x = X[:, :4]
    un_j, idx_j, cu_j, max_j = jpad.unpad_input_for_concatenated_sequences(
        jnp.asarray(x), jnp.asarray(aml))
    un_t, idx_t, cu_t, max_t = tpad.unpad_input_for_concatenated_sequences(
        _t(x), torch.from_numpy(aml))
    _eq(un_t, un_j)
    _eq(idx_t, idx_j)
    _eq(cu_t, cu_j)
    assert max_t == max_j == 4


def test_unpad_varlen_pad_end_to_end_matches_jax():
    """A padded batch as HF trains one: q with 4 heads, k/v with 2, lengths
    [20, 32, 7], causal; loss = sum(pad_input(out) * w)."""
    B, S, Hq, Hk, D = 3, 32, 4, 2, 32
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    w = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    mask = (np.arange(S)[None, :] < np.asarray([20, 32, 7])[:, None]).astype(
        np.int32)

    def jax_loss(q_, k_, v_):
        mj = jnp.asarray(mask)
        qu, idx, cu, ms, _ = jpad.unpad_input(q_, mj)
        ku = jpad.unpad_input(k_, mj)[0]
        vu = jpad.unpad_input(v_, mj)[0]
        o = jax_varlen(qu, ku, vu, cu, cu, ms, ms, causal=True)
        return (jpad.pad_input(o, idx, B, S) * w).sum()

    loss_j, grads_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    leaves = [_t(x, True) for x in (q, k, v)]
    mt = torch.from_numpy(mask)
    qu, idx, cu, ms, _ = tpad.unpad_input(leaves[0], mt)
    ku = tpad.unpad_input(leaves[1], mt)[0]
    vu = tpad.unpad_input(leaves[2], mt)[0]
    o = flash_attn_varlen_func(qu, ku, vu, cu, cu, ms, ms, causal=True)
    loss_t = (tpad.pad_input(o, idx, B, S) * torch.from_numpy(w)).sum()
    loss_t.backward()
    loss_j = float(loss_j)
    assert abs(loss_t.detach().item() - loss_j) <= 1e-5 * max(1.0,
                                                              abs(loss_j))
    for leaf, g_j, what in zip(leaves, grads_j, ("dq", "dk", "dv")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g_j),
                                   rtol=0, atol=1e-4, err_msg=what)
        assert not leaf.grad[0, 20:].any() and not leaf.grad[2, 7:].any()
