"""Shared by tests/test_torch_dense*.py: one dense attention case through
the JAX package's flash_attn_func and jax.grad (Pallas interpret mode) and
through the port's flash_attn_func (the plain versions of K1-K3 on the
CPU), fp32, same numpy inputs.

Tolerances (fp32): out and LSE 1e-5 (an LSE of -inf must match exactly),
dq/dk/dv 1e-4, dropout masks bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flash_attn_v100_tpu import flash_attn_func as jax_attn
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4


def make_inputs(B, Hq, Hk, M, N, D, kw, seed=17):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, M, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, N, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, N, Hk, D)).astype(np.float32)
    do = rng.standard_normal((B, M, Hq, D)).astype(np.float32)
    kw = dict(kw)
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = np.asarray([0.5 ** (i + 1) for i in range(Hq)],
                                        np.float32)
    return q, k, v, do, kw


def close(a, b, atol, what):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol,
                               err_msg=what)


def close_lse(lse_t, lse_j):
    lse_j = np.asarray(lse_j)
    lse_t = lse_t.detach().numpy()
    assert np.array_equal(np.isneginf(lse_j), np.isneginf(lse_t))
    fin = np.isfinite(lse_j)
    close(lse_t[fin], lse_j[fin], OUT_ATOL, "lse")


def check_flash_attn_func(B, Hq, Hk, M, N, D, kw):
    """Out, LSE, dmask and the q/k/v gradients of one case; returns the
    port's (out, lse, dq) for case-specific checks."""
    q, k, v, do, kw = make_inputs(B, Hq, Hk, M, N, D, kw)
    jkw = {key: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for key, x in kw.items()}
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    out_j, lse_j, dmask_j = jax_attn(qj, kj, vj, return_attn_probs=True,
                                     **jkw)
    grads_j = jax.grad(lambda *a: (jax_attn(*a, **jkw) * do).sum(),
                       argnums=(0, 1, 2))(qj, kj, vj)

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out_t, lse_t, dmask_t = flash_attn_func(qt, kt, vt,
                                            return_attn_probs=True, **kw)
    (out_t * torch.from_numpy(do)).sum().backward()

    assert out_t.shape == q.shape and lse_t.shape == lse_j.shape
    close(out_t, out_j, OUT_ATOL, "out")
    close_lse(lse_t, lse_j)
    for g_t, g_j, what in zip((qt.grad, kt.grad, vt.grad), grads_j,
                              ("dq", "dk", "dv")):
        close(g_t, g_j, GRAD_ATOL, what)
    if kw.get("dropout_p", 0.0) > 0.0:
        np.testing.assert_array_equal(dmask_t.numpy(), np.asarray(dmask_j))
    else:
        assert dmask_t is None and dmask_j is None
    return out_t.detach(), lse_t.detach(), qt.grad
