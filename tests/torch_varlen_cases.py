"""Shared by tests/test_torch_varlen*.py: one packed-varlen attention case
through the JAX package's flash_attn_varlen_func (Pallas interpret mode;
out, LSE and the q/k/v cotangents from one jax.vjp) and through the port's
flash_attn_varlen_func (the plain versions of K5-K7 on the CPU, gradients
from torch.autograd), fp32, same numpy inputs; where the case is in its
reach (no leftpad_k, no dropout keyed on a sorted order), the port's
out and LSE are also held to the port's mha_reference_varlen, a third,
independent oracle.

Tolerances (fp32): out and LSE 1e-5 (an LSE of -inf must match exactly),
dq/dk/dv 1e-4, dropout masks bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flash_attn_v100_tpu import flash_attn_varlen_func as jax_varlen
from flash_attn_v100_tpu_torch.ops.reference import mha_reference_varlen
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4
Hq, Hk, D = 4, 2, 32
# the flash_attn_varlen_func arguments mha_reference_varlen also takes
ORACLE_KW = ("causal", "window_size", "softcap", "alibi_slopes", "dropout_p",
             "dropout_seed", "seqused_k")


def packed(lens_q, lens_k, hq=Hq, hk=Hk, d=D, extra_q=0, extra_k=0,
           seed=23):
    """Packed q/k/v/dout and cu_seqlens for the given lengths; `extra_q` /
    `extra_k` trailing rows belong to no sequence."""
    rng = np.random.default_rng(seed)
    Tq, Tk = sum(lens_q) + extra_q, sum(lens_k) + extra_k
    q = rng.standard_normal((Tq, hq, d)).astype(np.float32)
    k = rng.standard_normal((Tk, hk, d)).astype(np.float32)
    v = rng.standard_normal((Tk, hk, d)).astype(np.float32)
    do = rng.standard_normal((Tq, hq, d)).astype(np.float32)
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    return q, k, v, do, cu_q, cu_k, max(lens_q), max(lens_k)


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


def _jax_kw(kw):
    return {key: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
            for key, x in kw.items()}


def _torch_kw(kw):
    return {key: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
            for key, x in kw.items()}


def check_varlen(lens_q, lens_k, kw, dlse=False, probs=True, **shape):
    """Out, LSE (with `probs`), dmask and the q/k/v gradients of one case,
    `dlse` adding a random cotangent on the LSE.  Returns the port's
    (out, lse, dq, dk, dv) for case-specific checks."""
    q, k, v, do, cu_q, cu_k, msq, msk = packed(lens_q, lens_k, **shape)
    dl = None
    if dlse:
        dl = np.random.default_rng(5).standard_normal(
            (q.shape[1], q.shape[0])).astype(np.float32)
    args_j = (jnp.asarray(cu_q), jnp.asarray(cu_k), msq, msk)
    jkw = _jax_kw(kw)

    def f(q_, k_, v_):
        res = jax_varlen(q_, k_, v_, *args_j, return_attn_probs=probs, **jkw)
        return tuple(res) if probs else (res,)

    res_j, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    cts = (jnp.asarray(do),)
    if probs:
        cts += (jnp.zeros_like(res_j[1]) if dl is None else jnp.asarray(dl),
                None if res_j[2] is None else jnp.zeros_like(res_j[2]))
    grads_j = vjp(cts)

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    res_t = flash_attn_varlen_func(
        *leaves, torch.from_numpy(cu_q), torch.from_numpy(cu_k), msq, msk,
        return_attn_probs=probs, **_torch_kw(kw))
    res_t = tuple(res_t) if probs else (res_t,)
    assert res_t[0].shape == q.shape
    close(res_t[0], res_j[0], OUT_ATOL, "out")
    if set(kw) <= set(ORACLE_KW) | {"sort_sequences"} and not (
            kw.get("sort_sequences") and kw.get("dropout_p", 0.0) > 0.0):
        n = int(cu_q[-1])
        out_o, lse_o = mha_reference_varlen(
            *(torch.from_numpy(x) for x in (q, k, v, cu_q, cu_k)),
            return_lse=True, **_torch_kw({key: kw[key] for key in kw
                                          if key in ORACLE_KW}))
        close(res_t[0][:n], out_o, OUT_ATOL, "out vs mha_reference_varlen")
        if probs:
            close_lse(res_t[1][:, :n], lse_o)
    if probs:
        assert res_t[1].shape == (q.shape[1], q.shape[0])
        close_lse(res_t[1], res_j[1])
        if kw.get("dropout_p", 0.0) > 0.0:
            np.testing.assert_array_equal(res_t[2].numpy(),
                                          np.asarray(res_j[2]))
        else:
            assert res_t[2] is None and res_j[2] is None
    outs, cts = [res_t[0]], [torch.from_numpy(do)]
    if dl is not None:
        outs.append(res_t[1])
        cts.append(torch.from_numpy(dl))
    torch.autograd.backward(outs, cts)
    for leaf, g_j, what in zip(leaves, grads_j, ("dq", "dk", "dv")):
        close(leaf.grad, g_j, GRAD_ATOL, what)
    return (res_t[0].detach(), res_t[1].detach() if probs else None,
            *(leaf.grad for leaf in leaves))
