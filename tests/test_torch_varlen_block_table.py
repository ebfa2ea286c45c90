"""The port's flash_attn_varlen_func against the JAX package's with paged
K/V through its three `block_table` routes: an HND pool and an NHD pool
with page 128 through K8's plain version (forward-only), and an NHD pool
with page 32 through the page gather into K5-K7 (with a seqused_k cap, and
gradients into q and the pools).  Tolerances of
tests/torch_varlen_cases.py: out 1e-5, gradients 1e-4, fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_varlen_cases as vc
from flash_attn_v100_tpu import flash_attn_varlen_func as jax_varlen
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func

torch.set_num_threads(1)

PAGED_LENS_Q, PAGED_LENS_K = [64, 100, 17], [200, 128, 37]


def _pool(packed, lens, ps):
    """Packed (Tk, Hk, D) -> an NHD pool (P, ps, Hk, D) with the sequences
    on shuffled pages (page 0 unused) and its block table."""
    pages = [-(-n // ps) for n in lens]
    P = sum(pages) + 1
    rng = np.random.default_rng(ps)
    ids = rng.permutation(np.arange(1, P))
    pool = np.zeros((P, ps) + packed.shape[1:], np.float32)
    table = np.zeros((len(lens), max(pages)), np.int32)
    at = off = 0
    for b, n in enumerate(lens):
        for j in range(pages[b]):
            m = min(ps, n - j * ps)
            pool[ids[at], :m] = packed[off + j * ps:off + j * ps + m]
            table[b, j] = ids[at]
            at += 1
        off += n
    return pool, table


@pytest.mark.parametrize("route", ["hnd", "nhd128"])
def test_varlen_block_table_k8_routes_match_jax(route):
    q, k, v, _, cu_q, cu_k, msq, msk = vc.packed(PAGED_LENS_Q, PAGED_LENS_K)
    kp, table = _pool(k, PAGED_LENS_K, 128)
    vp, _ = _pool(v, PAGED_LENS_K, 128)
    if route == "hnd":
        kp, vp = (np.ascontiguousarray(x.transpose(2, 0, 1, 3))
                  for x in (kp, vp))
    kw = dict(causal=True, kv_cache_layout="HND" if route == "hnd" else "NHD")
    out_j = jax_varlen(*(jnp.asarray(x) for x in (q, kp, vp, cu_q, cu_k)),
                       msq, msk, block_table=jnp.asarray(table), **kw)
    out_t = flash_attn_varlen_func(
        *(torch.from_numpy(x) for x in (q, kp, vp, cu_q, cu_k)), msq, msk,
        block_table=torch.from_numpy(table), **kw)
    assert out_t.grad_fn is None        # forward-only, as in JAX
    vc.close(out_t, out_j, vc.OUT_ATOL, "out")


def test_varlen_block_table_gather_route_matches_jax():
    """Page 32 in the NHD layout: the page gather into K5-K7, with a
    seqused_k cap, differentiable in q and in the pools."""
    q, k, v, do, cu_q, cu_k, msq, msk = vc.packed(PAGED_LENS_Q, PAGED_LENS_K)
    kp, table = _pool(k, PAGED_LENS_K, 32)
    vp, _ = _pool(v, PAGED_LENS_K, 32)
    used = np.asarray([150, 128, 30], np.int32)
    kw = dict(causal=True, seqused_k=used)

    def f(q_, kp_, vp_):
        return jax_varlen(q_, kp_, vp_, jnp.asarray(cu_q), jnp.asarray(cu_k),
                          msq, msk, block_table=jnp.asarray(table),
                          **vc._jax_kw(kw))

    out_j, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, kp, vp)))
    grads_j = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, kp, vp)]
    out_t = flash_attn_varlen_func(
        *leaves, torch.from_numpy(cu_q), torch.from_numpy(cu_k), msq, msk,
        block_table=torch.from_numpy(table), **vc._torch_kw(kw))
    out_t.backward(torch.from_numpy(do))
    vc.close(out_t, out_j, vc.OUT_ATOL, "out")
    for leaf, g_j, what in zip(leaves, grads_j, ("dq", "dk_pool", "dv_pool")):
        vc.close(leaf.grad, g_j, vc.GRAD_ATOL, what)
