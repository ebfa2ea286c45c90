"""The JAX side of the multi-process port tests: the JAX package's sharded
functions on the same-shaped mesh of its virtual CPU devices, held against
the ranks' results that tests/torch_parallel_cases.py brings back.  The
parent test process imports this module; the spawned ranks never do."""

import jax
import jax.numpy as jnp
import numpy as np

from flash_attn_v100_tpu.parallel.mesh import make_mesh as jax_mesh
from flash_attn_v100_tpu.parallel.sharded import (
    flash_attn_func_sharded as jax_func_sharded)

import torch_parallel_cases as pc

ATOL, GRAD_ATOL = 1e-5, 1e-4


def check_dense_against_jax(ranks, name):
    """Each rank's output block within 1e-5 of JAX's flash_attn_func_sharded
    on the same mesh, and the gradients (every rank's summed over the mesh)
    within 1e-4 of jax.grad's."""
    (data, seq, model), *_shape, causal = pc.DENSE_CASES[name]
    x = pc.dense_inputs(name)
    mesh = jax_mesh(data=data, seq=seq, model=model)
    q, k, v, do = (jnp.asarray(x[n]) for n in ("q", "k", "v", "do"))

    def loss(q, k, v):
        out = jax_func_sharded(q, k, v, mesh, causal=causal)
        return (out * do).sum(), out

    # jitted: shard_map's eager mode runs the interpreted kernels op by op
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    out = np.asarray(out)
    B, _, Hq, _ = out.shape
    bl, hl = B // data, Hq // model
    for res in ranks:
        r = res["dense"][name]
        c = r["coords"]
        want = out[c["data"] * bl:(c["data"] + 1) * bl, :,
                   c["model"] * hl:(c["model"] + 1) * hl]
        np.testing.assert_allclose(r["out"], want, rtol=0, atol=ATOL)
        for got, g in zip(r["grads"], grads):
            np.testing.assert_allclose(got, np.asarray(g), rtol=0,
                                       atol=GRAD_ATOL)


def check_decode_against_jax(ranks, mesh_shape, name):
    """Each rank's out / LSE blocks within 1e-5 of the JAX package's
    flash_attn_with_kvcache_sharded on the same mesh, and its cache shards
    after the append bit-equal to the blocks of JAX's (within 1e-6 where
    rotary rotated the new keys: XLA may fuse the fp32 rotation
    differently)."""
    from flash_attn_v100_tpu.ops.quant import quantize_kv
    from flash_attn_v100_tpu.parallel.sharded import (
        flash_attn_with_kvcache_sharded)
    data, sp, tp = mesh_shape
    x, kw = pc.decode_inputs(name, sp)
    mesh = jax_mesh(data=data, seq=sp, model=tp)
    a = {}
    if "k" in x:
        a.update(k=jnp.asarray(x["k"]), v=jnp.asarray(x["v"]))
    if "cos" in x:
        a.update(rotary_cos=jnp.asarray(x["cos"]),
                 rotary_sin=jnp.asarray(x["sin"]))
    if "slopes" in x:
        a["alibi_slopes"] = jnp.asarray(x["slopes"])
    if name.startswith("contig"):
        caches = [jnp.asarray(x["kc"]), jnp.asarray(x["vc"])]
        cache_spec = (None, "model", "seq", None)
    else:
        caches = [jnp.asarray(x["pool_k"]), jnp.asarray(x["pool_v"])]
        cache_spec = ("model", "seq", None, None)
        a["block_table"] = jnp.asarray(x["tbl_sharded"])
    if name == "paged_int8":
        (kq, ks), (vq, vs) = (quantize_kv(c, jnp.int8) for c in caches)
        caches = [kq, vq]
        a.update(k_scales=ks, v_scales=vs)
    res = jax.jit(lambda q, kc, vc, lens, a: flash_attn_with_kvcache_sharded(
        q, kc, vc, mesh, lens, return_softmax_lse=True, **a, **kw))(
        jnp.asarray(x["q"]), caches[0], caches[1], jnp.asarray(x["lens"]), a)
    out, lse = np.asarray(res[0]), np.asarray(res[1])
    Hq = out.shape[2]
    hl = Hq // tp
    for rr in ranks:
        r = rr[(tuple(mesh_shape), name)]
        c = r["coords"]
        h = slice(c["model"] * hl, (c["model"] + 1) * hl)
        np.testing.assert_allclose(r["out"], out[:, :, h], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(r["lse"], lse[:, h], rtol=0, atol=ATOL)
        if "k" not in x:
            continue
        for got, want in zip(r["caches"], res[2]):
            want = np.asarray(want)
            for dim, axis in enumerate(cache_spec):
                if axis is not None:
                    n = want.shape[dim] // mesh.shape[axis]
                    want = np.take(want, np.arange(c[axis] * n,
                                                   (c[axis] + 1) * n), dim)
            if "cos" in x:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            else:
                assert np.array_equal(got, want)
