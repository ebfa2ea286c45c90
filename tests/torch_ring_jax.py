"""The JAX side of the port's sequence-parallel tests: the JAX package's
ring_attention, ulysses_attention and sharded model on the same-shaped
mesh of its virtual CPU devices, held against the ranks' results that
tests/torch_ring_cases.py brings back.  The parent test process imports
this module; the spawned ranks never do."""

import jax
import jax.numpy as jnp
import numpy as np

from flash_attn_v100_tpu.parallel.mesh import make_mesh as jax_mesh
from flash_attn_v100_tpu.parallel.ring import (
    ring_attention, ulysses_attention, zigzag_shard)

import torch_parallel_cases as pc
import torch_ring_cases as rc

ATOL, GRAD_ATOL = 1e-5, 1e-4


def _block(a, coords, spec, sizes):
    """The block of the global array `a` at mesh `coords` under `spec`
    (one axis name or None per dimension) on a mesh of axis `sizes`."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = a.shape[dim] // sizes[axis]
        a = np.take(a, np.arange(coords[axis] * n, (coords[axis] + 1) * n),
                    dim)
    return a


def jax_attention(name, group):
    """JAX's output and gradients of sum(out * do) for one case, jitted
    (shard_map run eagerly interprets the kernels op by op)."""
    cases = rc.RING_CASES if group == "ring" else rc.ULYSSES_CASES
    (data, seq, model), *_shape, kw = cases[name]
    x = rc.attn_inputs(name, cases)
    mesh = jax_mesh(data=data, seq=seq, model=model)
    if group == "ring":
        kw = rc.ring_kwargs(name, x)
        kw = {k: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
              for k, a in kw.items()}
        fn = ring_attention
    else:
        fn = ulysses_attention
    q, k, v, do = (jnp.asarray(x[n]) for n in ("q", "k", "v", "do"))
    if kw.get("layout") == "zigzag":
        q, k, v, do = (zigzag_shard(a, seq) for a in (q, k, v, do))

    def loss(q, k, v):
        out = fn(q, k, v, mesh, **kw)
        return (out * do).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads], mesh


def assembled(run, name, group="ring"):
    """The ranks' output blocks put together -> (global output, gradients
    summed over the ranks)."""
    ranks = run[0]
    cases = rc.RING_CASES if group == "ring" else rc.ULYSSES_CASES
    (data, seq, model), *_ = cases[name]
    sizes = dict(data=data, seq=seq, model=model)
    axes = (("data", "seq", "model") if group == "ring"
            else ("data", "seq", None))
    got = [r[group][name] for r in ranks if name in r[group]]
    x = rc.attn_inputs(name, cases)
    out = np.zeros_like(x["q"])
    for r in got:
        idx = []
        for dim, axis in enumerate(axes):
            n = out.shape[dim] // (sizes[axis] if axis else 1)
            c = r["coords"][axis] if axis else 0
            idx.append(slice(c * n, (c + 1) * n))
        out[tuple(idx)] = r["out"]
    return out, [sum(r["grads"][i] for r in got) for i in range(3)]


def run_attention(tmp_path, cases, group="ring"):
    """The ranks' results (ring_body on 4 ranks) and JAX's for each of
    `cases`, computed while the ranks run."""
    job = pc.Spawned("torch_ring_cases.ring_body", 4, tmp_path,
                     {group: list(cases)})
    ref = {name: jax_attention(name, group) for name in cases}
    return job.results(), ref


def check_attention_against_jax(run, name, group="ring"):
    """Each rank's output block within 1e-5 of JAX's on the same mesh, and
    the gradients (every rank's summed) within 1e-4 of jax.grad's."""
    ranks, ref = run
    out, grads, mesh = ref[name]
    spec = (("data", "seq", "model", None) if group == "ring"
            else ("data", "seq", None, None))
    got = [r[group][name] for r in ranks if name in r[group]]
    assert len(got) == mesh.size, (name, len(got))
    for r in got:
        np.testing.assert_allclose(
            r["out"], _block(out, r["coords"], spec, mesh.shape), rtol=0,
            atol=ATOL)
    for i, g in enumerate(grads):
        total = sum(r["grads"][i] for r in got)
        np.testing.assert_allclose(total, g, rtol=0, atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# the sharded model

def train_inputs(mesh_shape, dropout_p=0.0, n_layers=2):
    """The spawn's inputs for train_body: ModelConfig.tiny() weights (the
    port's init_params, as numpy), tokens, and with dropout JAX's
    per-layer seeds key_data(fold_in(PRNGKey(7), i))[:2]."""
    from flash_attn_v100_tpu_torch.models import transformer as tt
    cfg = tt.ModelConfig.tiny(dropout_p=dropout_p, n_layers=n_layers)
    params = tt.init_params(cfg, seed=0, device="cpu")
    seeds = None
    if dropout_p:
        key = jax.random.PRNGKey(7)
        seeds = np.stack([
            np.asarray(jax.random.key_data(jax.random.fold_in(key, i))
                       ).reshape(-1)[:2] for i in range(n_layers)])
    return dict(mesh=mesh_shape, dropout_p=dropout_p, n_layers=n_layers,
                tokens=rc.train_tokens(), seeds=seeds,
                params=pc.numpy_params(params))


def _leaves_j(tree):
    """A JAX parameter tree's leaves in the port's param_leaves order."""
    return [tree["embed"], tree["ln_f"]] + [
        lp[k] for lp in tree["layers"] for k in sorted(lp)]


def jax_train(inputs, logits=True):
    """The JAX package on the same mesh (params placed by param_shardings),
    in one jitted call: forward(mesh=)'s logits, loss_fn(mesh=) and its
    jax.grad, and the updates of sgd_train_step (p - lr g) and of
    make_train_step's optax.adamw(3e-4, weight_decay=0.01) on those
    gradients.  Returns numpy results, parameters as the port's
    param_leaves lists, and each leaf's spec."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from flash_attn_v100_tpu.models import transformer as jt
    cfg = jt.ModelConfig.tiny(dropout_p=inputs["dropout_p"],
                              n_layers=inputs["n_layers"])
    mesh = jax_mesh(*inputs["mesh"])
    params = jax.tree.map(jnp.asarray, inputs["params"])
    shardings = jt.param_shardings(params, cfg, mesh)
    placed = jax.device_put(params, shardings)
    toks = jax.device_put(jnp.asarray(inputs["tokens"]),
                          NamedSharding(mesh, P("data", None)))
    kw = dict(mesh=mesh, interpret=True,
              rng_key=jax.random.PRNGKey(7) if inputs["dropout_p"] else None)
    opt = optax.adamw(3e-4, weight_decay=0.01)

    def run(p, t):
        out = {}
        if logits:
            out["logits"] = jt.forward(p, t[:, :-1], cfg, **kw)
        out["loss"], g = jax.value_and_grad(jt.loss_fn)(p, t, cfg, **kw)
        out["grads"] = g
        out["sgd"] = jax.tree.map(
            lambda a, b: a - rc.SGD_LR * b.astype(a.dtype), p, g)
        upd, _ = opt.update(g, opt.init(p), p)
        out["adam"] = optax.apply_updates(p, upd)
        return out

    out = jax.jit(run)(placed, toks)
    res = {k: [np.asarray(x) for x in _leaves_j(out[k])]
           for k in ("grads", "sgd", "adam")}
    res.update(loss=float(out["loss"]), sizes=mesh.shape,
               specs=[tuple(sh.spec) for sh in _leaves_j(shardings)])
    if logits:
        res["logits"] = np.asarray(out["logits"])
    return res


def check_train_logits(ranks, ref):
    """Each rank's logits block within 1e-4 of JAX's forward(mesh=) (the
    unsharded test_torch_train.py's gate)."""
    for r in ranks:
        want = _block(ref["logits"], r["coords"], ("data", "seq", None),
                      ref["sizes"])
        np.testing.assert_allclose(r["logits"], want, rtol=0, atol=1e-4)


def check_train_losses(ranks, ref):
    """loss_fn(mesh=), and the losses sgd_train_step(mesh=) and
    make_train_step(mesh=) return, within 1e-5 of JAX's loss_fn(mesh=):
    the global mean on every rank."""
    for r in ranks:
        for key in ("loss", "sgd_loss", "adam_loss"):
            assert abs(r[key] - ref["loss"]) <= 1e-5, (key, r[key],
                                                       ref["loss"])


def check_train_leaves(ranks, ref, name, atol):
    """Each rank's parameter-shaped results (`name`: its gradient shards
    summed over "data" and "seq", its shards after one SGD or one AdamW
    step) within `atol` of the blocks of JAX's."""
    for r in ranks:
        for i, (got, want, spec) in enumerate(zip(r[name], ref[name],
                                                  ref["specs"])):
            want = _block(want, r["coords"], spec, ref["sizes"])
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=f"{name} leaf {i}")
