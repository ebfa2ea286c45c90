"""The JAX side of the port's LoRA-on-a-mesh tests
(tests/test_torch_lora_mesh*.py): the inputs the spawned ranks get
(ModelConfig.tiny(n_layers=1) weights from the port's init_params, rank-2
adapters on all seven projections with B drawn non-zero, so that every
adapter has a gradient, and tokens (2, 33)), and the JAX package's
make_lora_train_step(cfg, lcfg, mesh=mesh) on the same-shaped mesh of its
virtual CPU devices (params placed by param_shardings, adapters
replicated), jitted, with lora_loss's jax.grad beside it.  The parent
test process imports this module; the spawned ranks never do."""

import jax
import jax.numpy as jnp
import numpy as np

from flash_attn_v100_tpu.parallel.mesh import make_mesh as jax_mesh

import torch_parallel_cases as pc

RANK = 2
TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
LOSS_ATOL, ATOL = 1e-5, 1e-4


def lora_inputs(mesh_shape):
    """The spawn's inputs for torch_ring_cases.lora_body."""
    from flash_attn_v100_tpu_torch.models import transformer as tt
    cfg = tt.ModelConfig.tiny(n_layers=1)
    params = tt.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(17)
    lora = dict(layers=[{
        name: dict(
            a=(rng.standard_normal((lp[name].shape[0], RANK))
               * RANK ** -0.5).astype(np.float32),
            b=(rng.standard_normal((RANK, lp[name].shape[1]))
               * 0.05).astype(np.float32))
        for name in TARGETS} for lp in params["layers"]])
    tokens = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    return dict(mesh=mesh_shape, n_layers=1, rank=RANK, targets=TARGETS,
                params=pc.numpy_params(params), lora=lora, tokens=tokens)


def jax_lora(inputs):
    """JAX's step and gradients on the same mesh: {"loss", "grads",
    "adam"}, the adapter lists in lora_leaves' order (jax.tree.leaves of
    the adapter tree)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from flash_attn_v100_tpu.integrations import lora as jl
    from flash_attn_v100_tpu.models import transformer as jt
    cfg = jt.ModelConfig.tiny(n_layers=inputs["n_layers"])
    lcfg = jl.LoraConfig(rank=inputs["rank"], targets=inputs["targets"])
    mesh = jax_mesh(*inputs["mesh"])
    params = jax.tree.map(jnp.asarray, inputs["params"])
    placed = jax.device_put(params, jt.param_shardings(params, cfg, mesh))
    rep = NamedSharding(mesh, P())
    lora = jax.device_put(jax.tree.map(jnp.asarray, inputs["lora"]), rep)
    toks = jax.device_put(jnp.asarray(inputs["tokens"]),
                          NamedSharding(mesh, P("data", None)))
    kw = dict(mesh=mesh, interpret=True)

    def loss(lo, p, t):
        return jl.lora_loss(lo, p, t, cfg, lcfg, **kw)

    _, grads = jax.jit(jax.value_and_grad(loss))(lora, placed, toks)
    step, optimizer = jl.make_lora_train_step(cfg, lcfg, **kw)
    opt_state = optimizer.init(lora)
    # the step donates its adapters and optimizer state: a copy of each
    loss_v, new, _ = step(jax.tree.map(jnp.copy, lora),
                          jax.tree.map(jnp.copy, opt_state), placed, toks,
                          None)
    return dict(loss=float(loss_v),
                grads=[np.asarray(x) for x in jax.tree.leaves(grads)],
                adam=[np.asarray(x) for x in jax.tree.leaves(new)])


def check_materialize(ranks):
    """materialize on each rank's shard equals the shard of the unsharded
    materialize, bit for bit."""
    assert len(ranks) == 4
    for r in ranks:
        assert r["materialize_equal"], r["materialize_err"]


def check_loss(ranks, ref):
    """The step's loss, the global mean on every rank, within 1e-5 of
    JAX's."""
    for r in ranks:
        assert abs(r["loss"] - ref["loss"]) <= LOSS_ATOL, (r["loss"],
                                                           ref["loss"])


def check_leaves(ranks, ref, key):
    """Each adapter's gradient (`key` "grads") or its value after the
    AdamW step ("adam") within 1e-4 of JAX's, on every rank."""
    for r in ranks:
        assert len(r[key]) == len(ref[key]) == 2 * len(TARGETS)
        for i, (got, want) in enumerate(zip(r[key], ref[key])):
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                       err_msg=f"{key} leaf {i}")
