"""The port's zigzag_shard / zigzag_unshard (parallel/ring.py) bit-equal to
the JAX package's, the round trip the identity, and the JAX package's
error messages for the inputs ring and Ulysses attention refuse: an
indivisible sequence, zigzag with a window, non-causal or with an odd
chunk, and heads that do not divide the axis; and the sharded model's
refusal of a model axis that its kv heads do not divide.  One process:
the checks run before any collective."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.parallel import ring as jring
from flash_attn_v100_tpu.parallel.mesh import make_mesh as jax_mesh
from flash_attn_v100_tpu_torch.parallel import ring as tring
from flash_attn_v100_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)


@pytest.mark.parametrize("n,axis", [(2, 1), (4, 1), (3, 0)])
def test_zigzag_shard_matches_jax(n, axis):
    x = np.random.default_rng(n).standard_normal(
        (2 * n * 3, 12, 2) if axis == 0 else (2, 2 * n * 5, 3)
    ).astype(np.float32)
    assert tring.zigzag_order(n) == jring.zigzag_order(n)
    z = tring.zigzag_shard(torch.from_numpy(x), n, axis)
    assert np.array_equal(z.numpy(),
                          np.asarray(jring.zigzag_shard(jnp.asarray(x), n,
                                                        axis)))
    u = tring.zigzag_unshard(z, n, axis)
    assert np.array_equal(u.numpy(), np.asarray(jring.zigzag_unshard(
        jnp.asarray(z.numpy()), n, axis)))
    assert np.array_equal(u.numpy(), x)


def _fake_mesh(data=1, seq=2, model=1):
    """A port mesh of one process standing at rank 0 of a larger grid: the
    checks run before any collective, so none is needed."""
    return Mesh(np.arange(data * seq * model).reshape(data, seq, model), 0,
                {"data": None, "seq": None, "model": None})


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


ERROR_CASES = {
    # name: (q (B, M, H, D), kv heads, seq axis, function, kwargs)
    "indivisible_sequence": ((1, 30, 2, 8), 2, 4, "ring", dict(causal=True)),
    "zigzag_window": ((1, 32, 2, 8), 2, 2, "ring",
                      dict(causal=True, layout="zigzag",
                           window_size=(4, -1))),
    "zigzag_noncausal": ((1, 32, 2, 8), 2, 2, "ring",
                         dict(layout="zigzag")),
    "zigzag_odd_chunk": ((1, 30, 2, 8), 2, 2, "ring",
                         dict(causal=True, layout="zigzag")),
    "ulysses_q_heads": ((1, 32, 6, 8), 4, 4, "ulysses", dict(causal=True)),
    "ulysses_kv_heads": ((1, 32, 8, 8), 2, 4, "ulysses", dict(causal=True)),
}


@pytest.mark.parametrize("name", list(ERROR_CASES))
def test_errors_match_jax(name):
    (B, M, H, D), Hk, seq, fn, kw = ERROR_CASES[name]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, M, H, D)).astype(np.float32)
    kv = rng.standard_normal((B, M, Hk, D)).astype(np.float32)
    jfn = getattr(jring, f"{fn}_attention")
    tfn = getattr(tring, f"{fn}_attention")
    jm = jax_mesh(seq=seq)
    want = _message(lambda: jfn(jnp.asarray(q), jnp.asarray(kv),
                                jnp.asarray(kv), jm, **kw))
    got = _message(lambda: tfn(torch.from_numpy(q), torch.from_numpy(kv),
                               torch.from_numpy(kv), _fake_mesh(seq=seq),
                               **kw))
    assert got == want


def test_model_mesh_refusal_matches_jax():
    """ModelConfig.tiny()'s 2 kv heads on seq 2 x model 4: JAX's ring
    shard_map refuses them, and so does the port's forward."""
    import jax
    from flash_attn_v100_tpu.models import transformer as jt
    from flash_attn_v100_tpu_torch.models import transformer as tt
    tokens = np.random.default_rng(3).integers(0, 256, (2, 33))
    cfg_j, mesh_j = jt.ModelConfig.tiny(), jax_mesh(seq=2, model=4)
    # traced only (shapes): the refusal comes while tracing shard_map
    params = jax.eval_shape(
        lambda: jt.init_params(jax.random.PRNGKey(0), cfg_j))
    with pytest.raises(ValueError):
        jax.eval_shape(lambda p, t: jt.loss_fn(
            p, t, cfg_j, mesh=mesh_j, interpret=True), params,
            jnp.asarray(tokens, jnp.int32))
    cfg = tt.ModelConfig.tiny()
    with pytest.raises(ValueError, match="divide the model axis"):
        tt.loss_fn(tt.init_params(cfg, device="cpu"),
                   torch.from_numpy(tokens), cfg,
                   mesh=_fake_mesh(seq=2, model=4))
