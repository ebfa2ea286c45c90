"""The port's drop-in `flash_attn` surface (flash_attn_v100_tpu_torch/
flash_attn/) against the repository's root `flash_attn` shim over the JAX
package: the same names and `__all__`, the same signatures but for the
listed JAX-only / torch-only knobs, the HF padded-attention pattern
(unpad_input -> flash_attn_varlen_func -> pad_input) through both shims
from the same numpy inputs (fp32: out within 1e-5, gradients within
1e-4).  `install_canonical_name`, which gives the port the `flash_attn`
import name in a process, is checked in fresh subprocesses by
test_torch_flash_attn_shim_install.py."""

import inspect

import flash_attn as jshim
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flash_attn import bert_padding as jbp
from flash_attn import flash_attn_interface as jfi

from flash_attn_v100_tpu_torch.flash_attn import bert_padding as tbp
from flash_attn_v100_tpu_torch.flash_attn import flash_attn_interface as tfi
from flash_attn_v100_tpu_torch import flash_attn as tshim
from flash_attn_v100_tpu_torch.ops import padding
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func

torch.set_num_threads(1)

ENTRY = {"flash_attn_func": flash_attn_func,
         "flash_attn_varlen_func": flash_attn_varlen_func,
         "flash_attn_with_kvcache": flash_attn_with_kvcache}
ALIASES = {"flash_attn_gpu": flash_attn_func,
           "flash_attn_varlen_gpu": flash_attn_varlen_func,
           "flash_attn_with_kvcache_gpu": flash_attn_with_kvcache}
# the knobs one package has and the other has not
JAX_ONLY = {"interpret", "rng_key", "block_sizes"}
TORCH_ONLY = {"generator"}


@pytest.mark.parametrize("mod", [tshim, tfi], ids=["flash_attn",
                                                    "flash_attn_interface"])
def test_shim_names_are_the_port_objects(mod):
    for name, fn in {**ENTRY, **ALIASES}.items():
        assert getattr(mod, name) is fn, name
    assert tshim.__version__ == jshim.__version__ == "2.8.3"


def test_bert_padding_names_are_the_port_helpers():
    for name in tbp.__all__:
        assert getattr(tbp, name) is getattr(padding, name), name


@pytest.mark.parametrize("pair", [(tshim, jshim), (tfi, jfi), (tbp, jbp)],
                         ids=["flash_attn", "flash_attn_interface",
                              "bert_padding"])
def test_all_equals_the_root_shims(pair):
    assert pair[0].__all__ == pair[1].__all__


@pytest.mark.parametrize("name", sorted(ENTRY))
def test_signatures_match_the_root_shim(name):
    """Every parameter's name, kind and default, in order, but for the
    JAX-only and torch-only knobs."""
    def params(fn, skip):
        return [(p.name, p.kind, p.default) for p in
                inspect.signature(fn).parameters.values()
                if p.name not in skip]
    assert params(getattr(tshim, name), TORCH_ONLY) == params(
        getattr(jshim, name), JAX_ONLY)


def test_hf_padded_pattern_through_both_shims():
    """unpad q, k, v -> flash_attn_varlen_func -> pad_input at B 3, lengths
    37/20/5, 4/2 heads x 32, causal, fp32; loss = sum(out * w)."""
    B, S, Hq, Hk, D = 3, 37, 4, 2, 32
    rng = np.random.default_rng(15)
    q, k, v, w = (rng.standard_normal((B, S, h, D)).astype(np.float32)
                  for h in (Hq, Hk, Hk, Hq))
    mask = (np.arange(S)[None, :] < np.asarray([37, 20, 5])[:, None])

    def jax_loss(q_, k_, v_):
        mj = jnp.asarray(mask)
        qu, idx, cu, ms, _ = jbp.unpad_input(q_, mj)
        o = jshim.flash_attn_varlen_func(
            qu, jbp.unpad_input(k_, mj)[0], jbp.unpad_input(v_, mj)[0], cu,
            cu, ms, ms, causal=True)
        out = jbp.pad_input(o, idx, B, S)
        return (out * w).sum(), out

    (_, out_j), grads_j = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    mt = torch.from_numpy(mask)
    qu, idx, cu, ms, _ = tbp.unpad_input(leaves[0], mt)
    o = tshim.flash_attn_varlen_func(
        qu, tbp.unpad_input(leaves[1], mt)[0],
        tbp.unpad_input(leaves[2], mt)[0], cu, cu, ms, ms, causal=True)
    out_t = tbp.pad_input(o, idx, B, S)
    (out_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-5)
    for leaf, g_j, what in zip(leaves, grads_j, ("dq", "dk", "dv")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g_j),
                                   rtol=0, atol=1e-4, err_msg=what)
        assert not leaf.grad[1, 20:].any() and not leaf.grad[2, 5:].any()
