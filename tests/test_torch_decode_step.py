"""Port init_kv_caches + decode_step (the contiguous-cache route into K4)
against the JAX package's, tiny fp32 configs: logits within 1e-4, appended
caches within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.models import transformer as jmodel
from flash_attn_v100_tpu_torch.models import transformer as tmodel

import torch_engine_scenarios as sc

torch.set_num_threads(1)

LOGITS_ATOL = 1e-4


@pytest.mark.parametrize("cfg_kw", [{}, dict(sliding_window=4, qkv_bias=True)],
                         ids=["plain", "window_qkv_bias"])
def test_decode_step_logits_match_jax(cfg_kw):
    """init_kv_caches + decode_step (the contiguous-cache route into K4):
    one 5-token prefill and one decode step, logits within 1e-4 and the
    appended caches within 1e-5 of JAX's."""
    (jcfg, jparams), (tcfg, tparams) = sc.make_models(**cfg_kw)
    rng = np.random.default_rng(2)
    jcaches = jmodel.init_kv_caches(jcfg, 2, 16)
    tcaches = tmodel.init_kv_caches(tcfg, 2, 16, device="cpu")
    assert tcaches[0][0].shape == jcaches[0][0].shape
    cs = np.zeros(2, np.int32)
    for T in (5, 1):
        toks = rng.integers(0, jcfg.vocab_size, (2, T))
        jl, jcaches = jmodel.decode_step(jparams, jcaches,
                                         jnp.asarray(toks, jnp.int32),
                                         jnp.asarray(cs), jcfg)
        tl, tcaches2 = tmodel.decode_step(tparams, tcaches,
                                          torch.from_numpy(toks),
                                          torch.from_numpy(cs), tcfg)
        assert tcaches2 is tcaches
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGITS_ATOL)
        for (tk, tv), (jk, jv) in zip(tcaches, jcaches):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                       atol=1e-5)
        cs = cs + T
