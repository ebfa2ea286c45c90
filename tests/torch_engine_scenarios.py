"""Shared engine scenarios for the tests/test_torch_engine*.py files.

A scenario drives a ServingEngine class (the JAX package's or the port's)
through one fixed sequence of submit / step calls and returns what a user
observes: every request's tokens and the engine metrics.  Running the same
scenario through both packages on the same parameters must give identical
greedy tokens.
"""

import jax
import numpy as np
import torch

from flash_attn_v100_tpu.models.transformer import ModelConfig as JaxConfig
from flash_attn_v100_tpu.models.transformer import init_params as jax_init
from flash_attn_v100_tpu.runtime.engine import ServingEngine as JaxEngine
from flash_attn_v100_tpu_torch import ModelConfig as TorchConfig
from flash_attn_v100_tpu_torch import ServingEngine as TorchEngine
from flash_attn_v100_tpu_torch import params_from_jax

torch.set_num_threads(1)


def make_models(**cfg_kw):
    """The same tiny fp32 model in both packages (JAX init, carried over)."""
    base = dict(max_seq_len=64, vocab_size=64)
    base.update(cfg_kw)
    jcfg = JaxConfig.tiny(**base)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tcfg = TorchConfig.tiny(**base)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return (jcfg, jparams), (tcfg, tparams)


def run(engine_cls, params, cfg, script, **engine_kw):
    """`script(eng)` drives the engine and returns {name: rid}; returns
    ({name: tokens}, metrics, preemptions)."""
    kw = dict(engine_kw)
    if engine_cls is TorchEngine:
        kw.setdefault("device", "cpu")
    eng = engine_cls(params, cfg, **kw)
    rids = script(eng)
    out = eng.run_to_completion()
    for rid in rids.values():
        if rid not in out:
            out[rid] = eng.result(rid)
    return ({name: [int(t) for t in out[rid]] for name, rid in rids.items()},
            dict(eng.metrics), eng.sched.stats()["preemptions"])


def both(script, jax_kw=None, torch_kw=None, cfg_kw=None, **engine_kw):
    """Run `script` through the JAX engine and the port's engine."""
    (jcfg, jparams), (tcfg, tparams) = make_models(**(cfg_kw or {}))
    j = run(JaxEngine, jparams, jcfg, script, **engine_kw, **(jax_kw or {}))
    t = run(TorchEngine, tparams, tcfg, script, **engine_kw,
            **(torch_kw or {}))
    return j, t


PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5, 3]]


def three_prompts(eng, n_new=6):
    return {i: eng.submit(p, max_new_tokens=n_new)
            for i, p in enumerate(PROMPTS)}


def prng_prompt(n, mul, mod=60):
    return [((i * mul) % mod) + 1 for i in range(n)]


def assert_same(j, t, metric_keys=("tokens_generated", "prefill_tokens",
                                   "prefix_hits", "prefix_tokens_reused")):
    (jt, jm, jp), (tt, tm, tp) = j, t
    assert tt == jt, f"port tokens {tt} != JAX tokens {jt}"
    for k in metric_keys:
        assert tm[k] == jm[k], (k, tm[k], jm[k])
    assert tp == jp
    return np.asarray([len(v) for v in tt.values()])
