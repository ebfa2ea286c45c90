"""The JAX side of tests/test_torch_measure_ttft*.py: the tiny fp32 model
in both packages and the JAX engine driven through prof_ttft_tail's two
bursts, its scheduler decisions recorded as the port's script records
them."""

import jax
import numpy as np

from flash_attn_v100_tpu.models.transformer import ModelConfig as JaxConfig
from flash_attn_v100_tpu.models.transformer import init_params as jax_init
from flash_attn_v100_tpu.runtime.engine import ServingEngine as JaxEngine
from flash_attn_v100_tpu_torch import ModelConfig, params_from_jax

CFG = dict(max_seq_len=64, vocab_size=64)
NREQ, PLEN, NEW, PS, PAGES = 6, 32, 4, 8, 20
# the sets "staggered mps=8" and "chunked 1024" at this burst's scale: a
# quarter of their batch and prefill widths
SETS = {"mps8": dict(max_batch=4, max_prefill_seqs=2),
        "chunk1024": dict(max_batch=4, prefill_chunk=16)}


def models():
    """((JAX cfg, params), (port cfg, params), prompts)."""
    jcfg = JaxConfig.tiny(**CFG)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig.tiny(**CFG)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, CFG["vocab_size"], PLEN).tolist()
               for _ in range(NREQ)]
    return (jcfg, jparams), (tcfg, tparams), prompts


def jax_bursts(params, cfg, prompts, **kw):
    """The script's two bursts through the JAX engine, stepped as its
    run_to_completion steps, with the same decisions recorded."""
    eng = JaxEngine(params, cfg, num_pages=PAGES, page_size=PS, **kw)
    bursts = []
    for _ in range(2):
        steps0 = eng.metrics["steps"]
        pf0 = eng.metrics["prefill_tokens"]
        rids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
        first = {}
        while not eng.idle():
            for sid in eng.step():
                eng.result(sid)
            for r in rids:
                if r not in first and eng.ttft(r) is not None:
                    first[r] = eng.metrics["steps"] - steps0
        bursts.append(dict(steps=eng.metrics["steps"] - steps0,
                           prefill_tokens=eng.metrics["prefill_tokens"] - pf0,
                           first_token_step=[first[r] for r in rids]))
    return bursts


def check_set(tt, key):
    """The port's `run` against the JAX engine for the knob set `key`."""
    (jcfg, jparams), (tcfg, tparams), prompts = models()
    assert set(SETS[key]) == set(tt.CONFIGS[key][1])     # the set's knobs
    want = jax_bursts(jparams, jcfg, prompts, **SETS[key])
    got = tt.run(tt.CONFIGS[key][0], tparams, tcfg, prompts, NEW, "cpu",
                 page_size=PS, num_pages=PAGES, **SETS[key])
    assert got["bursts"] == want
    # page-bound: the second wave's first tokens come after the first's
    firsts = want[1]["first_token_step"]
    assert max(firsts) > min(firsts)
    assert got["p50_s"] <= got["p90_s"]
