"""prof_decode_attrib (flash_attn_v100_tpu_torch/benchmarks/
prof_decode_attrib.py) on the CPU: its chained `paged_forward` decode
(part (a), `DecodeChain`) gives the greedy tokens of the JAX script's
scan (`benchmarks/prof_decode_attrib.py::device_only`, its body with the
tokens collected) on the fp32 `ModelConfig.tiny()`, the weights JAX's
init carried across by `params_from_jax`, again on a second run over the
same pools; and the script runs at a tiny size with the lines it prints
parsing to finite numbers."""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.models.transformer import ModelConfig as JaxConfig
from flash_attn_v100_tpu.models.transformer import init_params as jax_init
from flash_attn_v100_tpu.runtime.engine import paged_forward as jax_forward
from flash_attn_v100_tpu_torch import ModelConfig, params_from_jax
from flash_attn_v100_tpu_torch.benchmarks import prof_decode_attrib as pda

torch.set_num_threads(1)

B, PLEN, PS, N = 2, 16, 16, 4
CFG = dict(max_seq_len=64, vocab_size=64)


def jax_scan_tokens(params, cfg, toks):
    """The JAX script's device_only body at this size, the scan's
    outputs the tokens of each step."""
    mp = cfg.max_seq_len // PS
    pool_shape = (cfg.n_kv_heads, (B * mp + 1) * cfg.n_layers, PS,
                  cfg.head_dim)
    kp = jnp.zeros(pool_shape, cfg.dtype)
    vp = jnp.zeros_like(kp)
    bt = jnp.asarray(1 + np.arange(B * mp).reshape(B, mp), jnp.int32)
    cs = jnp.full((B,), PLEN, jnp.int32)

    def body(carry, _):
        tok, cs, kp, vp = carry
        logits, kp, vp = jax_forward(params, kp, vp, tok[:, None], cs, bt,
                                     cfg=cfg)
        nxt = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
        return (nxt, cs + 1, kp, vp), nxt
    _, seq = jax.lax.scan(body, (jnp.asarray(toks, jnp.int32), cs, kp, vp),
                          None, length=N)
    return np.asarray(seq)


def test_chain_tokens_match_the_jax_scan():
    jcfg = JaxConfig.tiny(**CFG)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig.tiny(**CFG)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(0)
    [rng.integers(1, tcfg.vocab_size, PLEN) for _ in range(B)]   # prompts
    toks = rng.integers(1, tcfg.vocab_size, (B,))
    want = jax_scan_tokens(jparams, jcfg, toks)
    chain = pda.DecodeChain(tparams, tcfg, toks, PLEN, PS, "cpu")
    got = chain.run(N).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(want.ravel().tolist())) > 1        # not one token
    # the timing runs repeat the chain over the same pools
    np.testing.assert_array_equal(chain.run(N).numpy(), want)


NUM = r"([-+]?\d+(?:\.\d+)?)"


def test_script_runs_on_the_cpu(capsys):
    args = ["--device", "cpu", "--vocab-size", "64", "--dim", "64",
            "--layers", "2", "--heads", "4", "--kv-heads", "2",
            "--head-dim", "16", "--ffn-dim", "128", "--max-seq-len", "128",
            "--dtype", "float32", "--batch", "2", "--prompt-len", "32",
            "--page-size", "16", "--num-pages", "20", "--chain", "2",
            "--fuse", "1", "8", "--new-tokens", "8"]
    res = pda.main(args)
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "card: cpu"
    m = re.search(rf"device-only decode step \(chained x2, b2, 32 ctx\): "
                  rf"{NUM} ms device busy -> {NUM} tok/s; {NUM} ms wall",
                  out)
    assert m and all(math.isfinite(float(x)) and float(x) > 0
                     for x in m.groups()), out
    eng = [ln for ln in lines if ln.startswith("engine decode_fuse=")]
    assert len(eng) == 2
    for ln, r, fuse in zip(eng, res["engines"], (1, 8)):
        assert re.match(rf"engine decode_fuse=\s*{fuse}: \s*{NUM} tok/s "
                        rf"steady, \s*{NUM} ms/engine-step over \d+ steps "
                        rf"\(14 toks\); {NUM} ms/decode-step, host "
                        rf"{NUM} ms of it", ln), ln
        assert r["toks"] == 2 * (8 - 1)      # every token after the first
        assert r["decode_step_s"] * r["toks"] == pytest.approx(
            r["engine_step_s"] * r["steps"] * 2)
    assert lines[-1].startswith("floor check: params ")
