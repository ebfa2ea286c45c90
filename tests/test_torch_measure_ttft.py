"""prof_ttft_tail (flash_attn_v100_tpu_torch/benchmarks/prof_ttft_tail.py)
on the CPU: its `run` makes the JAX package's ServingEngine's scheduler
decisions on the tiny fp32 model (weights carried across by
`params_from_jax`) for the staggered-admission set at a quarter of its
batch and prefill widths on a page-bound burst (6 requests of 32 tokens,
20 pages of 8: two waves): each burst's steps, prefill tokens and the
step of each request's first token (tests/torch_ttft_jax.py; the chunked
set is in test_torch_measure_ttft_chunked.py).  The script also runs at a
tiny size, its lines parsing."""

import math
import re

import torch
import torch_ttft_jax as tj

from flash_attn_v100_tpu_torch.benchmarks import prof_ttft_tail as tt

torch.set_num_threads(1)


def test_scheduler_decisions_match_jax_staggered():
    tj.check_set(tt, "mps8")


def test_script_runs_on_the_cpu(capsys):
    args = ["--device", "cpu", "--vocab-size", "64", "--dim", "64",
            "--layers", "2", "--heads", "4", "--kv-heads", "2",
            "--head-dim", "16", "--ffn-dim", "128", "--max-seq-len", "128",
            "--dtype", "float32", "--requests", "4", "--prompt-len", "32",
            "--new-tokens", "4", "--page-size", "16", "--configs",
            "baseline", "int8_290"]
    res = tt.main(args)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "card: cpu"
    tags = [tt.CONFIGS[k][0] for k in ("baseline", "int8_290")]
    assert [r["tag"] for r in res] == tags
    for tag, r in zip(tags, res):
        (ln,) = [x for x in lines if x.startswith(tag + ":")]
        m = re.fullmatch(r".*: p50 (\d+) ms  p90 (\d+) ms  e2e (\d+) tok/s",
                         ln)
        assert m, ln
        assert r["total"] == 4 * 4
        assert 0 <= r["p50_s"] <= r["p90_s"] and math.isfinite(r["e2e_tok_s"])
