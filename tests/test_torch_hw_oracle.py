"""The port's fuzz (flash_attn_v100_tpu_torch/benchmarks/fuzz_oracle.py)
draws what the JAX repository's benchmarks/fuzz_oracle.py draws: both
scripts run with their three entry points, their oracles and their gate
replaced by recorders that return zeros, and every call's arguments
(configurations and input arrays, bit for bit) must be equal, for seeds
0-29 (trials 0-2 of each).  Then the smallest recorded dense trial (by
M N H D; varlen and kvcache in test_torch_hw_oracle_trials.py) runs
through both packages (the JAX one in interpret mode,
the port's plain versions, CPU): each package's output passes the
reference's gate (2 x the bf16 oracle's error + 1e-5) against the other
package's fp32 oracle.  The ported sweeps' case lists equal the JAX
scripts'."""

import ast
import inspect
from pathlib import Path

import pytest
import torch
import torch_fuzz_cases as fc

from flash_attn_v100_tpu_torch.benchmarks import sweep_dense as tdense
from flash_attn_v100_tpu_torch.benchmarks import sweep_varlen as tvarlen
from flash_attn_v100_tpu_torch.benchmarks import (
    verify_decode_fastpath as tverify)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEEDS = range(30)


@pytest.fixture(scope="module")
def recorded():
    return fc.record(SEEDS)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_draws_the_jax_scripts_configurations_and_inputs(recorded,
                                                              seed):
    jcalls, tcalls = recorded[seed]
    # each trial: the entry point, two oracles, the gate
    assert len(jcalls) == 4 * fc.TRIALS_PER_SEED
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    for j, (jc, tc) in enumerate(zip(jcalls, tcalls)):
        assert tc == jc, f"call {j} ({jc[0]}) differs"


def test_smallest_dense_trial_matches_across_packages(recorded,
                                                      monkeypatch):
    """(varlen and kvcache: test_torch_hw_oracle_trials.py)"""
    seed, i = fc.smallest_trial({s: c[0] for s, c in recorded.items()},
                                "dense")
    fc.check_trial_across_packages(monkeypatch, seed, i, "dense")


def test_sweep_case_lists_equal_the_jax_scripts():
    jdense, jvarlen = fc.load("sweep_dense"), fc.load("sweep_varlen")
    assert tdense.SHAPES == jdense.SHAPES and tdense.QUICK == jdense.QUICK
    assert tvarlen.CASES == jvarlen.CASES and tvarlen.QUICK == jvarlen.QUICK


def test_fastpath_case_list_equals_the_jax_scripts():
    """The JAX script runs its cases at import: read them from its source
    (`ok &= run_case("name", **kw)`) and run_case's defaults."""
    tree = ast.parse((ROOT / "benchmarks" /
                      "verify_decode_fastpath.py").read_text())
    cases = [(c.args[0].value, {k.arg: ast.literal_eval(k.value)
                                for k in c.keywords})
             for c in ast.walk(tree) if isinstance(c, ast.Call)
             and getattr(c.func, "id", None) == "run_case"]
    assert cases == tverify.CASES
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_case")
    want = {a.arg: ast.literal_eval(d) for a, d in
            zip(fn.args.kwonlyargs, fn.args.kw_defaults)}
    got = {k: p.default for k, p in
           inspect.signature(tverify.run_case).parameters.items()
           if k in want}
    assert got == want
