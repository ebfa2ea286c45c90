"""The port's hardware oracle suite (flash_attn_v100_tpu_torch/benchmarks:
sweep_dense, sweep_varlen, sweep_decode, verify_decode_fastpath,
fuzz_oracle, hw_oracle) on the CPU, where the kernels' plain versions
run: each script's cases pass at their tiniest sizes; planted faults
fail their gates; and without a card the scripts refuse to run and print
no result.

A planted fault is the entry point's output scaled, in its own dtype.
The reference's tolerance model (2 x the bf16 oracle's error + 1e-5;
gradients 3 x + 1e-4) resolves about two bf16 units in the last place of
the largest output, 0.8-1.6% of it: an output scaled by 1.01 fails the
dense and varlen sweeps' forward and gradient gates at their cases here,
but sits inside that resolution at the decode sweep's and the fuzz's, where
1.05 fails every case held to the model; the fast-path cases' relative
gates (2.5%, 4% int8, 8% int4) fail at 1.1."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flash_attn_v100_tpu_torch.benchmarks import (
    fuzz_oracle, hw_oracle, sweep_decode, sweep_dense, sweep_varlen,
    verify_decode_fastpath)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL_VARLEN = dict(Hq=4, Hk=2, D=32)
SMALL_DECODE = dict(Hq=4, Hk=2, D=32, ps=64)
SMALL_FASTPATH = dict(N=512, Hq=4, Hk=2, D=32)


def _scaled(fn, by):
    """fn with its output (the first of a tuple) scaled by `by`."""
    def call(*args, **kw):
        out = fn(*args, **kw)
        if isinstance(out, tuple):
            return (out[0] * by,) + out[1:]
        return out * by
    return call


@pytest.mark.parametrize("shape", sweep_dense.SHAPES[:2],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [False, True])
def test_sweep_dense_tiniest_cases_pass(shape, causal):
    r = sweep_dense.run_case(np.random.default_rng(sweep_dense.SEED),
                             *shape, causal, torch.bfloat16, do_time=False,
                             device=CPU)
    assert r["fwd_ok"] and r["bwd_ok"], r


@pytest.mark.parametrize("causal", [False, True])
def test_sweep_dense_fp32_tiniest_case_passes_against_fp64(causal):
    """--dtype fp32: the oracle is fp64, the same-dtype one fp32."""
    r = sweep_dense.run_case(np.random.default_rng(sweep_dense.SEED),
                             *sweep_dense.SHAPES[1], causal, torch.float32,
                             do_time=False, device=CPU)
    assert r["fwd_ok"] and r["bwd_ok"], r
    assert 0.0 < r["fwd_err_native"] < 1e-5, r
    assert sweep_dense.over_gate(r) <= 1.0


def test_sweep_dense_fp32_gates_catch_a_scaled_output(monkeypatch):
    monkeypatch.setattr(sweep_dense, "flash_attn_func",
                        _scaled(sweep_dense.flash_attn_func, 1.001))
    r = sweep_dense.run_case(np.random.default_rng(sweep_dense.SEED),
                             1, 2, 128, 128, 64, True, torch.float32,
                             do_time=False, device=CPU)
    assert not r["fwd_ok"] and not r["bwd_ok"], r


def test_sweep_dense_gates_catch_a_scaled_output(monkeypatch):
    monkeypatch.setattr(sweep_dense, "flash_attn_func",
                        _scaled(sweep_dense.flash_attn_func, 1.01))
    r = sweep_dense.run_case(np.random.default_rng(sweep_dense.SEED),
                             1, 2, 128, 128, 64, True, torch.bfloat16,
                             do_time=False, device=CPU)
    assert not r["fwd_ok"] and not r["bwd_ok"], r


def test_sweep_varlen_tiniest_cases_pass():
    rng = np.random.default_rng(sweep_varlen.SEED)
    name, lens_q, lens_k, kw = sweep_varlen.CASES[3]      # cross-lens
    assert sweep_varlen.run_case(rng, name, lens_q, lens_k, kw,
                                 device=CPU, **SMALL_VARLEN)
    assert sweep_varlen.run_paged_case(
        rng, device=CPU, ps=128, lens_q=(37, 100), lens_k=(170, 100),
        **SMALL_VARLEN)


def test_sweep_varlen_gates_catch_a_scaled_output(monkeypatch):
    monkeypatch.setattr(sweep_varlen, "flash_attn_varlen_func",
                        _scaled(sweep_varlen.flash_attn_varlen_func, 1.01))
    rng = np.random.default_rng(sweep_varlen.SEED)
    name, lens_q, lens_k, kw = sweep_varlen.CASES[3]
    assert not sweep_varlen.run_case(rng, name, lens_q, lens_k, kw,
                                     device=CPU, **SMALL_VARLEN)
    assert not sweep_varlen.run_paged_case(
        rng, device=CPU, ps=128, lens_q=(37, 100), lens_k=(170, 100),
        **SMALL_VARLEN)


def test_sweep_decode_tiniest_cases_pass(capsys):
    assert sweep_decode.run_cases(np.random.default_rng(sweep_decode.SEED),
                                  256, device=CPU, **SMALL_DECODE) == 0
    assert "FAIL" not in capsys.readouterr().out


def test_sweep_decode_gates_catch_a_scaled_output(monkeypatch, capsys):
    """Every case held to the reference's model fails: the bf16 paged and
    contiguous ones (the quantized pools' flat 0.1 / 0.3 gates are
    coarser)."""
    monkeypatch.setattr(sweep_decode, "flash_attn_with_kvcache", _scaled(
        sweep_decode.flash_attn_with_kvcache, 1.05))
    sweep_decode.run_cases(np.random.default_rng(sweep_decode.SEED), 256,
                           device=CPU, **SMALL_DECODE)
    lines = capsys.readouterr().out.splitlines()
    failed = {ln.split(":")[0] for ln in lines if ln.startswith("FAIL")}
    assert {"FAIL decode paged+rotary+append 0k bf16",
            "FAIL decode contig T3 append", "FAIL decode contig leftpad",
            "FAIL decode contig window"} <= failed, lines


def test_fastpath_cases_pass_and_catch_a_scaled_output(monkeypatch):
    for name, kw in verify_decode_fastpath.CASES:
        assert verify_decode_fastpath.run_case(
            np.random.default_rng(verify_decode_fastpath.SEED), name,
            device=CPU, **dict(kw, **SMALL_FASTPATH)), name
    monkeypatch.setattr(verify_decode_fastpath, "flash_attn_with_kvcache",
                        _scaled(verify_decode_fastpath.flash_attn_with_kvcache,
                                1.1))
    for name, kw in verify_decode_fastpath.CASES:
        assert not verify_decode_fastpath.run_case(
            np.random.default_rng(verify_decode_fastpath.SEED), name,
            device=CPU, **dict(kw, **SMALL_FASTPATH)), name


def test_fuzz_passes_and_catches_a_scaled_output(monkeypatch):
    assert fuzz_oracle.main(6, 0, device="cpu") == 0
    for name in ("flash_attn_func", "flash_attn_varlen_func",
                 "flash_attn_with_kvcache"):
        monkeypatch.setattr(fuzz_oracle, name,
                            _scaled(getattr(fuzz_oracle, name), 1.05))
    assert fuzz_oracle.main(6, 0, device="cpu") == 6


@pytest.mark.parametrize("mod", [sweep_dense, sweep_varlen, sweep_decode,
                                 verify_decode_fastpath, fuzz_oracle,
                                 hw_oracle],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_scripts_refuse_to_run_without_a_card(mod, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()
    assert "PASS" not in capsys.readouterr().out


def test_hw_oracle_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run(
        [sys.executable, "-m", "flash_attn_v100_tpu_torch.benchmarks."
         "hw_oracle", "--quick"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "PASS" not in r.stdout
