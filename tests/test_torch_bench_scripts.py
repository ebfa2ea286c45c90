"""The port's serving, decode and LoRA bench scripts
(flash_attn_v100_tpu_torch/benchmarks/bench_serving.py, bench_decode.py,
bench_lora_sft.py) on the CPU at a tiny size (`--device cpu`: the kernels'
plain versions): each reaches its end with finite numbers and consistent
counts (bench_serving: tokens generated = requests x gen-len, TTFT p50 <=
p99; bench_decode: the JAX script's byte count; bench_lora_sft: the steps
taken).  Their flags and defaults are the JAX repository's scripts' of the
same names, read from both files' argparse calls, but for the documented
changes: `--device` added, bench_decode's `--hbm-peak-gbps` 3350 (the H100
SXM) in place of 819 (v5e), and the dryrun's `--local-devices` (virtual
CPU devices a process) become `--local-ranks` (ranks a host) and gain
`--weights`."""

import math
import re

import pytest
import torch
from torch_script_flags import JAX, PORT
from torch_script_flags import flags as _flags

from flash_attn_v100_tpu_torch.benchmarks import (
    bench_decode, bench_lora_sft, bench_serving)

torch.set_num_threads(1)


CHANGED = {
    "bench_serving": ({"--device": (None, "cuda")}, {}),
    "bench_decode": ({"--device": (None, "cuda"),
                      "--hbm-peak-gbps": ("float", 3350.0)},
                     {"--hbm-peak-gbps": ("float", 819.0)}),
    "bench_lora_sft": ({"--device": (None, "cuda")}, {}),
    "dryrun_multiprocess": ({"--device": (None, "cuda"),
                             "--local-ranks": ("int", 4),
                             "--weights": (None, None)},
                            {"--local-devices": ("int", 4)}),
}


@pytest.mark.parametrize("name", list(CHANGED))
def test_flags_and_defaults_are_the_jax_scripts(name):
    port = _flags(PORT / f"{name}.py")
    jax_side = _flags(JAX / f"{name}.py")
    added, replaced = CHANGED[name]
    want = {k: v for k, v in jax_side.items() if k not in replaced}
    want.update(added)
    assert port == want


def _numbers(line: str):
    return [float(x) for x in re.findall(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?",
                                         line)]


def test_bench_serving_tiny(capsys):
    args = ["--device", "cpu", "--dim", "64", "--layers", "2", "--heads",
            "4", "--kv-heads", "2", "--head-dim", "16", "--requests", "3",
            "--max-batch", "2", "--prompt-len", "20", "--gen-len", "4",
            "--max-seq", "128", "--page-size", "16"]
    res = bench_serving.main(args)
    out = capsys.readouterr().out
    assert res["total_new"] == 3 * 4
    assert 0 < res["dec_toks"] <= res["total_new"]
    assert 0 <= res["ttft_p50_s"] <= res["ttft_p99_s"]
    for key in ("decode_tok_s", "e2e_tok_s", "ttft_p50_s", "ttft_p99_s"):
        assert math.isfinite(res[key]) and res[key] >= 0, (key, res)
    # the CPU runs the plain versions: no kernel launch is counted
    assert res["launches"] == {"K4": 0, "K8": 0}
    lines = out.splitlines()
    assert lines[0].startswith("backend=cpu native_sched=")
    assert "requests=3 prompt=20 gen=4 batch<=2" in lines
    assert any(ln.startswith("decode: ") and "tok/s/chip steady" in ln
               for ln in lines), out
    ttft = [ln for ln in lines if ln.startswith("TTFT p50=")]
    assert ttft and "preemptions=" in ttft[0], out


def test_bench_decode_tiny(capsys):
    args = ["--device", "cpu", "--ctx", "256", "512", "--batch", "2",
            "--heads", "4", "--kv-heads", "2", "--head-dim", "32",
            "--page-size", "128"]
    rows = bench_decode.main(args)
    out = capsys.readouterr().out
    assert [(r["ctx"], r["kv"]) for r in rows] == [
        (256, "bf16"), (256, "int8"), (512, "bf16"), (512, "int8")]
    B, Hk, D = 2, 2, 32
    for r in rows:
        ctx = r["ctx"]
        # benchmarks/bench_decode.py's count: int8 payload + fp32 scales,
        # or bf16 payload, of K and V
        want = (2 * B * ctx * Hk * D * 1 + 2 * B * ctx * Hk * 4
                if r["kv"] == "int8" else 2 * B * ctx * Hk * D * 2)
        assert r["nbytes"] == want
        assert r["seconds"] > 0 and math.isfinite(r["gbps"])
        assert r["gbps"] == pytest.approx(want / r["seconds"] / 1e9)
    lines = out.splitlines()
    assert lines[0] == "backend=cpu hbm_peak_gbps=3350 B=2 Hq=4 Hk=2 D=32"
    assert len([ln for ln in lines if "% of roofline)" in ln]) == 4


def test_bench_lora_sft_tiny(capsys):
    args = ["--device", "cpu", "--steps", "2", "--seq", "32", "--dim", "256",
            "--layers", "2", "--rank", "4"]
    res = bench_lora_sft.main(args)
    out = capsys.readouterr().out
    assert res["steps"] == 2
    assert res["ms_per_step"] > 0 and res["tok_s"] > 0
    assert math.isfinite(res["first_loss"]) and math.isfinite(
        res["final_loss"])
    assert res["tok_s"] == pytest.approx(32 / (res["ms_per_step"] / 1e3))
    lines = out.splitlines()
    assert re.match(r"backend=cpu base=\d+M lora=\d+\.\d\dM \(r=4\) seq=32",
                    lines[0]), out
    last = [ln for ln in lines if ln.startswith("2 steps: ")]
    assert last and "ms/step" in last[0] and "final loss" in last[0], out
    assert _numbers(last[0])[-1] == pytest.approx(res["final_loss"],
                                                  abs=1e-4)


def test_bench_scripts_refuse_to_run_without_a_card():
    """Their default device is the card: without one they raise, as the
    port's entry points do."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in (bench_serving, bench_decode, bench_lora_sft):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
