"""bench_scaling (flash_attn_v100_tpu_torch/benchmarks/bench_scaling.py) on
2 spawned gloo CPU ranks (`--device cpu`, the kernels' plain versions):
the weak-scaled ring prefill and the head-sharded decode run at n = 1
and 2, and at n = 2 each equals the one-rank output on the same inputs
within the reference's forward gate (2 x the bf16 oracle's error against
the fp32 oracle + 1e-5); the lines print the JAX script's numbers and say
that they measure gloo."""

import math
import re

import torch

from flash_attn_v100_tpu_torch.benchmarks import bench_scaling as bs

torch.set_num_threads(1)


def test_two_cpu_ranks(capsys):
    res = bs.main(["--device", "cpu", "--devices", "2", "--seq-per-chip",
                   "64", "--ctx", "256"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["card: cpu", "backend=gloo cards=0 devices=2"]
    assert res["sizes"] == [1, 2]
    assert sorted(res["ring"]) == sorted(res["decode"]) == [1, 2]
    for name in ("ring", "decode"):
        c = res["checks"][name]
        assert c["ok"] and c["err"] <= c["gate"], (name, c)
        assert 0 < c["gate"] < 0.1, (name, c)   # a bf16 gate, not a blank
    ring = [ln for ln in lines if re.match(r"  n=\d: .* ms  eff=", ln)]
    dec = [ln for ln in lines if re.match(r"  n=\d: .* us  speedup=", ln)]
    assert len(ring) == len(dec) == 2
    for ln in ring + dec:
        assert ln.endswith("(gloo on the CPU)")
        assert all(math.isfinite(float(x))
                   for x in re.findall(r"\d+\.\d+", ln))
    assert [ln for ln in lines if ln.startswith("n=2 vs n=1")] == [
        f"n=2 vs n=1 ({n}): max |diff| {res['checks'][n]['err']:.3e} <= "
        f"gate {res['checks'][n]['gate']:.3e}: OK" for n in ("ring",
                                                            "decode")]
