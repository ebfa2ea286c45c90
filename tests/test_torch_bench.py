"""The port's bench (flash_attn_v100_tpu_torch/bench.py): its shapes
against the JAX package's root bench.py, and the bench and a probe script
refusing to run without a card (no result printed)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from flash_attn_v100_tpu_torch import bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _run(module: str, timeout: float = 60):
    return subprocess.run([sys.executable, "-m", module], cwd=ROOT,
                          env=dict(os.environ, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=timeout)


def test_bench_shapes_are_the_jax_bench_headline_shapes():
    """bench.py:71-78 of the JAX package: B, M, Hq, Hk, D = 4, 4096, 32, 8,
    128, causal."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    shapes = [n for n in ast.walk(main) if isinstance(n, ast.Assign)
              and isinstance(n.targets[0], ast.Tuple)
              and [getattr(t, "id", None) for t in n.targets[0].elts]
              == ["B", "M", "Hq", "Hk", "D"]]
    want = tuple(ast.literal_eval(shapes[0].value))
    assert want == (4, 4096, 32, 8, 128)
    assert (bench.B, bench.M, bench.HQ, bench.HK, bench.D) == want
    assert (bench.DEC_B, bench.DEC_CTX, bench.DEC_PS) == (8, 32768, 512)
    assert (bench.PLEN, bench.NREQ, bench.NEW) == (2048, 24, 64)
    assert (bench.SERVE_CFG["n_layers"], bench.SERVE_CFG["dim"]) == (16, 4096)


@pytest.mark.parametrize("module", [
    "flash_attn_v100_tpu_torch.bench",
    "flash_attn_v100_tpu_torch.benchmarks.prof_fwd_gap"])
def test_measurements_refuse_to_run_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(module)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "TFLOP/s" not in r.stdout and "us/step" not in r.stdout
