"""The port's examples on the CPU with --device cpu at their own sizes:
attention_basics and serve_engine, their printed shapes and counts
(train_seq_parallel: tests/test_torch_example_ring.py)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _run(module: str, *args: str, timeout: float = 120):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=ENV, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("name, lines", [
    ("attention_basics", [
        "dense: (2, 256, 8, 64) grads: (2, 256, 8, 64) (2, 256, 4, 64) "
        "(2, 256, 4, 64)",
        "varlen: (436, 8, 64) -> (2, 256, 8, 64)",
        "decode: (2, 1, 8, 64) int8 pool bytes/token: 544"]),
    ("serve_engine", [
        "native C++ scheduler: True",
        "{0: 24, 1: 24, 2: 24, 3: 24, 4: 24, 5: 24} | metrics:"]),
])
def test_example_runs_on_the_cpu(name, lines):
    r = _run(f"flash_attn_v100_tpu_torch.examples.{name}", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    for line in lines:
        assert line in r.stdout, (line, r.stdout)
