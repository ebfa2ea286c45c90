"""The port's train_seq_parallel example on the CPU: 2 spawned gloo ranks
(--device cpu), ring attention in zigzag order with its gradients; the
mesh, the local output block and the global gradient's shape it prints."""

import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_train_seq_parallel_runs_on_two_cpu_ranks():
    r = subprocess.run(
        [sys.executable, "-m",
         "flash_attn_v100_tpu_torch.examples.train_seq_parallel", "--device",
         "cpu"], cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    for line in ("mesh: {'data': 1, 'seq': 2, 'model': 1} on 2 gloo ranks "
                 "(cpu)", "local out: (2, 512, 8, 64)",
                 "global dq: (2, 1024, 8, 64) finite: True"):
        assert line in r.stdout, (line, r.stdout)
