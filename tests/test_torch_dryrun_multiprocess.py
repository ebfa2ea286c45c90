"""The port's multi-process dryrun
(flash_attn_v100_tpu_torch/benchmarks/dryrun_multiprocess.py) at 8 gloo
CPU ranks, 2 "hosts" x 4: its launcher exits 0 and prints
`dryrun_multiprocess: OK`, every rank prints its training-step and engine
parity OK lines, and the step-1 loss, equal on every rank, is within 1e-5
of the JAX package's jitted sgd_train_step(mesh=) on the same weights (the
JAX package's init_params(PRNGKey(0)), carried over by params_from_jax)
and tokens on the (2, 2, 2) mesh of its 8 virtual CPU devices.  The
launcher runs while JAX computes."""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.models import transformer as jt
from flash_attn_v100_tpu.parallel.mesh import make_mesh as jax_mesh
from flash_attn_v100_tpu_torch.benchmarks.dryrun_multiprocess import (
    tiny_config)
from flash_attn_v100_tpu_torch.models.transformer import params_from_jax

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
LOSS_ATOL = 1e-5


def _jax_loss(params, cfg):
    """JAX's sgd_train_step loss on the (2, 2, 2) mesh, the dryrun's
    tokens (B 2 x data, 32 x seq + 1)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax_mesh(data=2, seq=2, model=2)
    placed = jax.device_put(params, jt.param_shardings(params, cfg, mesh))
    B, S = 2 * mesh.shape["data"], 32 * mesh.shape["seq"] + 1
    tokens = jax.device_put(
        jnp.asarray(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S)), jnp.int32),
        NamedSharding(mesh, P("data", None)))
    step = jax.jit(lambda p, t: jt.sgd_train_step(p, t, cfg, lr=1e-2,
                                                  mesh=mesh, interpret=True))
    return float(step(placed, tokens)[0])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    c = tiny_config()
    jcfg = jt.ModelConfig.tiny(n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
                               dim=c.dim, head_dim=c.head_dim,
                               ffn_dim=c.ffn_dim, n_layers=c.n_layers,
                               max_seq_len=c.max_seq_len)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    weights = tmp_path_factory.mktemp("dryrun") / "params.pt"
    torch.save(params_from_jax(jax.device_get(jparams), device="cpu"),
               weights)
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "flash_attn_v100_tpu_torch.benchmarks.dryrun_multiprocess",
         "--device", "cpu", "--weights", str(weights)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref = _jax_loss(jparams, jcfg)
    out, _ = proc.communicate(timeout=300)
    return proc.returncode, out, ref


def test_launcher_reports_ok(run):
    rc, out, _ = run
    assert rc == 0, out
    assert re.search(r"^dryrun_multiprocess: OK \(8 ranks, 2 hosts x 4",
                     out, re.M), out


def test_every_rank_prints_its_ok_lines(run):
    _, out, _ = run
    for pid in range(WORLD):
        assert f"--- proc {pid}: rc=0 ---" in out, out
        assert re.search(rf"^\[proc {pid}/{WORLD}\] hybrid mesh "
                         r"\{'data': 2, 'seq': 2, 'model': 2\} loss=\S+ — OK",
                         out, re.M), out
        assert (f"[proc {pid}/{WORLD}] cross-host engine parity (3 reqs, "
                f"greedy tokens identical) — OK") in out, out


def test_step_one_loss_matches_jax_on_every_rank(run):
    _, out, ref = run
    losses = [float(x) for x in re.findall(r"step-1 loss (\S+), equal", out)]
    assert len(losses) == WORLD, out
    assert len(set(losses)) == 1, losses
    assert abs(losses[0] - ref) <= LOSS_ATOL, (losses[0], ref)
