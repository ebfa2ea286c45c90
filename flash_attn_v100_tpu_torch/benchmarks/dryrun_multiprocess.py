"""Multi-process dryrun: the multi-host code path (torch.distributed +
host-aware hybrid mesh) run as local processes.

The counterpart of the JAX repository's `benchmarks/dryrun_multiprocess.py`
on the port.  Launcher mode (no FA_PROCESS_ID in the env): spawns
`--procs` x `--local-ranks` processes of this script, by default 2 x 4 = 8
ranks as JAX's 2 processes of 4 local devices, each given FA_COORDINATOR,
FA_NUM_PROCESSES, FA_PROCESS_ID and LOCAL_WORLD_SIZE (the ranks of a
"host"); it collects each one's output and prints the JAX script's tail
lines and `dryrun_multiprocess: OK` or `FAILED`, exiting non-zero on any
failure.  Worker mode: `initialize()` (gloo where the processes cannot
have a card each), `make_hybrid_mesh(data=-1, seq=2, model=2)` (data
across the hosts, seq and model inside one), one `sgd_train_step(mesh=)`
whose loss must be finite and equal on every rank, then a
`ServingEngine(mesh=)` whose greedy tokens must equal a single-process
engine's on the same weights.

    python -m flash_attn_v100_tpu_torch.benchmarks.dryrun_multiprocess
        [--procs 2] [--local-ranks 4] [--device cpu]

`--weights FILE` (a torch.save of a ModelConfig.tiny-shaped parameter
dict, e.g. the JAX package's weights through `params_from_jax`) replaces
the training step's seeded weights.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

WORKER_TIMEOUT_S = 600.0
ENV_ARGS = "FA_DRYRUN_ARGS"


def tiny_config():
    """The JAX script's model: ModelConfig.tiny at 4/2 heads x 16, dim 64,
    2 layers, 64 positions (fp32)."""
    from flash_attn_v100_tpu_torch.models.transformer import ModelConfig
    return ModelConfig.tiny(n_heads=4, n_kv_heads=2, dim=64, head_dim=16,
                            ffn_dim=128, n_layers=2, max_seq_len=64)


def worker(device: str, weights: Optional[str]) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from flash_attn_v100_tpu_torch.parallel.distributed import (
        initialize, make_hybrid_mesh)
    # the process group first: every mesh and collective below needs it
    assert initialize(), "expected multi-process initialization"
    assert dist.get_world_size() > 1, "distributed init did not take effect"

    from flash_attn_v100_tpu_torch import ServingEngine
    from flash_attn_v100_tpu_torch.models.transformer import (
        init_params, sgd_train_step, shard_params)
    pid, n_procs = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    mesh = make_hybrid_mesh(data=-1, seq=2, model=2)
    assert mesh.shape["data"] == n_procs // 4, dict(mesh.shape)

    cfg = tiny_config()
    if weights:
        params = torch.load(weights, map_location=dev)
    else:
        params = init_params(cfg, seed=0, device=dev)    # PRNGKey(0)
    data_size = mesh.shape["data"]
    B, S = 2 * data_size, 32 * mesh.shape["seq"] + 1
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    loss, _ = sgd_train_step(shard_params(params, cfg, mesh), tokens, cfg,
                             lr=1e-2, mesh=mesh)
    loss = float(loss)
    assert np.isfinite(loss), loss
    losses = [None] * n_procs
    dist.all_gather_object(losses, loss)
    assert all(x == loss for x in losses), losses
    print(f"[proc {pid}/{n_procs}] hybrid mesh {dict(mesh.shape)} "
          f"loss={loss:.4f} — OK (step-1 loss {loss!r}, equal on every "
          f"rank)", flush=True)

    # ---- engine phase: cross-host continuous-batching decode parity ----
    # The same ServingEngine host loop runs SPMD on every rank over the
    # hybrid mesh (pages sharded on "seq", heads on "model", each "data"
    # slice a replica); its greedy tokens must match a single-process
    # engine's exactly.
    ecfg = tiny_config()
    eparams = init_params(ecfg, seed=1, device=dev)       # PRNGKey(1)
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1], [9, 9, 8]]

    ref_eng = ServingEngine(eparams, ecfg, max_batch=2, num_pages=16,
                            page_size=8, device=dev)
    ref_ids = [ref_eng.submit(p, max_new_tokens=6) for p in prompts]
    ref_out = ref_eng.run_to_completion()

    eng = ServingEngine(shard_params(eparams, ecfg, mesh), ecfg, max_batch=2,
                        num_pages=16, page_size=8, mesh=mesh, device=dev)
    assert eng.seq_shards == mesh.shape["seq"]
    ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    out = eng.run_to_completion()
    for r, m in zip(ref_ids, ids):
        assert ref_out[r] == out[m], (ref_out[r], out[m])
    assert all(eng.ttft(i) is not None for i in ids)
    print(f"[proc {pid}/{n_procs}] cross-host engine parity "
          f"({len(prompts)} reqs, greedy tokens identical) — OK", flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(procs: int, local_ranks: int, device: str = "cuda",
           weights: Optional[str] = None,
           timeout: float = WORKER_TIMEOUT_S) -> int:
    """Spawn procs x local_ranks workers and report; 0 when every one
    passed."""
    world = procs * local_ranks
    port = _free_port()
    children = []
    t0 = time.monotonic()
    for pid in range(world):
        env = dict(os.environ)
        env.update(
            FA_COORDINATOR=f"localhost:{port}",
            FA_NUM_PROCESSES=str(world),
            FA_PROCESS_ID=str(pid),
            LOCAL_WORLD_SIZE=str(local_ranks),
            OMP_NUM_THREADS="1",
        )
        env[ENV_ARGS] = f"{device}\n{weights or ''}"
        children.append(subprocess.Popen(
            [sys.executable, "-m",
             "flash_attn_v100_tpu_torch.benchmarks.dryrun_multiprocess"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    rc = 0
    for pid, c in enumerate(children):
        try:
            out, _ = c.communicate(
                timeout=max(1.0, timeout - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            c.kill()
            out, _ = c.communicate()
            out += f"\n(timed out after {timeout:.0f} s)"
        ok = (c.returncode == 0 and "— OK" in out
              and "engine parity" in out)
        tail = "\n".join(out.strip().splitlines()[-4:])
        print(f"--- proc {pid}: rc={c.returncode} ---\n{tail}")
        if not ok:
            rc = 1
    print(f"dryrun_multiprocess: {'OK' if rc == 0 else 'FAILED'} ({world} "
          f"ranks, {procs} hosts x {local_ranks}, {device}, "
          f"{time.monotonic() - t0:.1f} s)", flush=True)
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    if "FA_PROCESS_ID" in os.environ:
        device, weights = os.environ[ENV_ARGS].split("\n")
        worker(device, weights or None)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the ranks share the card "
                         "through gloo) or cpu (their plain versions)")
    ap.add_argument("--weights", default=None,
                    help="torch.save'd parameters for the training step")
    a = ap.parse_args(argv)
    if a.device != "cpu":
        from flash_attn_v100_tpu_torch.benchmarks.common import card_line
        print(f"backend={card_line()}", flush=True)
    return launch(a.procs, a.local_ranks, a.device, a.weights)


if __name__ == "__main__":
    sys.exit(main())
