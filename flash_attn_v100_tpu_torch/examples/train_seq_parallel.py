"""Long-context attention training step: ring attention over the "seq" axis
of spawned gloo ranks, the port's counterpart of the JAX package's
examples/train_seq_parallel.py.

    python -m flash_attn_v100_tpu_torch.examples.train_seq_parallel
    python -m flash_attn_v100_tpu_torch.examples.train_seq_parallel \\
        --ranks 4 --device cpu

Spawns `--ranks` processes (2 by default) joined by gloo over
tcp://localhost on a free port; every rank holds the global q, k, v in
zigzag stripe order (`zigzag_shard`: rank i the stripes i and 2n - 1 - i,
which balances causal work), attends with its block through
`ring_attention(layout="zigzag")` (K1 forward, K2/K3 backward on the GPU;
K/V blocks passed around the ring, staged through the host on gloo) and
takes the gradients of a mean-square loss.  On one card every rank uses
it.
"""

from __future__ import annotations

import argparse
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from flash_attn_v100_tpu_torch.config import resolve_device
from flash_attn_v100_tpu_torch.parallel.mesh import all_reduce, make_mesh
from flash_attn_v100_tpu_torch.parallel.ring import (
    ring_attention, zigzag_shard, zigzag_unshard)

ROWS_PER_RANK = 512


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, device: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        mesh = make_mesh(data=1, seq=-1, model=1)   # every rank on "seq"
        n = mesh.shape["seq"]
        if rank == 0:
            print(f"mesh: {mesh.shape} on {world} gloo ranks ({dev.type})",
                  flush=True)
        # M is the GLOBAL sequence length
        B, M, Hq, Hk, D = 2, ROWS_PER_RANK * n, 8, 8, 64
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, M, h, D), dtype=np.float32)).to(dev, torch.bfloat16)
            for h in (Hq, Hk, Hk))
        q_z, k_z, v_z = (zigzag_shard(t, n).requires_grad_()
                         for t in (q, k, v))
        o = ring_attention(q_z, k_z, v_z, mesh, causal=True, layout="zigzag")
        # this rank's part of the global mean of o^2
        loss = (o.float() ** 2).sum() / (B * M * Hq * D)
        dq, dk, dv = torch.autograd.grad(loss, (q_z, k_z, v_z))
        total = all_reduce(loss.detach().reshape(1), mesh, "seq")
        # each rank's gradient reaches its own block and the K/V blocks it
        # saw: the sum over ranks is the gradient of the global loss
        dq_global = zigzag_unshard(all_reduce(dq.contiguous(), mesh, "seq"), n)
        finite = bool(torch.isfinite(dq_global.float()).all())
        if rank == 0:
            print(f"loss: {float(total):.6f} local out: {tuple(o.shape)}",
                  flush=True)
            print(f"global dq: {tuple(dq_global.shape)} finite: {finite}",
                  flush=True)
        if not finite:
            raise RuntimeError("train_seq_parallel: non-finite gradient")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)     # no card for "cuda": fail before spawning
    mp.spawn(_rank, args=(args.ranks, _free_port(), args.device),
             nprocs=args.ranks, join=True)


if __name__ == "__main__":
    main()
