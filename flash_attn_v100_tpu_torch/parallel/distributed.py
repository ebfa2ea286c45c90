"""Multi-process entry points: process-group initialization and meshes that
keep "seq" and "model" inside one host.

Every process calls `initialize()` (env-driven; a no-op for one process)
before it builds a mesh.  Then `make_hybrid_mesh()` lays the "data" axis
across hosts (data parallelism needs no collective inside a step) and "seq"
and "model" inside a host, where the LSE merge and the tensor-parallel
all-reduces are cheap.  Everything downstream (the sharded attention, the
serving engine) is written against the mesh's axes and runs unchanged.

Env contract (the JAX package's):
  FA_COORDINATOR   host:port of process 0           (e.g. "10.0.0.2:1234")
  FA_NUM_PROCESSES total process count
  FA_PROCESS_ID    this process's index
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from flash_attn_v100_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None) -> bool:
    """Initialize the default process group from the arguments or the FA_*
    env (see the module docstring).  Returns True in multi-process mode,
    False for the single-process no-op.  Safe to call more than once.
    `backend` defaults to nccl when every process can have a card of its
    own, else gloo; with nccl each process takes card process_id %
    device_count."""
    coordinator_address = coordinator_address or os.environ.get(
        "FA_COORDINATOR")
    if num_processes is None and "FA_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["FA_NUM_PROCESSES"])
    if process_id is None and "FA_PROCESS_ID" in os.environ:
        process_id = int(os.environ["FA_PROCESS_ID"])
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's "
                         "address and this process's id")
    if backend is None:        # NCCL refuses two ranks on one device
        backend = ("nccl" if torch.cuda.is_available() and
                   torch.cuda.device_count() >= num_processes else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def make_hybrid_mesh(data: int = -1, seq: int = 1, model: int = 1, *,
                     ranks_per_host: Optional[int] = None) -> Mesh:
    """(data, seq, model) mesh with "data" across hosts and "seq" / "model"
    inside each host.  Ranks are numbered host by host, `ranks_per_host`
    a host (default: the LOCAL_WORLD_SIZE env, else the whole world, one
    host).  data = -1 absorbs the rest: seq * model must divide a host's
    ranks, and a host's leftover ranks extend the data axis."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if ranks_per_host is None:
        ranks_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % ranks_per_host:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{ranks_per_host}")
    if seq * model > ranks_per_host:
        raise ValueError(
            f"seq*model = {seq * model} exceeds the ranks of a host "
            f"({ranks_per_host}); 'seq' and 'model' must stay inside a host")
    if ranks_per_host % (seq * model):
        raise ValueError(f"seq*model = {seq * model} must divide the ranks "
                         f"of a host ({ranks_per_host})")
    full = world // (seq * model)
    if data == -1:
        data = full
    if data != full:
        raise ValueError(f"data = {data} must equal hosts * per-host "
                         f"remainder ({world // ranks_per_host} * "
                         f"{ranks_per_host // (seq * model)})")
    # model varies fastest, then seq: each (seq, model) block is
    # seq * model consecutive ranks, inside one host
    return make_mesh(data=data, seq=seq, model=model)
