"""Device meshes over torch.distributed ranks, and their collectives.

The JAX package's (data, seq, model) mesh, as plain SPMD: one process a
shard, every rank running the same Python on its own local tensors, with
explicit collectives on one process group per mesh axis.  Axis convention:

  "data"  — batch (data parallel; no collective inside attention)
  "seq"   — KV / context sharding (the LSE merge of parallel/sharded.py)
  "model" — attention heads (tensor parallel; an all-reduce after the
            o-projection and the MLP's down projection)

An axis of size 1 has no process group, and its collectives are identities,
so a mesh whose axes are all 1 runs the same code in one process with no
process group at all.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


class Mesh:
    """A (data, seq, model) grid of the default process group's ranks.

    `shape` is {axis: size} (as the JAX Mesh's), `ranks` the grid of global
    ranks, `coords` this rank's {axis: index} (None for a rank outside the
    mesh, which a mesh smaller than the world leaves idle), `groups`
    {axis: the process group of this rank's line along the axis, or None
    for an axis of size 1}, `group` the process group of the whole mesh
    (None for a mesh of one rank)."""

    def __init__(self, ranks: np.ndarray, rank: int,
                 groups: Dict[str, Optional[dist.ProcessGroup]],
                 group: Optional[dist.ProcessGroup] = None):
        self.ranks = ranks
        self.shape = dict(zip(AXES, (int(n) for n in ranks.shape)))
        self.rank = rank
        where = np.argwhere(ranks == rank)
        self.coords = (dict(zip(AXES, (int(i) for i in where[0])))
                       if len(where) else None)
        self.groups = groups
        self.group = group

    @property
    def is_member(self) -> bool:
        return self.coords is not None

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(data: int = 1, seq: int = 1, model: int = 1) -> Mesh:
    """(data, seq, model) mesh over the first data * seq * model ranks of
    the default process group, model the fastest-varying axis.  Pass -1
    for one axis to absorb the rest of the world.  Every rank of the world
    must call it (new process groups are made collectively); with no
    process group initialized the world is this one process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    sizes = [data, seq, model]
    if -1 in sizes:
        i = sizes.index(-1)
        rest = int(np.prod([s for s in sizes if s != -1]))
        if world % rest:
            raise ValueError(f"mesh {sizes} does not divide {world} ranks")
        sizes[i] = world // rest
    if min(sizes) < 1:
        raise ValueError(f"mesh sizes must be positive, got {sizes}")
    total = int(np.prod(sizes))
    if total > world:
        raise ValueError(f"mesh {sizes} needs more than {world} ranks")
    ranks = np.arange(total).reshape(sizes)
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for ax, n in enumerate(sizes):
        groups[AXES[ax]] = None
        if n == 1:
            continue
        # every line of ranks along this axis, in one order on every rank
        for line in np.moveaxis(ranks, ax, -1).reshape(-1, n):
            g = dist.new_group(ranks=[int(r) for r in line])
            if rank in line:
                groups[AXES[ax]] = g
    group = None
    if total > 1:
        group = (dist.group.WORLD if total == world
                 else dist.new_group(ranks=list(range(total))))
    return Mesh(ranks, rank, groups, group)


Spec = Tuple[Optional[str], ...]


def attention_specs(mesh: Mesh, *, shard_kv_heads: bool,
                    seq_shard_kv: bool = False) -> Tuple[Spec, Spec]:
    """Which mesh axis shards each dimension of (B, M, H, D) attention
    tensors (None: replicated), the counterpart of the JAX PartitionSpecs:
    q's batch on "data" and heads on "model"; k/v's the same, their heads
    only with `shard_kv_heads` (else replicated, each rank's q heads
    inside one GQA group) and their sequence on "seq" with
    `seq_shard_kv`."""
    del mesh  # the specs name axes; sizes are the mesh's business
    q_spec = (DATA_AXIS, None, MODEL_AXIS, None)
    kv_spec = (DATA_AXIS, SEQ_AXIS if seq_shard_kv else None,
               MODEL_AXIS if shard_kv_heads else None, None)
    return q_spec, kv_spec


def local_shard(x: torch.Tensor, spec: Sequence[Optional[str]],
                mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global tensor `x` under `spec` (one axis
    name or None per dimension; trailing dimensions replicated): a view,
    so gradients flow back to `x`."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not "
                             f"divide the {axis!r} axis ({n})")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis) * step, step)
    return x


# ---- collectives on one mesh axis ----
# Each returns its input, reduced or broadcast in place; on an axis of size
# 1 they do nothing.

def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` (contiguous) reduced over the ranks of this rank's `axis` line."""
    g = mesh.groups[axis]
    if g is not None:
        dist.all_reduce(t, op=op, group=g)
    return t


def broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """`t` (contiguous) from the mesh's rank `src` (global ranks and mesh
    ranks agree: a mesh spans the world's first ranks) to every rank of
    the mesh."""
    if mesh.group is not None:
        dist.broadcast(t, src=src, group=mesh.group)
    return t
