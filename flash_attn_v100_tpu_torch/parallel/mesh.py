"""Device meshes over torch.distributed ranks, and their collectives.

The JAX package's (data, seq, model) mesh, as plain SPMD: one process a
shard, every rank running the same Python on its own local tensors, with
explicit collectives on one process group per mesh axis.  Axis convention:

  "data"  — batch (data parallel; no collective inside attention)
  "seq"   — KV / context sharding (the LSE merge of parallel/sharded.py,
            the ring's shifts and Ulysses' all-to-alls of parallel/ring.py)
  "model" — attention heads (tensor parallel; an all-reduce after the
            o-projection and the MLP's down projection)

An axis of size 1 has no process group, and its collectives are identities,
so a mesh whose axes are all 1 runs the same code in one process with no
process group at all.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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


# elements of one flat buffer of `all_reduce_flat` (256 MiB in fp32)
_BUCKET_NUMEL = 1 << 26


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh: Mesh,
                    axes: Sequence[str]) -> None:
    """Sum each of `tensors` in place over the ranks of this rank's plane
    of `axes`, through a few flat buffers of at most `_BUCKET_NUMEL`
    elements (one dtype and device each) rather than a collective a
    tensor."""
    axes = [ax for ax in axes if mesh.groups[ax] is not None]
    if not axes:
        return
    buckets: Dict[tuple, List[List[torch.Tensor]]] = {}
    for t in tensors:
        key = (t.dtype, t.device)
        runs = buckets.setdefault(key, [[]])
        if runs[-1] and (sum(x.numel() for x in runs[-1]) + t.numel()
                         > _BUCKET_NUMEL):
            runs.append([])
        runs[-1].append(t)
    for runs in buckets.values():
        for run in runs:
            flat = torch.cat([t.reshape(-1) for t in run])
            for ax in axes:
                all_reduce(flat, mesh, ax)
            for t, part in zip(run, flat.split([t.numel() for t in run])):
                t.copy_(part.view_as(t))


def _staged(t: torch.Tensor, g) -> bool:
    """gloo's point-to-point takes host buffers only (given a CUDA tensor,
    its TCP transport aborts the process: "writev ... Bad address", on an
    H100 with torch 2.11), so `ring_shift` stages CUDA tensors through the
    host for it; its all-reduce, broadcast and all-to-all take them as
    they are.  The kernels run on the card either way."""
    return t.is_cuda and dist.get_backend(g) == "gloo"


class _Shift:
    """A ring shift in flight; `wait()` returns the received tensors.  It
    holds the packed send buffer until then."""

    def __init__(self, works, sent, recv, shapes, device):
        self.works, self.sent, self.recv = works, sent, recv
        self.shapes, self.device = shapes, device

    def wait(self) -> List[torch.Tensor]:
        for w in self.works:
            w.wait()
        flat = self.recv.to(self.device)
        parts = flat.split([int(np.prod(s)) for s in self.shapes])
        return [p.view(s) for p, s in zip(parts, self.shapes)]


def ring_shift(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str,
               tag: int = 0) -> _Shift:
    """Start sending `tensors` (one dtype and device) to the next rank of
    this rank's `axis` line and receiving the previous rank's, as JAX's
    `ppermute` with perm [(i, (i + 1) % n)]: one message of the tensors
    packed together, sent and received by one `batch_isend_irecv`, so that
    neighbours never wait on each other.  The packed copy is what is in
    flight, so the caller may reuse `tensors` at once.  Returns a handle
    whose `wait()` gives the received tensors; an axis of size 1 returns
    them as they are."""
    shapes = [t.shape for t in tensors]
    dev = tensors[0].device
    g = mesh.groups[axis]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if g is None:
        return _Shift([], flat, flat, shapes, dev)
    if _staged(flat, g):
        flat = flat.cpu()
    line = np.moveaxis(mesh.ranks, AXES.index(axis), -1)[
        tuple(mesh.coords[a] for a in AXES if a != axis)]
    i, n = mesh.index(axis), len(line)
    recv = torch.empty_like(flat)
    ops = [dist.P2POp(dist.isend, flat, int(line[(i + 1) % n]), g, tag),
           dist.P2POp(dist.irecv, recv, int(line[(i - 1) % n]), g, tag)]
    return _Shift(dist.batch_isend_irecv(ops), flat, recv, shapes, dev)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """JAX's `all_to_all(x, axis, split_axis, concat_axis, tiled=True)`
    over this rank's `axis` line: `x` cut into n blocks along
    `split_axis`, block j sent to the line's rank j, the n blocks received
    joined along `concat_axis` in rank order.  Differentiable: its adjoint
    is the all-to-all with the two axes swapped.  Identity on an axis of
    size 1."""
    if mesh.groups[axis] is None:
        return x
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def _all_to_all(x, mesh, axis, split_axis, concat_axis):
    g = mesh.groups[axis]
    n = mesh.shape[axis]
    if x.shape[split_axis] % n:
        raise ValueError(f"dimension {split_axis} ({x.shape[split_axis]}) "
                         f"does not divide the {axis!r} axis ({n})")
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, dy):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_all_to_all(dy, mesh, axis, concat_axis, split_axis),
                None, None, None, None)


# ---- tensor parallelism (Megatron's pair) and sums with a gradient ----

class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over "model" in the backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.contiguous().clone(), ctx.mesh, MODEL_AXIS), None


class _ReduceFrom(torch.autograd.Function):
    """Sum over `axes` forward; the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        y = x.contiguous().clone()
        for ax in axes:
            all_reduce(y, mesh, ax)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Megatron's "copy to the model-parallel region": `x` as it is, its
    gradient summed over "model" (the input of a column-sharded
    projection, whose ranks each give a part of the gradient).  Identity
    without a mesh or a model axis."""
    if mesh is None or mesh.groups[MODEL_AXIS] is None:
        return x
    return _CopyTo.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]
                      ) -> torch.Tensor:
    """Megatron's "reduce from the model-parallel region": the sum over
    "model" of a row-sharded projection's partial outputs, its gradient
    passed to each rank as it is.  Identity without a mesh."""
    return x if mesh is None else reduce_sum(x, mesh, (MODEL_AXIS,))


def reduce_sum(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]
               ) -> torch.Tensor:
    """`x` summed over the ranks of this rank's plane of `axes`, with the
    gradient passed through: each rank's backward then gives its own part
    of the parameters' gradients (as for a loss summed over the "data" and
    "seq" shards of a batch)."""
    axes = tuple(ax for ax in axes if mesh.groups[ax] is not None)
    return _ReduceFrom.apply(x, mesh, axes) if axes else x
