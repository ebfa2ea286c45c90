"""Ring attention and Ulysses: sequence-parallel exact attention over the
ranks of one mesh axis.

The JAX package's flash_attn_v100_tpu/parallel/ring.py, run as plain SPMD:
every rank of a parallel/mesh.py Mesh holds one chunk of the sequence and
runs the same loop on it.  Ring attention rotates the K/V chunks around
the axis (`ring_shift`: point-to-point, neighbour to neighbour) while each
rank runs the dense forward (K1) on the chunk in front of it and folds the
chunk's (O, LSE) into its running pair; the merge is associative.

  * Streaming backward: a `torch.autograd.Function` saving only the
    rank-local (q, k, v, out, lse).  The backward runs a second ring pass:
    the dK/dV accumulators rotate with their chunk and are home after n
    shifts, dQ accumulates in place.  Each chunk's gradient is the dense
    backward (K2, K3) with the global LSE and delta = rowsum(O dO) of the
    final output.
  * Comm first: each step starts the next chunk's shift before this
    step's kernel and waits for it after.
  * The dense kernel's features on the "contiguous" layout: window,
    softcap, ALiBi and dropout, with each step's global offset (q_start -
    k_start of the pair); dropout replays the single-device Philox mask
    through global (row, col, batch, head) bases.  Chunks wholly outside
    the window launch nothing.
  * The "zigzag" layout balances causal work: rank i holds stripes (i,
    2n - 1 - i) of the sequence, and every step is half a chunk of work.
    Step 0 is local causal attention over the two stripes; from a chunk of
    a lower rank all local queries attend its first stripe; from a higher
    rank the second local stripe attends the whole chunk.  Causal only,
    with no window, ALiBi or dropout (softcap is fine).

The chunk from rank (my - s) mod n sits in front of rank `my` at step s,
so `my >= s` means it lies in the past: a branch on this rank's
coordinate, where JAX's `lax.cond` branches on `axis_index`.

`ulysses_attention` is the dual: one all-to-all turns the sequence-sharded
q/k/v into head-sharded full sequences, the unmodified dense attention
runs on the rank's heads, and a second all-to-all restores the sequence
sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda.bwd import flash_attn_dense_bwd
from flash_attn_v100_tpu_torch.ops.cuda.fwd import flash_attn_dense_fwd
from flash_attn_v100_tpu_torch.ops.flash_attention import (
    flash_attn_func, normalize_seed)
from flash_attn_v100_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, all_to_all, local_shard,
    ring_shift)

_KV_TAG, _GRAD_TAG = 0, 1


def _merge_pair(o_a, lse_a, o_b, lse_b):
    """Fold two normalized (O, lse) partials (lse shape (..., 1))."""
    m = torch.maximum(lse_a, lse_b)
    zero = torch.zeros_like(m)
    m_safe = torch.where(torch.isfinite(m), m, zero)
    wa = torch.where(torch.isfinite(lse_a), torch.exp(lse_a - m_safe), zero)
    wb = torch.where(torch.isfinite(lse_b), torch.exp(lse_b - m_safe), zero)
    wsum = wa + wb
    empty = wsum == 0.0
    safe = torch.where(empty, torch.ones_like(wsum), wsum)
    o = (o_a * wa + o_b * wb) / safe
    lse = torch.where(empty, torch.full_like(wsum, float("-inf")),
                      m_safe + torch.log(safe))
    return o, lse


@dataclasses.dataclass(frozen=True)
class _RingCfg:
    axis_name: str
    axis_size: int
    causal: bool
    softmax_scale: float
    window_left: int
    window_right: int
    softcap: float
    has_alibi: bool
    dropout_p: float
    layout: str            # "contiguous" | "zigzag"
    num_heads_total: int = 0

    def params(self, causal: bool) -> masklib.MaskParams:
        return masklib.MaskParams(
            causal=causal, window_left=self.window_left,
            window_right=self.window_right, softcap=self.softcap,
            has_alibi=self.has_alibi)

    @property
    def pos_features(self) -> bool:
        return (self.has_alibi or self.dropout_p > 0.0
                or self.window_left >= 0 or self.window_right >= 0)


def _step_plan(cfg: _RingCfg, s: int, c: int):
    """(past_offset, future_offset) of step s on the contiguous layout; an
    offset of None means that branch's chunk is fully masked (no launch).
    Offsets are the global q_start - k_start of the pair; fully visible
    chunks take ±c where the offset changes no mask or bias."""
    n = cfg.axis_size
    wl, wr = cfg.window_left, cfg.window_right
    wr_eff = 0 if cfg.causal else wr

    past = s * c
    if wl >= 0 and past > c - 1 + wl:
        past = None                      # entirely behind the window
    elif not (cfg.has_alibi or wl >= 0 or (wr >= 0 and not cfg.causal)):
        past = c

    fut_dist = (n - s) * c               # k_start - q_start of a future chunk
    if wr_eff >= 0 and fut_dist > c - 1 + wr_eff:
        future = None                    # causal, or beyond window_right
    else:
        future = (s - n) * c
        if not (cfg.has_alibi or wr >= 0 or wl >= 0):
            future = -c
    return past, future


def _contiguous_step(cfg: _RingCfg, my: int, s: int, c: int):
    """(offset, source rank) of the chunk in front of rank `my` at step s
    on the contiguous layout; an offset of None: no launch."""
    if s == 0:
        return 0, my
    past_off, fut_off = _step_plan(cfg, s, c)
    return ((past_off, my - s) if my >= s
            else (fut_off, my - s + cfg.axis_size))


def _chunk_fwd(cfg: _RingCfg, q, kb, vb, slopes, seed, offset, causal,
               pos_base):
    """K1 on one chunk -> (O fp32 (B, m, H, D), lse (B, m, H, 1))."""
    out, lse = flash_attn_dense_fwd(
        q, kb, vb, cfg.softmax_scale, cfg.params(causal),
        alibi_slopes=slopes, dropout_p=cfg.dropout_p, dropout_seed=seed,
        offset=offset, pos_base=pos_base,
        num_heads_total=cfg.num_heads_total or None)
    return out.to(torch.float32), lse.transpose(1, 2)[..., None]


def _chunk_bwd(cfg: _RingCfg, q, kb, vb, o, do, lse_bhm, slopes, seed,
               offset, causal, pos_base):
    """K2 and K3 on one chunk with the global LSE -> fp32 (dq, dk, dv)."""
    g = flash_attn_dense_bwd(
        q, kb, vb, o, do, lse_bhm, cfg.softmax_scale, cfg.params(causal),
        alibi_slopes=slopes, dropout_p=cfg.dropout_p, dropout_seed=seed,
        offset=offset, pos_base=pos_base,
        num_heads_total=cfg.num_heads_total or None)
    return tuple(x.to(torch.float32) for x in g)


def _empty_partial(q, v):
    shape = q.shape[:3]
    return (torch.zeros(shape + (v.shape[-1],), dtype=torch.float32,
                        device=q.device),
            torch.full(shape + (1,), float("-inf"), dtype=torch.float32,
                       device=q.device))


def _ring_fwd_loop(cfg: _RingCfg, mesh: Mesh, q, k, v, slopes, seed, b0,
                   h0):
    """The forward ring pass -> (o fp32 (B, m, H, D), lse (B, m, H, 1))."""
    n = cfg.axis_size
    my = mesh.index(cfg.axis_name)
    m, c = q.shape[1], k.shape[1]
    hs = m // 2
    o_acc, lse_acc = _empty_partial(q, v)
    k_blk, v_blk = k, v

    for s in range(n):
        if s < n - 1:   # comm first: the next chunk flies during this one
            shift = ring_shift((k_blk, v_blk), mesh, cfg.axis_name, _KV_TAG)
        new = None
        if cfg.layout == "zigzag":
            if s == 0:
                new = _chunk_fwd(cfg, q, k_blk, v_blk, slopes, seed, 0,
                                 cfg.causal, None)
            elif my >= s:           # a lower rank's chunk: its first stripe
                new = _chunk_fwd(cfg, q, k_blk[:, :hs], v_blk[:, :hs],
                                 slopes, seed, None, False, None)
            else:                   # a higher rank's: the 2nd local stripe
                o_h, lse_h = _chunk_fwd(cfg, q[:, hs:], k_blk, v_blk, slopes,
                                        seed, None, False, None)
                o_e, lse_e = _empty_partial(q[:, :hs], v_blk)
                new = (torch.cat([o_e, o_h], 1), torch.cat([lse_e, lse_h], 1))
        else:
            off, src = _contiguous_step(cfg, my, s, c)
            if off is not None:
                pos = ((my * m, src * c, b0, h0) if cfg.pos_features
                       else None)
                new = _chunk_fwd(cfg, q, k_blk, v_blk, slopes, seed, off,
                                 cfg.causal, pos)
        if new is not None:
            o_acc, lse_acc = _merge_pair(o_acc, lse_acc, *new)
        if s < n - 1:
            k_blk, v_blk = shift.wait()
    return o_acc, lse_acc


def _ring_bwd_loop(cfg: _RingCfg, mesh: Mesh, q, k, v, o, lse, do, slopes,
                   seed, b0, h0):
    """The backward ring pass (streaming): the dK/dV accumulators rotate
    with their chunk; after n shifts every chunk's gradients are home."""
    n = cfg.axis_size
    my = mesh.index(cfg.axis_name)
    m, c = q.shape[1], k.shape[1]
    hs = m // 2
    lse_bhm = lse[..., 0].transpose(1, 2).contiguous()      # (B, H, m)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_rot = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_rot = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_blk, v_blk = k, v

    for s in range(n):
        if s < n - 1:
            shift = ring_shift((k_blk, v_blk), mesh, cfg.axis_name, _KV_TAG)
        g = None
        if cfg.layout == "zigzag":
            if s == 0:
                g = _chunk_bwd(cfg, q, k_blk, v_blk, o, do, lse_bhm, slopes,
                               seed, 0, cfg.causal, None)
            elif my >= s:
                dq_f, dk_h, dv_h = _chunk_bwd(
                    cfg, q, k_blk[:, :hs], v_blk[:, :hs], o, do, lse_bhm,
                    slopes, seed, None, False, None)
                z = torch.zeros_like(dk_h)
                g = (dq_f, torch.cat([dk_h, z], 1), torch.cat([dv_h, z], 1))
            else:
                dq_h, dk_f, dv_f = _chunk_bwd(
                    cfg, q[:, hs:], k_blk, v_blk, o[:, hs:], do[:, hs:],
                    lse_bhm[:, :, hs:], slopes, seed, None, False, None)
                g = (torch.cat([torch.zeros_like(dq_h), dq_h], 1), dk_f,
                     dv_f)
        else:
            off, src = _contiguous_step(cfg, my, s, c)
            if off is not None:
                pos = ((my * m, src * c, b0, h0) if cfg.pos_features
                       else None)
                g = _chunk_bwd(cfg, q, k_blk, v_blk, o, do, lse_bhm, slopes,
                               seed, off, cfg.causal, pos)
        if g is not None:
            dq = dq + g[0]
            dk_rot = dk_rot + g[1]
            dv_rot = dv_rot + g[2]
        # the accumulators rotate on every step (n in all) to land home
        dk_rot, dv_rot = ring_shift((dk_rot, dv_rot), mesh, cfg.axis_name,
                                    _GRAD_TAG).wait()
        if s < n - 1:
            k_blk, v_blk = shift.wait()
    return dq.to(q.dtype), dk_rot.to(k.dtype), dv_rot.to(v.dtype)


class _RingCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, slopes, seed, cfg, mesh, b0, h0):
        o, lse = _ring_fwd_loop(cfg, mesh, q, k, v, slopes, seed, b0, h0)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse, slopes, seed)
        ctx.args = (cfg, mesh, b0, h0)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, slopes, seed = ctx.saved_tensors
        cfg, mesh, b0, h0 = ctx.args
        dq, dk, dv = _ring_bwd_loop(cfg, mesh, q, k, v, out, lse,
                                    dout.contiguous(), slopes, seed, b0, h0)
        return dq, dk, dv, None, None, None, None, None, None


def ring_attention_local(
    q: torch.Tensor,   # this rank's chunk (B, m, H_local, D)
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,   # (B, H_local) fp32
    dropout_p: float = 0.0,
    dropout_seed=None,                             # (2,) (lo, hi) words
    batch_offset: int = 0,   # global index of local batch row 0 (dropout)
    head_offset: int = 0,    # global index of local head 0 (dropout)
    layout: str = "contiguous",
    num_heads_total: Optional[int] = None,
) -> torch.Tensor:
    """The ring loop on this rank's chunks, for a caller whose sequence
    is already sharded over `axis_name` (a model's sharded train step).
    Differentiable, with the streaming backward."""
    if q.shape[1] != k.shape[1]:
        raise ValueError("ring attention needs equal q/kv chunk lengths per "
                         f"chip; got {q.shape[1]} vs {k.shape[1]}")
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if layout == "zigzag":
        if not causal:
            raise ValueError("zigzag layout is for causal attention")
        if (tuple(window_size) != (-1, -1) or alibi_slopes is not None
                or dropout_p > 0.0):
            raise ValueError(
                "zigzag layout does not support window/alibi/dropout (their "
                "positions are not contiguous per chip); use "
                "layout='contiguous'")
        if q.shape[1] % 2:
            raise ValueError("zigzag needs an even per-chip chunk length")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 needs dropout_seed")

    cfg = _RingCfg(
        axis_name=axis_name, axis_size=mesh.shape[axis_name],
        causal=bool(causal),
        softmax_scale=(q.shape[-1] ** -0.5 if softmax_scale is None
                       else float(softmax_scale)),
        window_left=int(window_size[0]), window_right=int(window_size[1]),
        softcap=float(softcap), has_alibi=alibi_slopes is not None,
        dropout_p=float(dropout_p), layout=layout,
        num_heads_total=int(num_heads_total or q.shape[2]))
    seed = normalize_seed(dropout_p, dropout_seed)
    slopes = (None if alibi_slopes is None
              else torch.as_tensor(alibi_slopes).to(q.device, torch.float32))
    return _RingCore.apply(q, k, v, slopes, seed, cfg, mesh,
                           int(batch_offset), int(head_offset))


def zigzag_order(n: int):
    """Stripe permutation for zigzag sharding: rank i holds stripes
    (i, 2n-1-i) of the 2n equal stripes of the global sequence."""
    return [s for i in range(n) for s in (i, 2 * n - 1 - i)]


def zigzag_shard(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Reorder a GLOBAL sequence axis so that a contiguous n-way sharding
    yields the zigzag layout (rank i gets stripes i and 2n-1-i)."""
    L = x.shape[axis]
    if L % (2 * n):
        raise ValueError(f"seq len {L} not divisible by 2*{n}")
    hs = L // (2 * n)
    return torch.cat([x.narrow(axis, s * hs, hs) for s in zigzag_order(n)],
                     dim=axis)


def zigzag_unshard(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Inverse of zigzag_shard."""
    hs = x.shape[axis] // (2 * n)
    inv = [0] * (2 * n)
    for pos, s in enumerate(zigzag_order(n)):
        inv[s] = pos
    return torch.cat([x.narrow(axis, p * hs, hs) for p in inv], dim=axis)


_PARTITION = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS, None)


def ring_attention(
    q: torch.Tensor,   # (B, M, Hq, D): M the GLOBAL sequence length
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,         # (Hq,) or (B, Hq) fp32, global heads
    dropout_p: float = 0.0,
    dropout_seed=None,
    layout: str = "contiguous",
    axis_name: str = SEQ_AXIS,
    q_partition: Sequence[Optional[str]] = _PARTITION,
    kv_partition: Sequence[Optional[str]] = _PARTITION,
) -> torch.Tensor:
    """Exact attention with Q and KV sharded along the sequence axis.

    q, k, v are the global tensors, as every rank holds them; each rank
    attends with its block under `q_partition` / `kv_partition` (batch on
    "data", sequence on `axis_name`, heads on "model") and returns that
    block of the output.  The blocks are views of the inputs, so gradients
    reach them.  Causal, window, softcap, ALiBi and dropout on the
    contiguous layout; layout="zigzag" balances causal work over the ring
    (inputs in zigzag stripe order: `zigzag_shard`)."""
    n = mesh.shape[axis_name]
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(
            f"ring_attention needs seq len divisible by the '{axis_name}' "
            f"axis ({n}); got q {q.shape[1]}, kv {k.shape[1]} — pad the "
            f"sequence (zero padding is safe under causal=True)")
    data_ax, model_ax = q_partition[0], q_partition[2]
    B_l = q.shape[0] // (mesh.shape[data_ax] if data_ax else 1)
    H_l = q.shape[2] // (mesh.shape[model_ax] if model_ax else 1)
    b0 = mesh.index(data_ax) * B_l if data_ax else 0
    h0 = mesh.index(model_ax) * H_l if model_ax else 0
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes).to(q.device, torch.float32)
        if slopes.dim() == 1:
            slopes = slopes[None].expand(q.shape[0], q.shape[2])
        slopes = local_shard(slopes, (data_ax, model_ax), mesh)
    ql = local_shard(q, q_partition, mesh)
    kl, vl = (local_shard(x, kv_partition, mesh) for x in (k, v))
    return ring_attention_local(
        ql, kl, vl, mesh=mesh, axis_name=axis_name, causal=causal,
        softmax_scale=softmax_scale, window_size=window_size,
        softcap=softcap, alibi_slopes=slopes, dropout_p=dropout_p,
        dropout_seed=dropout_seed, batch_offset=b0, head_offset=h0,
        layout=layout, num_heads_total=q.shape[2])


_ULYSSES_PARTITION = (DATA_AXIS, SEQ_AXIS, None, None)


def ulysses_attention(
    q: torch.Tensor,   # (B, M, Hq, D): M global, sharded on `axis_name`
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis_name: str = SEQ_AXIS,
    q_partition: Sequence[Optional[str]] = _ULYSSES_PARTITION,
    kv_partition: Sequence[Optional[str]] = _ULYSSES_PARTITION,
    **flash_kwargs,
) -> torch.Tensor:
    """Ulysses sequence parallelism, the dual of ring attention: an
    all-to-all re-shards this rank's sequence block (all heads) into the
    full sequence of H / n heads, `flash_attn_func` runs on them with
    `flash_kwargs` (K1, and K2/K3 through autograd; its head ids are the
    rank's local ones, so dropout is keyed by them), and a second
    all-to-all restores the sequence sharding.  Global tensors in, this
    rank's block out, as `ring_attention`.  Two collectives in all, every
    dense feature works, but each rank holds the full K/V sequence of its
    heads.  The q and kv heads must divide the axis."""
    n = mesh.shape[axis_name]
    Hq = q.shape[2]
    if Hq % n:
        raise ValueError(f"ulysses needs q heads ({Hq}) divisible by the "
                         f"'{axis_name}' axis ({n}); use ring_attention")
    if k.shape[2] % n:
        raise ValueError(f"ulysses needs kv heads ({k.shape[2]}) divisible "
                         f"by the '{axis_name}' axis ({n})")
    ql = local_shard(q, q_partition, mesh)
    kl, vl = (local_shard(x, kv_partition, mesh) for x in (k, v))
    # (B, m, H, D) -> (B, M, H/n, D): scatter heads, gather the sequence
    ql, kl, vl = (all_to_all(x, mesh, axis_name, 2, 1) for x in (ql, kl, vl))
    out = flash_attn_func(ql, kl, vl, **flash_kwargs)
    if isinstance(out, tuple):
        out = out[0]
    # (B, M, H/n, D) -> (B, m, H, D)
    return all_to_all(out, mesh, axis_name, 1, 2)
