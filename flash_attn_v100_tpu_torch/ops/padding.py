"""Padded <-> packed (varlen) conversion, the six helpers of
flash_attn_v100_tpu/ops/padding.py (the upstream `bert_padding.py`).

The gather and the scatter are `torch.autograd.Function`s, as upstream has
them: the gather's backward is a zero-filled scatter (an index_add, so a
repeated index sums, as JAX's `take` VJP does), the scatter's backward a
gather, and `index_first_axis_residual`'s backward adds the gathered rows'
cotangent into the residual's.  `unpad_input` syncs with the host once
(`nonzero` and the max length), as upstream's `.item()` does; the index
tensors it returns are int64, `cu_seqlens` int32, both on the data's
device, and `max_seqlen` a Python int.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


class _IndexFirstAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, indices):
        ctx.save_for_backward(indices)
        ctx.first_axis_dim = x.shape[0]
        return x.index_select(0, indices)

    @staticmethod
    def backward(ctx, grad):
        (indices,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.first_axis_dim,) + grad.shape[1:])
        return out.index_add_(0, indices, grad), None


class _IndexPutFirstAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, indices, first_axis_dim: int):
        ctx.save_for_backward(indices)
        out = values.new_zeros((first_axis_dim,) + values.shape[1:])
        out[indices] = values
        return out

    @staticmethod
    def backward(ctx, grad):
        (indices,) = ctx.saved_tensors
        return grad.index_select(0, indices), None, None


class _IndexFirstAxisResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, indices):
        ctx.save_for_backward(indices)
        return x.index_select(0, indices), x.detach()

    @staticmethod
    def backward(ctx, grad_out, grad_res):
        (indices,) = ctx.saved_tensors
        return grad_res.clone().index_add_(0, indices, grad_out), None


def index_first_axis(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Rows `indices` of the first axis of x."""
    return _IndexFirstAxis.apply(x, indices)


def index_put_first_axis(values: torch.Tensor, indices: torch.Tensor,
                         first_axis_dim: int) -> torch.Tensor:
    """`values` scattered into rows `indices` of a zero tensor whose first
    axis is `first_axis_dim`."""
    return _IndexPutFirstAxis.apply(values, indices, int(first_axis_dim))


def index_first_axis_residual(x: torch.Tensor, indices: torch.Tensor):
    """(rows `indices` of x, x), whose two cotangents add up in x's."""
    return _IndexFirstAxisResidual.apply(x, indices)


def _cu_seqlens(seqlens: torch.Tensor) -> torch.Tensor:
    return F.pad(torch.cumsum(seqlens, dim=0, dtype=torch.int32), (1, 0))


def unpad_input(hidden_states: torch.Tensor, attention_mask: torch.Tensor,
                unused_mask: Optional[torch.Tensor] = None):
    """Padded (B, S, ...) -> packed (total, ...).  Returns (hidden, indices,
    cu_seqlens, max_seqlen, seqlens), the tuple of the reference."""
    mask = (attention_mask if unused_mask is None
            else attention_mask + unused_mask)
    seqlens = mask.sum(dim=-1, dtype=torch.int32)
    indices = torch.nonzero(mask.flatten(), as_tuple=False).flatten()
    max_seqlen = int(seqlens.max()) if seqlens.numel() else 0
    flat = hidden_states.reshape((-1,) + tuple(hidden_states.shape[2:]))
    return (index_first_axis(flat, indices), indices, _cu_seqlens(seqlens),
            max_seqlen, seqlens)


def unpad_input_for_concatenated_sequences(
        hidden_states: torch.Tensor,
        attention_mask_in_length: torch.Tensor):
    """Several samples concatenated in each row: row b of
    `attention_mask_in_length` lists its samples' lengths, then zeros.
    Returns (hidden, indices, cu_seqlens, max_seqlen) over the samples."""
    aml = attention_mask_in_length
    length = aml.sum(dim=-1)
    seqlen = aml.shape[-1]
    mask2d = (torch.arange(seqlen, device=aml.device)[None, :]
              < length[:, None])
    flat_aml = aml.flatten()
    seqlens = flat_aml[torch.nonzero(flat_aml, as_tuple=False).flatten()]
    seqlens = seqlens.to(torch.int32)
    indices = torch.nonzero(mask2d.flatten(), as_tuple=False).flatten()
    max_seqlen = int(seqlens.max()) if seqlens.numel() else 0
    flat = hidden_states.reshape((-1,) + tuple(hidden_states.shape[2:]))
    return (index_first_axis(flat, indices), indices, _cu_seqlens(seqlens),
            max_seqlen)


def pad_input(hidden_states: torch.Tensor, indices: torch.Tensor, batch: int,
              seqlen: int) -> torch.Tensor:
    """Packed (total, ...) -> padded (batch, seqlen, ...), zeros elsewhere."""
    out = index_put_first_axis(hidden_states, indices, batch * seqlen)
    return out.reshape((batch, seqlen) + tuple(hidden_states.shape[1:]))
