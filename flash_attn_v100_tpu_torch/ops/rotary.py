"""Rotary position embedding, plain PyTorch.

Interleaved pairs (2i, 2i+1) or half-split pairs (i, i + rot_dim/2), computed
in fp32 and cast back to the input dtype.  cos/sin are (seqlen_ro, rot_dim/2).
"""

from __future__ import annotations

import torch


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     positions: torch.Tensor, interleaved: bool = True
                     ) -> torch.Tensor:
    """Rotate the first rot_dim features of x (..., T, H, D) at `positions`
    (broadcastable to (..., T))."""
    rot_half = cos.shape[-1]
    rot_dim = 2 * rot_half
    D = x.shape[-1]
    assert rot_dim <= D

    # clamp: padded tokens past the table (bucketed prefill) must not index
    # out of range; their rotated values are never attended
    positions = positions.to(device=cos.device, dtype=torch.long).clamp(
        0, cos.shape[0] - 1)
    c = cos[positions].to(torch.float32)[..., None, :]   # (..., T, 1, rot/2)
    s = sin[positions].to(torch.float32)[..., None, :]

    xr = x[..., :rot_dim].to(torch.float32)
    if interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(xr.shape)
    else:
        x1, x2 = xr[..., :rot_half], xr[..., rot_half:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    out = out.to(x.dtype)
    if rot_dim < D:
        out = torch.cat([out, x[..., rot_dim:]], dim=-1)
    return out
