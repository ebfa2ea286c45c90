"""Shared score pipeline (plain PyTorch): scale -> ALiBi -> softcap -> mask.

The CUDA kernels apply the same pipeline per element from `csrc/masks.cuh`;
the plain versions of the kernels apply it to whole score tensors with the
functions below.

Conventions:
  offset = seqlen_k - seqlen_q  (bottom-right aligned causal)
  causal  masks  col - offset >  row
  window  masks  col - offset <  row - window_left   (window_left  >= 0)
                 col - offset >  row + window_right  (window_right >= 0)
  bias order: s*scale, then -slope*|row-(col-offset)|, then softcap*tanh(./cap)
  masked -> NEG_INF (-1e30, not -inf)
"""

from __future__ import annotations

import dataclasses

import torch

from flash_attn_v100_tpu_torch.config import NEG_INF


@dataclasses.dataclass(frozen=True)
class MaskParams:
    causal: bool = False
    window_left: int = -1
    window_right: int = -1
    softcap: float = 0.0
    has_alibi: bool = False

    def effective_window_right(self) -> int:
        """causal == window_right 0 for range trimming purposes."""
        if self.causal:
            return 0 if self.window_right < 0 else min(0, self.window_right)
        return self.window_right


def apply_score_bias(s: torch.Tensor, rows, cols, *, softmax_scale: float,
                     offset, params: MaskParams, alibi_slope=None) -> torch.Tensor:
    """scale -> ALiBi -> softcap, on every element regardless of masking.
    `rows`/`cols` are broadcastable absolute positions; `alibi_slope` is
    broadcastable to `s`."""
    s = s * softmax_scale
    if params.has_alibi:
        dist = (rows - (cols - offset)).abs().to(torch.float32)
        s = s - alibi_slope * dist
    if params.softcap > 0.0:
        s = params.softcap * torch.tanh(s * (1.0 / params.softcap))
    return s


def position_mask(rows, cols, *, offset, params: MaskParams) -> torch.Tensor:
    """Causal/window validity (True = attend); bounds are the caller's."""
    rel = cols - offset
    valid = torch.ones(torch.broadcast_shapes(rel.shape, rows.shape),
                       dtype=torch.bool, device=rel.device)
    if params.causal:
        valid = valid & (rel <= rows)
    if params.window_left >= 0:
        valid = valid & (rel >= rows - params.window_left)
    if params.window_right >= 0:
        valid = valid & (rel <= rows + params.window_right)
    return valid


def apply_score_pipeline(s: torch.Tensor, rows, cols, *, softmax_scale: float,
                         offset, params: MaskParams, valid: torch.Tensor,
                         alibi_slope=None) -> torch.Tensor:
    """Biased scores with every entry outside `valid` set to NEG_INF."""
    s = apply_score_bias(s, rows, cols, softmax_scale=softmax_scale,
                         offset=offset, params=params, alibi_slope=alibi_slope)
    return torch.where(valid, s, torch.full_like(s, NEG_INF))
