"""Numerical constants and device selection for the PyTorch/CUDA package.

The constants are those of the reference CUDA kernels: masked scores are
filled with NEG_INF = -1e30 (a finite value, not -inf) and exp() arguments are
clamped at EXP_CLAMP.  fp16 is computed natively on the GPU; there is no
fp16 -> bf16 substitution here.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30
EXP_CLAMP = -80.0

# Entry points (init_params, ServingEngine, the cache allocators) place their
# tensors here unless the caller names another device.
DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point works on: `device`, else DEFAULT_DEVICE.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    present: the package never carries on silently on the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def as_torch_dtype(dtype: Optional[Union[str, torch.dtype]]) -> Optional[torch.dtype]:
    """Accept torch dtypes and their names ("bfloat16", "float32", ...)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))
