"""The port's head-dim contract on the card (`ops/cuda/fwd.py::
kernel_head_dim`): a head dim under 256 pads to the next kernel head dim
(32 / 64 / 128 / 256) and one over 256 raises ValueError, the cap of the
reference CUDA code and upstream FlashAttention.  The CUDA entry points'
refusal at D 264 is the `gpu` case
tests/test_torch_gpu.py::test_head_dim_over_256_raises_before_any_launch."""

import pytest
import torch

from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd

torch.set_num_threads(1)


@pytest.mark.parametrize("D,want", [(16, 32), (48, 64), (200, 256),
                                    (256, 256)])
def test_kernel_head_dim_pads_to_the_next(D, want):
    assert dfwd.kernel_head_dim(D) == want


@pytest.mark.parametrize("D", [264, 512])
def test_kernel_head_dim_refuses_over_256(D):
    with pytest.raises(ValueError, match=f"head_dim <= 256, got {D}"):
        dfwd.kernel_head_dim(D)
