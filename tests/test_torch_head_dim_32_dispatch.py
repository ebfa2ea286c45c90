"""Which rows the forward kernels K1 and K5 are handed at head dims under
32, on the kernel path without a card: meta-device tensors take the
wrappers' CUDA branch, and a stand-in `build.load` records each C entry's
arguments.  16-bit rows of 8, 16 or 24 columns go to the D 32 kernel as
they are (kernel head dim 32, D_in the rows' columns; no F.pad copy, and
out comes back at D columns); any other head dim, and fp32, is padded to
the kernel head dim (D_in = D)."""

import types

import pytest
import torch

from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import build
from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl

torch.set_num_threads(1)

META = torch.device("meta")
PARAMS = masklib.MaskParams(causal=True)
# the argument index of (D, D_in) in each entry (build.SIGNATURES)
HEAD_DIM_ARGS = {"fa_fwd_launch": 12, "fa_fwd_f32_launch": 12,
                 "fa_varlen_fwd_launch": 16, "fa_varlen_fwd_f32_launch": 16}


class _ArgsLibrary:
    """Stands in for a kernel library: records (entry, arguments) and
    returns cudaSuccess."""

    def __init__(self, log):
        self.log = log

    def __getattr__(self, fn):
        def call(*args):
            self.log.append((fn, args))
            return 0
        return call


def _run(entry, D, dtype, monkeypatch):
    """K1 or K5 on meta tensors of head dim D: (the entry called, its
    (D, D_in), out's shape, the F.pad calls)."""
    log, pads = [], []
    monkeypatch.setattr(build, "load", lambda name: _ArgsLibrary(log))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    real_pad = dfwd.F.pad
    monkeypatch.setattr(dfwd.F, "pad",
                        lambda *a, **k: pads.append(1) or real_pad(*a, **k))
    if entry == "K1":
        q = torch.empty((2, 64, 4, D), device=META, dtype=dtype)
        k = torch.empty((2, 64, 2, D), device=META, dtype=dtype)
        out, lse = dfwd.flash_attn_dense_fwd(q, k, k.clone(), D ** -0.5,
                                             PARAMS)
    else:
        q = torch.empty((128, 4, D), device=META, dtype=dtype)
        k = torch.empty((128, 2, D), device=META, dtype=dtype)
        cu = torch.tensor([0, 64, 128], dtype=torch.int32, device=META)
        out, lse = vl.flash_attn_varlen_fwd(q, k, k.clone(), cu, cu, 64, 64,
                                            D ** -0.5, PARAMS)
    (fn, args), = log
    i = HEAD_DIM_ARGS[fn]
    return fn, args[i:i + 2], tuple(out.shape), len(pads)


@pytest.mark.parametrize("entry", ["K1", "K5"])
@pytest.mark.parametrize("D", [8, 16, 24, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_narrow_16bit_rows_reach_the_d32_kernel_unpadded(monkeypatch,
                                                         entry, D, dtype):
    fn, dims, shape, pads = _run(entry, D, dtype, monkeypatch)
    assert fn in ("fa_fwd_launch", "fa_varlen_fwd_launch")
    assert dims == (32, D)
    assert shape[-1] == D and pads == 0


@pytest.mark.parametrize("entry", ["K1", "K5"])
@pytest.mark.parametrize("D,dtype", [(20, torch.bfloat16),
                                     (48, torch.bfloat16),
                                     (16, torch.float32),
                                     (64, torch.bfloat16)],
                         ids=["d20_bf16", "d48_bf16", "d16_fp32",
                              "d64_bf16"])
def test_other_head_dims_are_padded_to_the_kernel(monkeypatch, entry, D,
                                                  dtype):
    fn, dims, shape, pads = _run(entry, D, dtype, monkeypatch)
    Dk = dfwd.kernel_head_dim(D)
    assert fn.endswith("f32_launch") == (dtype == torch.float32)
    assert dims == (Dk, Dk)
    assert shape[-1] == D and pads == (3 if D != Dk else 0)


def test_fwd_head_dims():
    assert dfwd.fwd_head_dims(16, torch.bfloat16) == (32, 16)
    assert dfwd.fwd_head_dims(32, torch.float16) == (32, 32)
    assert dfwd.fwd_head_dims(12, torch.bfloat16) == (32, 32)
    assert dfwd.fwd_head_dims(16, torch.float32) == (32, 32)
    assert dfwd.fwd_head_dims(96, torch.bfloat16) == (128, 128)
    with pytest.raises(ValueError):
        dfwd.fwd_head_dims(264, torch.bfloat16)
