"""delta = rowsum(O * dO), the backward kernels' per-row input
(`ops/cuda/bwd.py::row_dot`, behind `softmax_delta` and
`ops/cuda/varlen.py::varlen_delta`): the fp32 row sums, each row's bits
the same whatever rows come with it, so a sequence's delta alone equals
its rows of a packed batch's (torch's CUDA sum picks its reduction tree
by the row count; the card's case is
tests/test_torch_gpu.py::test_row_dot_rows_alone_bit_equal_to_among_many)."""

import numpy as np
import pytest
import torch

from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl

torch.set_num_threads(1)


def _pair(shape, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for _ in range(2)]


@pytest.mark.parametrize("shape", [(1, 1, 8, 256), (1, 3, 4, 64),
                                   (2, 20, 4, 128), (0, 8, 256),
                                   (1, 1, 1, 32)])
def test_row_dot_is_the_fp32_row_sum(shape):
    o, do = _pair(shape, 3)
    got = dbwd.row_dot(o, do)
    want = (o.double() * do.double()).sum(-1)
    assert got.dtype == torch.float32 and got.shape == shape[:-1]
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_rows_alone_bit_equal_to_among_many(D, n):
    o, do = _pair((40, 8, D), 5)
    many = dbwd.row_dot(o, do)
    assert torch.equal(dbwd.row_dot(o[:n].clone(), do[:n].clone()), many[:n])
    # the dense (B, Hq, M) and varlen (Hq, Tq) layouts of the same rows
    dense = dbwd.softmax_delta(o[None, :n], do[None, :n])
    assert torch.equal(dense[0], vl.varlen_delta(o, do)[:, :n])
