"""The port's ring attention and Ulysses (parallel/ring.py) through the
CUDA kernels K1-K3, on 2 gloo ranks sharing the card
(tests/torch_ring_cases.py::gpu_ring_body, one spawn for the file; every
test takes the `ranks` fixture, which skips where no CUDA device is
present).  On the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_ring.py -q

Ring cases on seq 2 (causal at D 64 and in fp16 at D 128, a window with
softcap that leaves rows of a chunk with no live key, a non-causal
window, ALiBi, dropout, zigzag): the ranks' blocks put together against
the plain versions over the whole sequence, out within 2x the
same-dtype plain version's error + 1e-5 and gradients 3x + 1e-4 of the
fp32 one (utils/testing.py); K1, K2 and K3 launched on every rank, the
plain twins never.  Ulysses: each rank's rows of the output and the
gradients bit-equal to the unsharded flash_attn_func's, one launch of
each kernel a rank."""

import pytest
import torch

import torch_parallel_cases as pc
import torch_ring_cases as rc
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import build
from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
from flash_attn_v100_tpu_torch.parallel import zigzag_unshard
from flash_attn_v100_tpu_torch.utils.testing import (
    assert_bwd_close, assert_fwd_close)

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

RING = [n for n in rc.GPU_CASES if not n.startswith("ulysses")]
ULYSSES = [n for n in rc.GPU_CASES if n.startswith("ulysses")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load("fwd")
    build.load("bwd")
    return pc.spawn("torch_ring_cases.gpu_ring_body", 2,
                    tmp_path_factory.mktemp("gpu_ring"),
                    dict(cases=list(rc.GPU_CASES)))


def _plain(x, kw, dtype, upcast):
    """The plain forward and backward over the whole sequence."""
    t = {k: torch.from_numpy(a).to("cuda", dtype) for k, a in x.items()}
    if upcast:
        t = {k: a.float() for k, a in t.items()}
    q, k, v, do = t["q"], t["k"], t["v"], t["do"]
    w = kw.get("window_size", (-1, -1))
    params = masklib.MaskParams(
        causal=bool(kw.get("causal")), window_left=w[0], window_right=w[1],
        softcap=kw.get("softcap", 0.0), has_alibi="alibi_slopes" in kw)
    extra = dict(dropout_p=kw.get("dropout_p", 0.0),
                 dropout_seed=kw.get("dropout_seed"))
    if "alibi_slopes" in kw:
        extra["alibi_slopes"] = torch.from_numpy(kw["alibi_slopes"]).cuda()
    scale = q.shape[-1] ** -0.5
    o, lse = dfwd.flash_attn_dense_fwd_ref(q, k, v, scale, params,
                                           upcast=upcast, **extra)
    g = dbwd.flash_attn_dense_bwd_ref(q, k, v, o, do, lse, scale, params,
                                      upcast=upcast, **extra)
    return [o, *g]


@pytest.mark.parametrize("name", RING)
def test_ring_attention_kernels_match_plain(ranks, name):
    dt = rc.GPU_CASES[name][0]
    dtype = torch.bfloat16 if dt == "bf16" else torch.float16
    x, kw = rc.gpu_inputs(name)
    got = [torch.cat([r[name]["out"] for r in ranks], 1).cuda()] + [
        torch.cat([r[name]["grads"][i] for r in ranks], 1).cuda()
        for i in range(3)]
    if kw.get("layout") == "zigzag":
        got = [zigzag_unshard(t, 2) for t in got]
        kw = dict(kw)
        del kw["layout"]
    ref32 = _plain(x, kw, dtype, True)
    ref16 = _plain(x, kw, dtype, False)
    assert_fwd_close(got[0], ref32[0], ref16[0], name=f"{name} out")
    for n, g, a, b in zip(("dq", "dk", "dv"), got[1:], ref32[1:],
                          ref16[1:]):
        assert_bwd_close(g, a, b, name=f"{name} {n}")
    for i, r in enumerate(ranks):
        k1, k2, k3 = r[name]["launches"]
        assert k1 == k2 == k3 >= 1, (i, r[name]["launches"])
        assert r[name]["plain"] == [0, 0], (i, r[name]["plain"])
    if name == "causal_d64":    # rank r meets r + 1 chunks in its past
        assert [r[name]["launches"][0] for r in ranks] == [1, 2]


@pytest.mark.parametrize("name", ULYSSES)
def test_ulysses_bit_equal_to_unsharded_kernels(ranks, name):
    for i, r in enumerate(ranks):
        assert all(r[name]["bit_equal"]), (i, r[name]["bit_equal"])
        assert r[name]["launches"] == [1, 1, 1], (i, r[name]["launches"])
        assert r[name]["plain"] == [0, 0], (i, r[name]["plain"])
