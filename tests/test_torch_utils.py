"""The port's utils (benchmarking, profiling, debugging, distinfo) and
`__version__` against the JAX package's, on the CPU.

Exact: the FLOP/rate helpers over a grid of shapes, `find_nonfinite`'s dict
on the same arrays, `stage_report`'s keys and verdicts for flash_attn_func
with a NaN planted in q, and the dist-info files byte for byte.  On the
CPU `measure` times with the host clock and `profile_ops` lists the CPU
ops; their device paths run in tests/test_torch_gpu.py."""

import importlib.metadata
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attn_v100_tpu_torch
from flash_attn_v100_tpu import flash_attn_func as jax_flash_attn_func
from flash_attn_v100_tpu.utils import benchmarking as jbench
from flash_attn_v100_tpu.utils import debugging as jdebug
from flash_attn_v100_tpu.utils import distinfo as jdist
from flash_attn_v100_tpu_torch import flash_attn_func
from flash_attn_v100_tpu_torch.utils import benchmarking as tbench
from flash_attn_v100_tpu_torch.utils import debugging as tdebug
from flash_attn_v100_tpu_torch.utils import distinfo as tdist
from flash_attn_v100_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


@pytest.mark.parametrize("causal", [False, True])
def test_flop_and_rate_helpers_equal_jax(causal):
    for B, M, N, H, D in itertools.product((1, 3), (1, 127, 4096),
                                           (1, 1000, 32768), (1, 32),
                                           (32, 64, 128, 256)):
        f = tbench.attention_flops(B, M, N, H, D, causal=causal)
        assert f == jbench.attention_flops(B, M, N, H, D, causal=causal)
        assert isinstance(f, int)
        for s in (1e-6, 3.7e-4, 2.0):
            assert tbench.tflops(f, s) == jbench.tflops(f, s)
            assert tbench.gbps(f, s) == jbench.gbps(f, s)


def _planted():
    a = np.random.default_rng(3).standard_normal((3, 5, 7)).astype(np.float32)
    a[1, 2, 3] = np.nan
    a[2, 0, 1] = np.inf
    a[2, 4, 6] = -np.inf
    a[0, 4, 0] = np.nan
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_find_nonfinite_equals_jax(dtype):
    a = _planted()
    got = tdebug.find_nonfinite(torch.from_numpy(a).to(getattr(torch, dtype)),
                                "x")
    want = jdebug.find_nonfinite(jnp.asarray(a, getattr(jnp, dtype)), "x")
    # NaN != NaN: compare the value by its text
    assert {**got, "value": repr(got["value"])} == {
        **want, "value": repr(want["value"])}
    assert got["index"] == (0, 4, 0) and got["num_inf"] == 2
    inf = _planted()
    inf[np.isnan(inf)] = 1.0
    assert tdebug.find_nonfinite(torch.from_numpy(inf), "y") == \
        jdebug.find_nonfinite(jnp.asarray(inf), "y")
    assert tdebug.find_nonfinite(torch.ones(4)) is None
    with pytest.raises(AssertionError, match="non-finite in x"):
        tdebug.assert_finite(torch.from_numpy(a), "x")
    tdebug.assert_finite(np.zeros(3), "y")


@pytest.mark.parametrize("probs", [False, True])
def test_stage_report_keys_and_verdicts_equal_jax(probs):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 24, 2, 16)).astype(np.float32)
               for _ in range(3))
    q[0, 5, 1, 3] = np.nan
    kw = dict(causal=True, return_attn_probs=probs)
    got = tdebug.stage_report(flash_attn_func,
                              [torch.from_numpy(x) for x in (q, k, v)], kw,
                              grad_argnums=(0, 1, 2), verbose=False)
    want = jdebug.stage_report(jax_flash_attn_func,
                               [jnp.asarray(x) for x in (q, k, v)], kw,
                               grad_argnums=(0, 1, 2), verbose=False)
    assert list(got) == list(want)
    assert [v is None for v in got.values()] == [
        v is None for v in want.values()]
    assert got["grad[arg1]"] is not None and got["grad[arg0]"] is not None


def test_measure_on_the_cpu_is_positive():
    x = torch.randn(128, 128)
    s = tbench.measure(torch.mm, x, x, iters=4, repeats=2,
                       min_window_s=0.01, device="cpu")
    assert 0 < s < 1


def test_profile_ops_on_the_cpu_lists_aten_ops(tmp_path):
    x = torch.randn(64, 64)

    def fn(a):
        return torch.relu(a @ a).sum()

    rows = tprof.profile_ops(fn, x, iters=2)
    labels = [r[0] for r in rows]
    assert "aten::mm" in labels and any(l.startswith("aten::") for l in labels)
    assert all(us >= 0 and n >= 1 for _, us, n in rows)
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    # the debugging trace writes the same kind of trace
    with tdebug.trace(str(tmp_path / "t")) as d:
        fn(x)
    assert "aten::mm" in [r[0] for r in tprof.summarize_trace(d)]


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, 64, 0, false, "
     "0>((anonymous namespace)::FwdArgs)", "K1"),
    ("void (anonymous namespace)::fwd_kernel<__half, 128, 1, true, 0>"
     "((anonymous namespace)::FwdArgs)", "K5"),
    ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, 64, 2, false, "
     "0>((anonymous namespace)::FwdArgs)", "K8"),
    ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, 64, 2, false, "
     "1>((anonymous namespace)::FwdArgs)", "K8q"),
    ("void (anonymous namespace)::dq_kernel<__nv_bfloat16, 64, false, "
     "false>((anonymous namespace)::BwdArgs)", "K2"),
    ("void (anonymous namespace)::dkv_kernel<__nv_bfloat16, 64, false, "
     "true>((anonymous namespace)::BwdArgs)", "K3"),
    ("void (anonymous namespace)::dq_kernel<__nv_bfloat16, 64, true, "
     "false>((anonymous namespace)::BwdArgs)", "K6"),
    ("void (anonymous namespace)::dkv_kernel<__half, 32, true, false>"
     "((anonymous namespace)::BwdArgs)", "K7"),
    # K2 / K6 and K3 / K7 at head dim 256 (csrc/bwd.cu dq_split_kernel,
    # dkv_split_kernel)
    ("void (anonymous namespace)::dq_split_kernel<__nv_bfloat16, 256, "
     "false, true>((anonymous namespace)::BwdArgs)", "K2"),
    ("void (anonymous namespace)::dq_split_kernel<__half, 256, true, "
     "false>((anonymous namespace)::BwdArgs)", "K6"),
    ("void (anonymous namespace)::dkv_split_kernel<__nv_bfloat16, 256, "
     "false, false>((anonymous namespace)::BwdArgs)", "K3"),
    ("void (anonymous namespace)::dkv_split_kernel<__half, 256, true, "
     "true>((anonymous namespace)::BwdArgs)", "K7"),
    ("void fa::dec::decode_kernel<__nv_bfloat16, 64, 3, 16>"
     "(fa::dec::DecodeArgs)", "K4"),
    ("void fa::dec::decode_kernel<__nv_bfloat16, 128, 0, 64>"
     "(fa::dec::DecodeArgs)", "K4q"),
    ("void (anonymous namespace)::int_kernel<__nv_bfloat16, 64, 2, false>"
     "((anonymous namespace)::IntArgs)", "K8q"),
    # with the tile parameters (csrc/fwd_body.cuh FwdTune, csrc/bwd.cu
    # BwdTune, the decode body's ABL), the shipped defaults or a variant's
    ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, 128, 0, false, "
     "0, (anonymous namespace)::FwdTune<0, 1, 0, false, false> >"
     "((anonymous namespace)::FwdArgs)", "K1"),
    ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, 128, 2, false, "
     "0, (anonymous namespace)::FwdTune<16, 8, 0, false, false> >"
     "((anonymous namespace)::FwdArgs)", "K8"),
    ("void (anonymous namespace)::dkv_kernel<__nv_bfloat16, 128, true, "
     "false, (anonymous namespace)::BwdTune<0, 0, 1> >"
     "((anonymous namespace)::BwdArgs)", "K7"),
    ("void fa::dec::decode_kernel<__nv_bfloat16, 128, 2, 16, 0>"
     "(fa::dec::DecodeArgs)", "K4q"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>, at::detail::Array<char*, 1> >(int, "
     "at::native::FillFunctor<float>, at::detail::Array<char*, 1>)", None),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, "
     "128, 128, 4, false, false, cutlass::bfloat16_t> >(Flash_fwd_params)",
     None),
])
def test_kernel_ids_from_cuda_names(name, want):
    assert tprof.kernel_id(name) == want
    assert tprof._readable_label({"name": name}) == (want or name)


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, 64, 0, false, "
     "0>((anonymous namespace)::FwdArgs)", 64),
    # cu++filt's form of a build log's or cuobjdump's mangled name
    ("void <unnamed>::fwd_kernel<__half, (int)256, (int)2, (bool)1, (int)1, "
     "<unnamed>::FwdTune<(int)0, (int)1, (int)0, (bool)0, (bool)0>>"
     "(<unnamed>::FwdArgs)", 256),
    ("void <unnamed>::dkv_split_kernel<__nv_bfloat16, (int)256, (bool)1, "
     "(bool)0>(<unnamed>::BwdArgs)", 256),
    ("void <unnamed>::dq_split_kernel<__half, (int)256, (bool)0, "
     "(bool)1>(<unnamed>::BwdArgs)", 256),
    ("void fa::dec::decode_kernel<__nv_bfloat16, 128, 0, 64>"
     "(fa::dec::DecodeArgs)", 128),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, "
     "128, 128, 4, false, false, cutlass::bfloat16_t> >(Flash_fwd_params)",
     None),
])
def test_kernel_head_dims_from_cuda_names(name, want):
    assert tprof.kernel_head_dim(name) == want


def test_dist_info_byte_equal_to_jax(tmp_path):
    got = tdist.write_dist_info(str(tmp_path / "port"))
    want = jdist.write_dist_info(str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want)
    for f in ("METADATA", "top_level.txt"):
        with open(os.path.join(got, f), "rb") as a, \
                open(os.path.join(want, f), "rb") as b:
            assert a.read() == b.read()
    assert tdist.write_dist_info(str(tmp_path / "port")) == got  # idempotent
    dist = importlib.metadata.PathDistribution(
        __import__("pathlib").Path(got))
    assert dist.version == "2.8.3" and dist.metadata["Name"] == "flash-attn"
    assert tdist.FLASH_ATTN_VERSION == jdist.FLASH_ATTN_VERSION


def test_version():
    assert flash_attn_v100_tpu_torch.__version__ == "2.8.3"
