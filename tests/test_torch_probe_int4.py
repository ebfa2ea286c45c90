"""P4 (ops/cuda/probe_int4.py) against the TPU probe
benchmarks/prof_int4_native.py on its own operands (q (128, 128) and
k (256, 128) drawn in [-8, 8) from default_rng(0)): the int8 x int4 product
runs in Pallas interpret mode here and the port's twin matches it bit for
bit.  The int4 x int4 product does not lower on XLA's CPU backend ("does
not support custom element sizes"), so its oracle is the script's own numpy
product (prof_int4_native.py:38).  Also the packing's round trip over every
nibble value and the wrappers' CPU route."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flash_attn_v100_tpu_torch.ops.cuda import probe_int4 as p4

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "prof_int4_native.py"


@pytest.fixture(scope="module")
def tpu_probe():
    spec = importlib.util.spec_from_file_location("_tpu_int4", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, (128, 128))
    k = rng.integers(-8, 8, (256, 128))
    return mod, q, k


def test_int8_x_int4_twin_bit_equal_to_the_tpu_kernel(tpu_probe):
    mod, q, k = tpu_probe
    qq = jnp.asarray(q, jnp.int4).astype(jnp.int8)
    kk = jnp.asarray(k, jnp.int4)
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            mod.kernel,
            out_shape=jax.ShapeDtypeStruct((128, 256), jnp.int32))(qq, kk)
    twin = p4.int8_int4_matmul_ref(torch.from_numpy(q).to(torch.int8),
                                   p4.pack_int4(torch.from_numpy(k)))
    assert twin.dtype == torch.int32
    assert np.array_equal(twin.numpy(), np.asarray(out))


def test_int4_x_int4_twin_equals_the_scripts_numpy_product(tpu_probe):
    _, q, k = tpu_probe
    ref = np.asarray(q, np.int32) @ np.asarray(k, np.int32).T
    twin = p4.int4_matmul_ref(p4.pack_int4(torch.from_numpy(q)),
                              p4.pack_int4(torch.from_numpy(k)))
    assert np.array_equal(twin.numpy(), ref)


def test_pack_unpack_round_trip_every_nibble():
    vals = torch.arange(-8, 8, dtype=torch.int8)
    pairs = torch.cartesian_prod(vals, vals).reshape(1, -1)   # (1, 512)
    packed = p4.pack_int4(pairs)
    assert packed.dtype == torch.uint8 and packed.shape == (1, 256)
    # all 256 byte values occur once: (lo, hi) -> lo & 15 | (hi & 15) << 4
    assert sorted(packed[0].tolist()) == list(range(256))
    assert packed[0, 0] == 0x88 and packed[0, 255] == 0x77
    assert torch.equal(p4.unpack_int4(packed), pairs)
    with pytest.raises(ValueError):
        p4.pack_int4(torch.tensor([[8, 0]]))


def test_cpu_wrappers_route_to_the_twins_and_count_nothing():
    rng = np.random.default_rng(1)
    a8 = torch.from_numpy(rng.integers(-8, 8, (128, 256))).to(torch.int8)
    b = p4.pack_int4(torch.from_numpy(rng.integers(-8, 8, (128, 256))))
    calls = (p4.int4_matmul_ref.calls, p4.int8_int4_matmul_ref.calls)
    launches = (p4.int4_matmul.launches, p4.int8_int4_matmul.launches)
    c8 = p4.int8_int4_matmul(a8, b)
    c4 = p4.int4_matmul(p4.pack_int4(a8), b)
    assert torch.equal(c8, c4)
    exact = a8.long() @ p4.unpack_int4(b).long().T
    assert torch.equal(c8.long(), exact)
    assert (p4.int4_matmul_ref.calls, p4.int8_int4_matmul_ref.calls) == (
        calls[0] + 1, calls[1] + 1)
    assert (p4.int4_matmul.launches, p4.int8_int4_matmul.launches) == \
        launches
    assert p4.work(128, 256, 128, 4) == (2 * 128 * 256 * 128,
                                         128 * 64 + 256 * 64 + 4 * 128 * 256)
