"""The port's Philox dropout bits (ops/philox.py) against the JAX package's
(flash_attn_v100_tpu/ops/philox.py): bit-equal words and keep masks over
256 x 256 positions, for several (batch, head) stream ids and seeds
(including 32-bit halves >= 2^31), and the keep rate within 0.01 of
1 - p."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.ops import philox as jp
from flash_attn_v100_tpu_torch.ops import philox as tp

torch.set_num_threads(1)

SEEDS = [0, 42, 0x9E3779B97F4A7C15, (0xFFFFFFF0 << 32) | 0x80000001]
BHS = [0, 5, 123, 0x80000003]
ROWS = np.arange(256)[:, None]
COLS = np.arange(256)[None, :]


def _jax_bits(seed, bh):
    lo, hi = jp.split_seed(seed)
    return np.asarray(jp.dropout_keep_bits(
        jnp.asarray(ROWS, jnp.int32), jnp.asarray(COLS, jnp.int32),
        jnp.uint32(bh), lo, hi)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_seed_matches_jax(seed):
    assert tp.split_seed(seed) == tuple(int(x) for x in jp.split_seed(seed))


@pytest.mark.parametrize("bh", BHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_bits_bit_equal_to_jax(seed, bh):
    lo, hi = tp.split_seed(seed)
    bits = tp.dropout_keep_bits(torch.from_numpy(ROWS), torch.from_numpy(COLS),
                                bh, lo, hi)
    assert bits.shape == (256, 256)
    np.testing.assert_array_equal(bits.numpy(), _jax_bits(seed, bh))


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("seed", SEEDS[1:3])
def test_keep_mask_bit_equal_and_rate(seed, p):
    lo, hi = tp.split_seed(seed)
    jlo, jhi = jp.split_seed(seed)
    bh = torch.arange(4).view(4, 1, 1) * 7 + 1
    keep = tp.dropout_keep_mask(torch.from_numpy(ROWS),
                                torch.from_numpy(COLS), bh, lo, hi, p)
    keep_j = np.asarray(jp.dropout_keep_mask(
        jnp.asarray(ROWS, jnp.int32), jnp.asarray(COLS, jnp.int32),
        jnp.asarray(bh.numpy(), jnp.uint32), jlo, jhi, p))
    assert keep.shape == (4, 256, 256)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    assert tp.keep_threshold(p) == int(jp.keep_threshold(p))
    assert abs(float(keep.float().mean()) - (1.0 - p)) < 0.01


def test_philox_words_match_jax():
    """All four output words of the raw generator on full-range counters."""
    rng = np.random.default_rng(0)
    c = rng.integers(0, 2 ** 32, (4, 64), dtype=np.uint64)
    k = [0xDEADBEEF, 0x80000000]
    got = tp.philox_4x32(*(torch.from_numpy(x.astype(np.int64)) for x in c),
                         *k)
    want = jp.philox_4x32(*(jnp.asarray(x, jnp.uint32) for x in c),
                          *(jnp.uint32(x) for x in k))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
