"""Port K4 at head dim 256 (plain path of ops/cuda/decode.py) + merge_partials
against the JAX package's paged_decode_attention + merge_partials (Pallas
interpret mode), fp32, same numpy inputs, at Gemma's decode shapes: one kv
head of group 8 (Gemma-2B's 8/1 heads) and two of group 1 (Gemma-7B's
16/16 heads, cut to two), auto splits and many splits over several pages.
Tolerance 1e-5 (fp32 op outputs).  Also the split rule's counts on the
CPU, the same at every head dim."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flash_attn_v100_tpu.ops.pallas import decode as jdec
from flash_attn_v100_tpu.ops.pallas import masks as jmasks
from flash_attn_v100_tpu_torch.ops import masks as tmasks
from flash_attn_v100_tpu_torch.ops.cuda import decode as tdec

torch.set_num_threads(1)

ATOL = 1e-5
D = 256

# name: (kv heads, group, num_splits (0: auto), page size, table slots,
#        cache lengths).  Many splits: 12 of two pages each (the JAX
#        kernel's pages a grid step divide them, so both cut alike)
CASES = {
    "gemma2b_auto": (1, 8, 0, 16, 12, [150, 61]),
    "gemma2b_many_splits": (1, 8, 12, 8, 24, [150, 61]),
    "gemma7b_auto": (2, 1, 0, 16, 12, [150, 61]),
    "gemma7b_many_splits": (2, 1, 12, 8, 24, [150, 9]),
}


def _inputs(rng, Hk, group, ps, max_pages, lens):
    B = len(lens)
    P = B * max_pages + 1
    q = rng.standard_normal((B, Hk, 8, D)).astype(np.float32)
    q[:, :, group:] = 0.0
    k = rng.standard_normal((1, Hk, P, ps, D)).astype(np.float32)
    v = rng.standard_normal((1, Hk, P, ps, D)).astype(np.float32)
    tbl = rng.permutation(np.arange(1, P)).reshape(B, max_pages)
    return q, k, v, tbl.astype(np.int32), np.asarray(lens, np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_d256_plain_matches_jax(name):
    Hk, group, splits, ps, max_pages, lens = CASES[name]
    q, k, v, tbl, lens = _inputs(np.random.default_rng(26), Hk, group, ps,
                                 max_pages, lens)
    lp = np.zeros(len(lens), np.int32)
    qpos = (lens - 1).astype(np.int32)
    kw = dict(softmax_scale=D ** -0.5, t_new=1, group=group,
              num_splits=splits)
    jo_p, jl_p = jdec.paged_decode_attention(
        *(jnp.asarray(x) for x in (q, k, v, tbl, lens, lp)),
        qpos_vec=jnp.asarray(qpos), params=jmasks.MaskParams(window_right=0),
        interpret=True, **kw)
    jo, jl = jdec.merge_partials(jo_p, jl_p)
    to_p, tl_p = tdec.paged_decode_attention(
        *(torch.from_numpy(x) for x in (q, k, v, tbl, lens, lp)),
        qpos_vec=torch.from_numpy(qpos),
        params=tmasks.MaskParams(window_right=0), **kw)
    to, tl = tdec.merge_partials(to_p, tl_p)

    pairs = [(to, jo), (tl, jl)]
    if splits:   # one split count on both sides: the partials too
        assert to_p.shape == jo_p.shape and to_p.shape[2] == splits
        pairs += [(to_p, jo_p), (tl_p, jl_p)]
    else:        # the port's own rule: the split count is a tiling choice
        assert to_p.shape[2] > 1
    for t_arr, j_arr in pairs:
        j_np = np.asarray(j_arr)[..., :group, :]
        t_np = t_arr.numpy()[..., :group, :]
        assert np.array_equal(np.isneginf(t_np), np.isneginf(j_np))
        fin = np.isfinite(j_np)
        np.testing.assert_allclose(t_np[fin], j_np[fin], rtol=0, atol=ATOL)


# (B, Hk, Rq, max_pages) -> auto splits at every head dim: one wave of two
# blocks an SM on 132 SMs, Rq > 16 in 64-row tiles (the engine's CPU parity
# tests rest on these counts)
SPLIT_COUNTS = {
    (8, 1, 8, 64): 33,       # Gemma-2B's decode step at 8k
    (8, 4, 8, 16): 8,        # TinyLlama's engine step
    (8, 16, 8, 64): 2,       # Gemma-7B's heads
    (2, 4, 512, 16): 4,      # the engine's short-prompt prefill
    (1, 1, 8, 4): 4,         # capped by the table's slots
    (64, 8, 8, 16): 1,       # more blocks than one wave
}


@pytest.mark.parametrize("D_", [32, 64, 128, 256])
@pytest.mark.parametrize("case", list(SPLIT_COUNTS))
def test_auto_split_counts_on_the_cpu(case, D_):
    """The plain path's auto split count (its partials' split axis) for
    16-bit and fp32 q, one page of one key a table slot."""
    B, Hk, Rq, max_pages = case
    tbl = torch.zeros((B, max_pages), dtype=torch.int32)
    lens = torch.ones((B,), dtype=torch.int32)
    for dt in (torch.bfloat16, torch.float32):
        q = torch.zeros((B, Hk, Rq, D_), dtype=dt)
        kv = torch.zeros((1, Hk, 1, 1, D_), dtype=dt)
        o_part, lse_part = tdec.paged_decode_attention(
            q, kv, kv, tbl, lens, None, softmax_scale=D_ ** -0.5,
            params=tmasks.MaskParams(), t_new=1, group=Rq)
        assert o_part.shape[2] == lse_part.shape[2] == SPLIT_COUNTS[case], \
            (dt, o_part.shape)
