"""Port K4 (plain path of ops/cuda/decode.py) + merge_partials against the
JAX package's paged_decode_attention + merge_partials (Pallas interpret
mode), fp32, same numpy inputs.  Tolerance 1e-5 (fp32 op outputs)."""

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

# name: (t_new, num_splits, leftpad, causal, window_left, softcap, alibi,
#        first row's cache length)
CASES = {
    "t1_s1": (1, 1, False, False, -1, 0.0, False, None),
    "t1_s4_leftpad": (1, 4, True, False, -1, 0.0, False, None),
    "t4_s1_window": (4, 1, False, True, 20, 0.0, False, None),
    "t4_s4_all_features": (4, 4, True, True, 30, 15.0, True, None),
    "t1_s4_fully_masked_row": (1, 4, False, False, -1, 0.0, False, 0),
}


def _inputs(rng, t_new, leftpad, first_len):
    B, Hk, group, D, ps, P, max_pages = 2, 2, 2, 32, 16, 14, 6
    rq = max(-(-group * t_new // 8) * 8, 8)
    q = rng.standard_normal((B, Hk, rq, D)).astype(np.float32)
    q[:, :, group * t_new:] = 0.0
    k = rng.standard_normal((1, Hk, P, ps, D)).astype(np.float32)
    v = rng.standard_normal((1, Hk, P, ps, D)).astype(np.float32)
    tbl = np.stack([rng.permutation(np.arange(1, P))[:max_pages]
                    for _ in range(B)]).astype(np.int32)
    lp = (np.asarray([5, 11], np.int32) if leftpad
          else np.zeros(B, np.int32))
    lens = np.asarray([70, 41], np.int32)
    if first_len is not None:
        lens[0] = first_len
    slopes = rng.uniform(0.01, 0.2, (B, Hk, rq, 1)).astype(np.float32)
    return dict(q=q, k=k, v=v, tbl=tbl, lens=lens, lp=lp, slopes=slopes,
                group=group)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_plain_matches_jax(name):
    t_new, splits, leftpad, causal, wl, softcap, alibi, first_len = CASES[name]
    x = _inputs(np.random.default_rng(7), t_new, leftpad, first_len)
    wr = 0 if causal else -1
    qpos = np.maximum(x["lens"] - t_new, 0).astype(np.int32)
    kw_common = dict(softmax_scale=32 ** -0.5, t_new=t_new, group=x["group"],
                     num_splits=splits)

    jp = jmasks.MaskParams(causal=causal and t_new > 1, window_left=wl,
                           window_right=wr, softcap=softcap, has_alibi=alibi)
    jo_p, jl_p = jdec.paged_decode_attention(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jnp.asarray(x["tbl"]), jnp.asarray(x["lens"]), jnp.asarray(x["lp"]),
        qpos_vec=jnp.asarray(qpos), params=jp,
        alibi_slopes_rows=jnp.asarray(x["slopes"]) if alibi else None,
        interpret=True, **kw_common)
    jo, jl = jdec.merge_partials(jo_p, jl_p)

    tp = tmasks.MaskParams(causal=causal and t_new > 1, window_left=wl,
                           window_right=wr, softcap=softcap, has_alibi=alibi)
    to_p, tl_p = tdec.paged_decode_attention(
        torch.from_numpy(x["q"]), torch.from_numpy(x["k"]),
        torch.from_numpy(x["v"]), torch.from_numpy(x["tbl"]),
        torch.from_numpy(x["lens"]), torch.from_numpy(x["lp"]),
        qpos_vec=torch.from_numpy(qpos), params=tp,
        alibi_slopes_rows=torch.from_numpy(x["slopes"]) if alibi else None,
        **kw_common)
    to, tl = tdec.merge_partials(to_p, tl_p)

    assert to_p.shape == jo_p.shape and tl_p.shape == jl_p.shape
    # padded q rows (r >= group * t_new) are sliced away by every caller;
    # the TPU kernel leaves them unmasked on its fast path
    n = x["group"] * t_new
    for t_arr, j_arr in ((to_p, jo_p), (tl_p, jl_p), (to, jo), (tl, jl)):
        j_np = np.asarray(j_arr)[..., :n, :]
        t_np = t_arr.numpy()[..., :n, :]
        assert np.array_equal(np.isneginf(t_np), np.isneginf(j_np))
        fin = np.isfinite(j_np)
        np.testing.assert_allclose(t_np[fin], j_np[fin], rtol=0, atol=ATOL)
    if first_len == 0:
        assert np.isneginf(tl.numpy()[0, :, :n]).all()
        assert not to.numpy()[0, :, :n].any()


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(3)
    o = rng.standard_normal((2, 3, 5, 8, 16)).astype(np.float32)
    lse = rng.standard_normal((2, 3, 5, 8, 1)).astype(np.float32)
    lse[0, 0, :, 0] = -np.inf          # a row whose splits are all empty
    lse[1, 2, 1:3] = -np.inf           # some empty splits
    jo, jl = jdec.merge_partials(jnp.asarray(o), jnp.asarray(lse))
    to, tl = tdec.merge_partials(torch.from_numpy(o), torch.from_numpy(lse))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)
    assert np.array_equal(np.isneginf(tl.numpy()), np.isneginf(np.asarray(jl)))
    fin = np.isfinite(np.asarray(jl))
    np.testing.assert_allclose(tl.numpy()[fin], np.asarray(jl)[fin], rtol=0,
                               atol=ATOL)


def test_auto_splits_merge_matches_single_split():
    """num_splits=0 (the port's own SM-filling rule) merges to the same
    attention as one split."""
    x = _inputs(np.random.default_rng(11), 1, False, None)
    args = [torch.from_numpy(x[n]) for n in ("q", "k", "v", "tbl", "lens",
                                             "lp")]
    kw = dict(softmax_scale=0.2, params=tmasks.MaskParams(window_right=0),
              t_new=1, group=x["group"])
    o0, l0 = tdec.merge_partials(*tdec.paged_decode_attention(
        *args, num_splits=0, **kw))
    o1, l1 = tdec.merge_partials(*tdec.paged_decode_attention(
        *args, num_splits=1, **kw))
    assert tdec.resolve_num_splits(0, 2, 2, 8, 6, torch.device("cpu")) > 1
    torch.testing.assert_close(o0, o1, rtol=0, atol=ATOL)
    torch.testing.assert_close(l0, l1, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_merged_entry_equals_merge_partials(name):
    """paged_decode_attention_merged on CPU tensors is merge_partials of the
    plain version, bit for bit, all-empty rows (O = 0, LSE = -inf)
    included; its O keeps q's dtype."""
    t_new, splits, leftpad, causal, wl, softcap, alibi, first_len = CASES[name]
    x = _inputs(np.random.default_rng(5), t_new, leftpad, first_len)
    args = [torch.from_numpy(x[n]) for n in ("q", "k", "v", "tbl", "lens",
                                             "lp")]
    kw = dict(qpos_vec=torch.from_numpy(
                  np.maximum(x["lens"] - t_new, 0).astype(np.int32)),
              softmax_scale=32 ** -0.5,
              params=tmasks.MaskParams(causal=causal and t_new > 1,
                                       window_left=wl,
                                       window_right=0 if causal else -1,
                                       softcap=softcap, has_alibi=alibi),
              t_new=t_new, group=x["group"], num_splits=splits,
              alibi_slopes_rows=torch.from_numpy(x["slopes"]) if alibi
              else None)
    o, lse = tdec.paged_decode_attention_merged(*args, **kw)
    ro, rlse = tdec.merge_partials(*tdec.paged_decode_attention_ref(
        *args, **kw))
    assert o.dtype == args[0].dtype and o.shape == ro.shape
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    if first_len == 0:
        assert torch.isneginf(lse[0]).all() and not o[0].any()
