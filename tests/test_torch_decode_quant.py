"""Port K4q's plain version (ops/cuda/decode.py::paged_decode_attention_ref
with scales) against the JAX package's paged_decode_attention with
k_scales / v_scales (Pallas interpret mode), fp32 q, the same int8 / fp8 /
int4 pools, at JAX's grouping of P (p_tile=None: one page), the same
num_splits on both sides.  Tolerance 1e-5: the integer products are exact
on both sides, so only fp32 rounding of the scores, the softmax and the
sums differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.ops import quant as jq
from flash_attn_v100_tpu.ops.pallas import decode as jdec
from flash_attn_v100_tpu.ops.pallas import masks as jmasks
from flash_attn_v100_tpu_torch.ops import masks as tmasks
from flash_attn_v100_tpu_torch.ops import quant as tq
from flash_attn_v100_tpu_torch.ops.cuda import decode as tdec

torch.set_num_threads(1)

ATOL = 1e-5
KINDS = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn, "int4": "int4"}

# name: (t_new, num_splits, leftpad, causal, window_left, softcap, alibi)
CASES = {
    "t1_s4_leftpad": (1, 4, True, False, -1, 0.0, False),
    "t4_s1_window": (4, 1, False, True, 20, 0.0, False),
    "t4_s4_softcap_alibi_leftpad": (4, 4, True, True, 30, 15.0, True),
}


def _inputs(rng, t_new, kind):
    B, Hk, group, D, ps, P, max_pages = 2, 2, 2, 32, 16, 14, 6
    rq = max(-(-group * t_new // 8) * 8, 8)
    q = rng.standard_normal((B, Hk, rq, D)).astype(np.float32)
    q[:, :, group * t_new:] = 0.0
    kf, vf = (rng.standard_normal((1, Hk, P, ps, D)).astype(np.float32)
              for _ in range(2))
    (kq, ks), (vq, vs) = (jq.quantize_kv(jnp.asarray(x), KINDS[kind])
                          for x in (kf, vf))
    tbl = np.stack([rng.permutation(np.arange(1, P))[:max_pages]
                    for _ in range(B)]).astype(np.int32)
    slopes = rng.uniform(0.01, 0.2, (B, Hk, rq, 1)).astype(np.float32)
    return dict(q=q, pools=(kq, vq, ks, vs), tbl=tbl, group=group,
                slopes=slopes, lens=np.asarray([70, 41], np.int32))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", list(CASES))
def test_decode_quant_plain_matches_jax(name, kind):
    t_new, splits, leftpad, causal, wl, softcap, alibi = CASES[name]
    x = _inputs(np.random.default_rng(17), t_new, kind)
    lp = np.asarray([5, 11] if leftpad else [0, 0], np.int32)
    qpos = (x["lens"] - t_new).astype(np.int32)
    mask = dict(causal=causal and t_new > 1, window_left=wl,
                window_right=0 if causal else -1, softcap=softcap,
                has_alibi=alibi)
    common = dict(softmax_scale=32 ** -0.5, t_new=t_new, group=x["group"],
                  num_splits=splits)
    kq, vq, ks, vs = x["pools"]
    jo_p, jl_p = jdec.paged_decode_attention(
        jnp.asarray(x["q"]), kq, vq, jnp.asarray(x["tbl"]),
        jnp.asarray(x["lens"]), jnp.asarray(lp), qpos_vec=jnp.asarray(qpos),
        params=jmasks.MaskParams(**mask),
        alibi_slopes_rows=jnp.asarray(x["slopes"]) if alibi else None,
        k_scales=ks, v_scales=vs, int4=kind == "int4", interpret=True,
        **common)
    tpools = [tq.payload_from_numpy(np.asarray(a)) for a in x["pools"]]
    to_p, tl_p = tdec.paged_decode_attention_ref(
        torch.from_numpy(x["q"]), tpools[0], tpools[1],
        torch.from_numpy(x["tbl"]), torch.from_numpy(x["lens"]),
        torch.from_numpy(lp), qpos_vec=torch.from_numpy(qpos),
        params=tmasks.MaskParams(**mask),
        alibi_slopes_rows=torch.from_numpy(x["slopes"]) if alibi else None,
        k_scales=tpools[2], v_scales=tpools[3], int4=kind == "int4",
        p_tile=None, **common)
    assert to_p.shape == jo_p.shape and tl_p.shape == jl_p.shape
    # padded q rows (r >= group * t_new) are sliced away by every caller;
    # the TPU kernel leaves them unmasked on its fast path
    n = x["group"] * t_new
    merged = (tdec.merge_partials(to_p, tl_p),
              jdec.merge_partials(jo_p, jl_p))
    for t_arr, j_arr in ((to_p, jo_p), (tl_p, jl_p),
                         (merged[0][0], merged[1][0]),
                         (merged[0][1], merged[1][1])):
        j_np = np.asarray(j_arr)[..., :n, :]
        t_np = t_arr.numpy()[..., :n, :]
        assert np.array_equal(np.isneginf(t_np), np.isneginf(j_np))
        fin = np.isfinite(j_np)
        np.testing.assert_allclose(t_np[fin], j_np[fin], rtol=0, atol=ATOL)


def test_decode_quant_plain_groups_by_p_tile():
    """P's int8 grouping is part of the function: the kernel's 32-row
    chunks and JAX's pages give different roundings of P (a few 1e-3 here,
    P's int8 step), while fp8 (P rounded to bf16) depends on the grouping
    only through the running max; round_p=False takes P unrounded."""
    x = _inputs(np.random.default_rng(19), 1, "int8")
    tpools = [tq.payload_from_numpy(np.asarray(a)) for a in x["pools"]]
    args = (torch.from_numpy(x["q"]), tpools[0], tpools[1],
            torch.from_numpy(x["tbl"]), torch.from_numpy(x["lens"]), None)
    kw = dict(softmax_scale=0.2, params=tmasks.MaskParams(window_right=0),
              t_new=1, group=x["group"], num_splits=1, k_scales=tpools[2],
              v_scales=tpools[3])
    outs = {p: tdec.merge_partials(*tdec.paged_decode_attention_ref(
        *args, p_tile=p, **kw))[0][:, :, :2] for p in (None, 32, 8)}
    exact = tdec.merge_partials(*tdec.paged_decode_attention_ref(
        *args, round_p=False, **kw))[0][:, :, :2]
    step = 2e-2
    for p, o in outs.items():
        err = float((o - exact).abs().max())
        assert 0 < err < step, (p, err)
    assert float((outs[None] - outs[8]).abs().max()) > 1e-5
    # the CPU wrapper computes the plain version at the kernel's grouping
    got = tdec.merge_partials(*tdec.paged_decode_attention(*args, **kw))[0]
    assert torch.equal(got[:, :, :2], outs[tdec.P_TILE])
