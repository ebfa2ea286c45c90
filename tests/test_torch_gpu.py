"""The port's CUDA kernels (K1 dense forward, K2 dQ, K3 dK/dV, K4 decode,
K5 varlen forward, K6 varlen dQ, K7 varlen dK/dV, K8 paged prefill) and the
entry points that reach them, on the card,
against their plain PyTorch versions on the same device.  Every test takes the `cuda` fixture, which skips where no CUDA
device is present; on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks.)

Gates: kernel outputs and LSEs by the tolerance model of utils/testing.py
(error against the fp32 plain version within 2x the same-dtype plain
version's error + 1e-5; gradients 3x + 1e-4); an LSE of -inf (no live key)
must match exactly; dropout keep masks and two backward calls bit-equal;
appended cache payloads without rotary bit-equal to the CPU append.
"""

import numpy as np
import pytest
import torch

from flash_attn_v100_tpu_torch import ModelConfig, ServingEngine
from flash_attn_v100_tpu_torch.models import transformer as tmodel
from flash_attn_v100_tpu_torch.ops import flash_attention as fa_mod
from flash_attn_v100_tpu_torch.ops import kvcache as kv
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops import padding as padlib
from flash_attn_v100_tpu_torch.ops import quant
from flash_attn_v100_tpu_torch.ops import varlen as varlen_mod
from flash_attn_v100_tpu_torch.ops.cuda import build
from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
from flash_attn_v100_tpu_torch.ops.cuda import decode as dec
from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
from flash_attn_v100_tpu_torch.runtime import engine as eng_mod
from flash_attn_v100_tpu_torch.utils.testing import (
    assert_bwd_close, assert_close_rel, assert_fwd_close)

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}
HEAD_DIMS = (32, 64, 128, 256)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()          # every kernel, nvcc processes in parallel
    return torch.device("cuda")


def _gate_lse(lse, lse32, lse_nat, name):
    fin = torch.isfinite(lse32)
    assert torch.equal(fin, torch.isfinite(lse)), f"{name}: -inf rows differ"
    if fin.any():
        assert_fwd_close(lse[fin], lse32[fin], lse_nat[fin], name=name)


# ------------------------------------------------------------ K1, K2, K3

# name: (B, Hq, Hk, M, N, mask kwargs, alibi, dropout_p, ring extras)
DENSE_CASES = {
    "causal_gqa": (2, 8, 2, 200, 200, dict(causal=True), False, 0.0, {}),
    "m_gt_n_causal_empty_rows": (1, 4, 2, 256, 100, dict(causal=True), False,
                                 0.0, {}),
    "window_softcap_alibi_cross": (2, 4, 4, 130, 190,
                                   dict(window_left=32, window_right=8,
                                        softcap=20.0), True, 0.0, {}),
    "dropout_gqa_causal": (2, 4, 1, 160, 160, dict(causal=True), False, 0.15,
                           {}),
    "ring_offset_pos_base_dropout": (
        1, 4, 2, 128, 192, dict(causal=True), False, 0.1,
        dict(offset=-20, pos_base=(256, 64, 1, 4), num_heads_total=16)),
    # the backward's tile edges: M and N off every tile size, group 8,
    # causal spans with both interior and diagonal tiles, a window that
    # leaves whole tiles dead, M > N and M < N under causal masking, and
    # B 2 x S 2048 x 32/4 heads, several waves of blocks
    "one_row_one_key": (1, 2, 1, 1, 1, {}, False, 0.0, {}),
    "ragged_63_65_causal": (2, 4, 2, 63, 65, dict(causal=True), False, 0.0,
                            {}),
    "ragged_65_63_causal": (2, 4, 2, 65, 63, dict(causal=True), False, 0.0,
                            {}),
    "ragged_129_1000": (1, 4, 2, 129, 1000, {}, False, 0.0, {}),
    "ragged_1000_129_causal": (1, 4, 2, 1000, 129, dict(causal=True), False,
                               0.0, {}),
    "ragged_1000_causal_dropout": (1, 4, 2, 1000, 1000, dict(causal=True),
                                   False, 0.1, {}),
    "group8_causal": (2, 8, 1, 200, 200, dict(causal=True), False, 0.0, {}),
    "causal_1024_group8": (1, 8, 1, 1024, 1024, dict(causal=True), False,
                           0.0, {}),
    "window_dead_tiles": (1, 4, 2, 640, 640,
                          dict(window_left=40, window_right=0), False, 0.0,
                          {}),
    "causal_m_lt_n": (1, 4, 2, 300, 700, dict(causal=True), False, 0.0, {}),
    "causal_m_gt_n": (1, 4, 2, 700, 300, dict(causal=True), False, 0.0, {}),
    "multi_wave": (2, 32, 4, 2048, 2048, dict(causal=True), False, 0.0, {}),
    # the forward's 128-row q tiles: M one short of, one past and half a
    # tile past a tile edge, causal with M != N
    "m127_n200_causal": (2, 4, 2, 127, 200, dict(causal=True), False, 0.0,
                         {}),
    "m129_n100_causal": (2, 4, 2, 129, 100, dict(causal=True), False, 0.0,
                         {}),
    "m193_n300_causal_dropout": (1, 4, 1, 193, 300, dict(causal=True), False,
                                 0.1, {}),
}
DENSE_SEED = torch.tensor([0x2468ACE0, 0x80000007], dtype=torch.int64)


def _dense_inputs(name, dtype, D, dev):
    B, Hq, Hk, M, N, mkw, alibi, p, extras = DENSE_CASES[name]
    rng = np.random.default_rng(29)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    q, k, v, do = t(B, M, Hq, D), t(B, N, Hk, D), t(B, N, Hk, D), \
        t(B, M, Hq, D)
    slopes = torch.from_numpy(rng.uniform(0.01, 0.2, (B, Hq)).astype(
        np.float32)).to(dev) if alibi else None
    kw = dict(alibi_slopes=slopes, dropout_p=p, dropout_seed=DENSE_SEED,
              **extras)
    params = masklib.MaskParams(has_alibi=alibi, **mkw)
    return (q, k, v, D ** -0.5, params), do, kw


@pytest.mark.parametrize("name", list(DENSE_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_dense_kernels_match_plain(cuda, dt, D, name):
    args, do, kw = _dense_inputs(name, DTYPES[dt], D, cuda)
    launches = (dfwd.flash_attn_dense_fwd.launches, dbwd.dq_kernel.launches,
                dbwd.dkv_kernel.launches)
    out, lse = dfwd.flash_attn_dense_fwd(*args, **kw)
    grads = dbwd.flash_attn_dense_bwd(*args[:3], out, do, lse, *args[3:],
                                      **kw)
    torch.cuda.synchronize()
    assert (dfwd.flash_attn_dense_fwd.launches, dbwd.dq_kernel.launches,
            dbwd.dkv_kernel.launches) == tuple(n + 1 for n in launches)
    o32, lse32 = dfwd.flash_attn_dense_fwd_ref(*args, **kw)
    onat, lsenat = dfwd.flash_attn_dense_fwd_ref(*args, upcast=False, **kw)
    assert_fwd_close(out, o32, onat, name=f"K1 {name} out")
    _gate_lse(lse, lse32, lsenat, f"K1 {name} lse")
    # the backward from the kernel's own out and lse, against the plain
    # backward from the same out and lse
    g32 = dbwd.flash_attn_dense_bwd_ref(*args[:3], out, do, lse, *args[3:],
                                        **kw)
    gnat = dbwd.flash_attn_dense_bwd_ref(*args[:3], out, do, lse, *args[3:],
                                         upcast=False, **kw)
    for g, gr32, grn, what in zip(grads, g32, gnat, ("K2 dq", "K3 dk",
                                                     "K3 dv")):
        assert g.dtype == args[0].dtype and g.shape == gr32.shape
        assert_bwd_close(g, gr32, grn, name=f"{what} {name}")
    # rows with no live key (the LSE gate fixed which) get dq = 0
    assert not grads[0][torch.isneginf(lse).transpose(1, 2)].any()
    if name.startswith("m_gt_n"):
        dead = args[0].shape[1] - args[1].shape[1]
        assert torch.isneginf(lse[:, :, :dead]).all()
        assert not out[:, :dead].any() and not grads[0][:, :dead].any()


def test_dense_backward_bitwise_deterministic(cuda):
    args, do, kw = _dense_inputs("dropout_gqa_causal", torch.bfloat16, 64,
                                 cuda)
    out, lse = dfwd.flash_attn_dense_fwd(*args, **kw)
    g1 = dbwd.flash_attn_dense_bwd(*args[:3], out, do, lse, *args[3:], **kw)
    g2 = dbwd.flash_attn_dense_bwd(*args[:3], out, do, lse, *args[3:], **kw)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_dense_kernels_dropout_masks_bit_equal(cuda, dt):
    """Read the kernels' keep masks back: with q = 0 every live score is 0,
    so with v = I (N = D = 64) K1 gives out[i, j] = keep(i, j) / (64 (1-p))
    and, with dout = I, K3 gives dv[j, i] = keep(i, j) / (64 (1-p))."""
    B, H, n, p = 2, 4, 64, 0.3
    dtype = DTYPES[dt]
    eye = torch.eye(n, device=cuda, dtype=dtype)
    q = torch.zeros((B, n, H, n), device=cuda, dtype=dtype)
    v = eye[None, :, None, :].expand(B, n, H, n).contiguous()
    kw = dict(dropout_p=p, dropout_seed=DENSE_SEED, pos_base=(5, 640, 1, 3),
              num_heads_total=16)
    params = masklib.MaskParams()
    out, lse = dfwd.flash_attn_dense_fwd(q, q, v, 0.125, params, **kw)
    _, _, dv = dbwd.flash_attn_dense_bwd(q, q, v, out, v, lse, 0.125,
                                         params, **kw)
    keep = torch.stack([dfwd.dense_keep_mask(b, H, n, n, p, DENSE_SEED,
                                             kw["pos_base"], 16, cuda)
                        for b in range(B)])                 # (B, H, i, j)
    assert torch.equal(out.permute(0, 2, 1, 3) > 0, keep)
    assert torch.equal(dv.permute(0, 2, 3, 1) > 0, keep)


def test_dense_kernels_reject_fp32(cuda):
    args, do, kw = _dense_inputs("causal_gqa", torch.float32, 64, cuda)
    with pytest.raises(TypeError):
        dfwd.flash_attn_dense_fwd(*args, **kw)


def test_flash_attn_func_padded_head_dim(cuda):
    """head_dim 40: padded to 64 by the kernel wrappers and sliced back."""
    rng = np.random.default_rng(8)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda, torch.bfloat16)
        for s in ((2, 96, 4, 40), (2, 96, 2, 40), (2, 96, 2, 40),
                  (2, 96, 4, 40)))

    def run():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa_mod.flash_attn_func(*leaves, causal=True)
        (out.float() * do.float()).sum().backward()
        return out.detach(), [t.grad for t in leaves]

    out, grads = run()
    plain = {}
    for upcast in (True, False):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(fa_mod, "flash_attn_dense_fwd", lambda *a, **k_: (
                dfwd.flash_attn_dense_fwd_ref(*a, upcast=upcast, **k_)))
            m.setattr(fa_mod, "flash_attn_dense_bwd", lambda *a, **k_: (
                dbwd.flash_attn_dense_bwd_ref(*a, upcast=upcast, **k_)))
            plain[upcast] = run()
    assert out.shape == q.shape
    assert_fwd_close(out, plain[True][0], plain[False][0], name="out")
    for i, what in enumerate(("dq", "dk", "dv")):
        assert_bwd_close(grads[i], plain[True][1][i], plain[False][1][i],
                         name=what)


def test_train_step_runs_the_kernels(cuda, monkeypatch):
    """One loss/backward of a small bf16 model through K1-K3: 1 launch of
    each per layer, loss and gradients within the gates of the same step
    through the plain versions."""
    cfg = _tiny(torch.bfloat16)
    params = tmodel.init_params(cfg, seed=5, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 129))).to(cuda)

    def run():
        leaves = dict(params, layers=[
            {k: t.detach().clone().requires_grad_() for k, t in lp.items()}
            for lp in params["layers"]])
        loss = tmodel.loss_fn(leaves, tokens, cfg)
        loss.backward()
        return loss.detach(), leaves["layers"][0]["wq"].grad

    before = (dfwd.flash_attn_dense_fwd.launches, dbwd.dq_kernel.launches,
              dbwd.dkv_kernel.launches)
    loss, g = run()
    assert (dfwd.flash_attn_dense_fwd.launches - before[0],
            dbwd.dq_kernel.launches - before[1],
            dbwd.dkv_kernel.launches - before[2]) == (cfg.n_layers,) * 3
    plain = {}
    for upcast in (True, False):
        with monkeypatch.context() as m:
            m.setattr(fa_mod, "flash_attn_dense_fwd", lambda *a, **k_: (
                dfwd.flash_attn_dense_fwd_ref(*a, upcast=upcast, **k_)))
            m.setattr(fa_mod, "flash_attn_dense_bwd", lambda *a, **k_: (
                dbwd.flash_attn_dense_bwd_ref(*a, upcast=upcast, **k_)))
            plain[upcast] = run()
    assert torch.isfinite(loss)
    assert_close_rel(loss, plain[True][0], plain[False][0], 2.0, 1e-5,
                     name="loss")
    assert_bwd_close(g, plain[True][1], plain[False][1], name="layer 0 dwq")


# ------------------------------------------------------------------ K4

# name: (group, t_new, num_splits, mask kwargs, leftpad, alibi, layout)
DECODE_CASES = {
    "t1": (8, 1, 0, dict(window_right=0), False, False, "pool"),
    "t1_leftpad_splits3": (8, 1, 3, dict(window_right=0), True, False,
                           "pool"),
    "t4_window_softcap_alibi": (
        8, 4, 0, dict(causal=True, window_left=40, window_right=0,
                      softcap=20.0), True, True, "pool"),
    "t1_empty_row_splits1": (8, 1, 1, dict(window_right=0), False, False,
                             "pool"),
    "t16_group4_contiguous": (4, 16, 0, dict(causal=True, window_right=0),
                              False, False, "contiguous"),
}


def _decode_inputs(name, dtype, D, dev):
    group, t_new, splits, mkw, leftpad, alibi, layout = DECODE_CASES[name]
    rng = np.random.default_rng(7)
    B, Hk, ps, max_pages = 3, 2, 32, 8
    cap = ps * max_pages
    n_rows = group * t_new
    Rq = max(-(-n_rows // 8) * 8, 8)
    lens = rng.integers(t_new + 1, cap - 40, B).astype(np.int32)
    lp = (rng.integers(0, 40, B) if leftpad else np.zeros(B)).astype(np.int32)
    if name.startswith("t1_empty_row"):
        lens[0] = 0
    q = rng.standard_normal((B, Hk, Rq, D)).astype(np.float32)
    q[:, :, n_rows:] = 0.0
    if layout == "contiguous":
        # a contiguous (B, Hk, N, D) cache seen as pages: id b * nb + i
        k = rng.standard_normal((B, Hk, cap, D)).astype(np.float32)
        v = rng.standard_normal((B, Hk, cap, D)).astype(np.float32)
        k, v = (x.reshape(B, Hk, max_pages, ps, D) for x in (k, v))
        tbl = (np.arange(B)[:, None] * max_pages
               + np.arange(max_pages)[None]).astype(np.int32)
    else:
        P = B * max_pages + 1
        k = rng.standard_normal((1, Hk, P, ps, D)).astype(np.float32)
        v = rng.standard_normal((1, Hk, P, ps, D)).astype(np.float32)
        tbl = rng.permutation(np.arange(1, P)).reshape(B, max_pages)
        tbl = tbl.astype(np.int32)
    slopes = rng.uniform(0.01, 0.2, (B, Hk, Rq, 1)).astype(np.float32)

    def t(x, dt=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)

    args = (t(q, dtype), t(k, dtype), t(v, dtype), t(tbl), t(lens), t(lp))
    kw = dict(qpos_vec=t(lens - t_new), softmax_scale=D ** -0.5,
              params=masklib.MaskParams(has_alibi=alibi, **mkw), t_new=t_new,
              group=group, num_splits=splits,
              alibi_slopes_rows=t(slopes) if alibi else None)
    return args, kw


@pytest.mark.parametrize("name", list(DECODE_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_decode_kernel_matches_plain(cuda, dt, D, name):
    args, kw = _decode_inputs(name, DTYPES[dt], D, cuda)
    before = dec.paged_decode_attention.launches
    o, lse = dec.merge_partials(*dec.paged_decode_attention(*args, **kw))
    torch.cuda.synchronize()
    assert dec.paged_decode_attention.launches == before + 1
    o32, lse32 = dec.merge_partials(*dec.paged_decode_attention_ref(
        *args, **kw))
    onat, lsenat = dec.merge_partials(*dec.paged_decode_attention_ref(
        *args, upcast=False, **kw))
    assert_fwd_close(o, o32, onat, name=f"K4 {name} out")
    _gate_lse(lse, lse32, lsenat, f"K4 {name} lse")
    if name.startswith("t1_empty_row"):
        assert torch.isneginf(lse[0]).all() and not o[0].any()


# ------------------------------------------------------------------ K8

# name: (q lens, cache prefixes, leftpad, seqused cut, page size, mask kwargs,
#        alibi)
VARLEN_CASES = {
    "causal_prefix": ([100, 1, 71], [0, 130, 257], None, None, 128,
                      dict(causal=True, window_right=0), False),
    "window_softcap_alibi": ([64, 129, 33], [5, 0, 300], None, None, 128,
                             dict(causal=True, window_left=50,
                                  window_right=0, softcap=20.0), True),
    "seqused_leftpad": ([90, 40, 17], [60, 200, 3], [0, 7, 19], [0, 5, 20],
                        128, dict(causal=True, window_right=0), False),
    "ps256_empty_rows": ([0, 80, 30], [10, 0, 140], None, [0, 0, 170], 256,
                         dict(causal=True, window_right=0), False),
}


def _varlen_inputs(name, dtype, D, dev, cases=VARLEN_CASES):
    qlens, prefix, lp, cut, ps, mkw, alibi = cases[name]
    rng = np.random.default_rng(11)
    Hq, Hk = 8, 2
    qlens, prefix = np.asarray(qlens), np.asarray(prefix)
    B = len(qlens)
    lp = np.zeros(B, np.int64) if lp is None else np.asarray(lp)
    seqlens = lp + prefix + qlens
    # a cut past a sequence's length leaves it seqused_k = 0
    seqused = None if cut is None else np.maximum(seqlens - np.asarray(cut),
                                                  0)
    max_k = int(seqlens.max())
    mp = -(-max_k // ps)
    P = B * mp + 1
    k = rng.standard_normal((Hk, P, ps, D)).astype(np.float32)
    v = rng.standard_normal((Hk, P, ps, D)).astype(np.float32)
    tbl = rng.permutation(np.arange(1, P)).reshape(B, mp).astype(np.int32)
    q = rng.standard_normal((int(qlens.sum()), Hq, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    slopes = rng.uniform(0.01, 0.2, (B, Hq)).astype(np.float32)

    def t(x, dt=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)

    def i32(x):
        return None if x is None else t(np.asarray(x, np.int32))

    args = (t(q, dtype), t(k, dtype), t(v, dtype), t(tbl), t(cu),
            i32(seqlens), int(qlens.max()), max_k, D ** -0.5,
            masklib.MaskParams(has_alibi=alibi, **mkw))
    kw = dict(alibi_slopes=t(slopes) if alibi else None,
              seqused_k=i32(seqused),
              leftpad_k=None if cases[name][2] is None else i32(lp))
    return args, kw


@pytest.mark.parametrize("name", list(VARLEN_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_varlen_kernel_matches_plain(cuda, dt, D, name):
    args, kw = _varlen_inputs(name, DTYPES[dt], D, cuda)
    before = vl.flash_attn_varlen_fwd_paged.launches
    out, lse = vl.flash_attn_varlen_fwd_paged(*args, **kw)
    torch.cuda.synchronize()
    assert vl.flash_attn_varlen_fwd_paged.launches == before + 1
    o32, lse32 = vl.flash_attn_varlen_fwd_paged_ref(*args, **kw)
    onat, lsenat = vl.flash_attn_varlen_fwd_paged_ref(*args, upcast=False,
                                                      **kw)
    assert_fwd_close(out, o32, onat, name=f"K8 {name} out")
    _gate_lse(lse, lse32, lsenat, f"K8 {name} lse")


def test_kernels_reject_fp32_and_bad_shapes(cuda):
    args, kw = _decode_inputs("t1", torch.float32, 64, cuda)
    with pytest.raises(TypeError):
        dec.paged_decode_attention(*args, **kw)
    args, kw = _decode_inputs("t1", torch.bfloat16, 48, cuda)
    with pytest.raises(ValueError):
        dec.paged_decode_attention(*args, **kw)
    args, kw = _varlen_inputs("causal_prefix", torch.float32, 64, cuda)
    with pytest.raises(TypeError):
        vl.flash_attn_varlen_fwd_paged(*args, **kw)


# ------------------------------------------------------------ K5, K6, K7

# name: (q lens, k lens, extra q rows, extra keys, Hq, Hk, mask kwargs,
#        alibi, dropout_p, seqused_k, leftpad_k)
PACKED_CASES = {
    "causal_gqa_ragged": ([37, 200, 1, 130], None, 0, 0, 8, 2,
                          dict(causal=True), False, 0.0, None, None),
    "cross_window_softcap_alibi": ([16, 48, 70], [128, 96, 70], 0, 0, 4, 4,
                                   dict(window_left=32, window_right=8,
                                        softcap=20.0), True, 0.0, None,
                                   None),
    "dropout_gqa_causal": ([100, 64, 150], None, 0, 0, 4, 1,
                           dict(causal=True), False, 0.15, None, None),
    "seqused_leftpad_uncovered": ([64, 40, 90], [100, 60, 120], 9, 7, 4, 2,
                                  dict(causal=True), False, 0.0,
                                  [80, 0, 110], [5, 3, 17]),
    # one token, a sequence with seqused_k = 0 and 2000 tokens: blocks that
    # leave at once among the heaviest-first ones
    "mixed_1_empty_2000": ([1, 300, 2000, 1], None, 0, 0, 8, 2,
                           dict(causal=True), False, 0.0, [1, 0, 2000, 1],
                           None),
}


def _packed_inputs(name, dtype, D, dev):
    (lq, lk, xq, xk, Hq, Hk, mkw, alibi, p, used, lp) = PACKED_CASES[name]
    lk = lq if lk is None else lk
    rng = np.random.default_rng(41)
    Tq, Tk = sum(lq) + xq, sum(lk) + xk

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    def i32(x):
        return None if x is None else torch.tensor(x, dtype=torch.int32,
                                                   device=dev)

    q, k, v, do = t(Tq, Hq, D), t(Tk, Hk, D), t(Tk, Hk, D), t(Tq, Hq, D)
    cu_q = i32(np.concatenate([[0], np.cumsum(lq)]).tolist())
    cu_k = i32(np.concatenate([[0], np.cumsum(lk)]).tolist())
    slopes = torch.from_numpy(rng.uniform(0.01, 0.2, (len(lq), Hq)).astype(
        np.float32)).to(dev) if alibi else None
    params = masklib.MaskParams(has_alibi=alibi, **mkw)
    args = (q, k, v, cu_q, cu_k, max(lq), max(lk), D ** -0.5, params)
    kw = dict(alibi_slopes=slopes, dropout_p=p, dropout_seed=DENSE_SEED,
              seqused_k=i32(used), leftpad_k=i32(lp))
    return args, do, kw


def _varlen_counts():
    return (vl.flash_attn_varlen_fwd.launches, vl.varlen_dq_kernel.launches,
            vl.varlen_dkv_kernel.launches)


@pytest.mark.parametrize("name", list(PACKED_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_varlen_kernels_match_plain(cuda, dt, D, name):
    args, do, kw = _packed_inputs(name, DTYPES[dt], D, cuda)
    q, k, v, cu_q, cu_k, msq, msk, scale, params = args
    before = _varlen_counts()
    out, lse = vl.flash_attn_varlen_fwd(*args, **kw)
    grads = vl.flash_attn_varlen_bwd(q, k, v, out, do, lse, cu_q, cu_k, msq,
                                     msk, scale, params, **kw)
    torch.cuda.synchronize()
    assert _varlen_counts() == tuple(n + 1 for n in before)
    o32, lse32 = vl.flash_attn_varlen_fwd_ref(*args, **kw)
    onat, lsenat = vl.flash_attn_varlen_fwd_ref(*args, upcast=False, **kw)
    assert_fwd_close(out, o32, onat, name=f"K5 {name} out")
    _gate_lse(lse, lse32, lsenat, f"K5 {name} lse")
    bargs = (q, k, v, out, do, lse, cu_q, cu_k, msq, msk, scale, params)
    g32 = vl.flash_attn_varlen_bwd_ref(*bargs, **kw)
    gnat = vl.flash_attn_varlen_bwd_ref(*bargs, upcast=False, **kw)
    for g, gr32, grn, what in zip(grads, g32, gnat, ("K6 dq", "K7 dk",
                                                     "K7 dv")):
        assert g.dtype == q.dtype and g.shape == gr32.shape
        assert_bwd_close(g, gr32, grn, name=f"{what} {name}")
    # rows and keys that no sequence covers read exactly 0 / -inf
    live_q = torch.zeros(q.shape[0], dtype=torch.bool, device=cuda)
    live_k = torch.zeros(k.shape[0], dtype=torch.bool, device=cuda)
    for q0, slq, k0, slk, _ in vl.seq_bounds(cu_q, cu_k, kw["seqused_k"],
                                             kw["leftpad_k"]):
        live_q[q0:q0 + slq] = slk > 0
        live_k[k0:k0 + max(slk, 0)] = True
    assert not out[~live_q].any() and not grads[0][~live_q].any()
    assert torch.isneginf(lse[:, ~live_q]).all()
    assert not grads[1][~live_k].any() and not grads[2][~live_k].any()


def test_varlen_backward_bitwise_deterministic(cuda):
    args, do, kw = _packed_inputs("dropout_gqa_causal", torch.bfloat16, 64,
                                  cuda)
    q, k, v, cu_q, cu_k, msq, msk, scale, params = args
    out, lse = vl.flash_attn_varlen_fwd(*args, **kw)
    bargs = (q, k, v, out, do, lse, cu_q, cu_k, msq, msk, scale, params)
    g1 = vl.flash_attn_varlen_bwd(*bargs, **kw)
    g2 = vl.flash_attn_varlen_bwd(*bargs, **kw)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_forward_bitwise_deterministic(cuda):
    """K1 and K5 give the same out and LSE bits on two calls."""
    args, _, kw = _dense_inputs("m193_n300_causal_dropout", torch.bfloat16,
                                64, cuda)
    one = dfwd.flash_attn_dense_fwd(*args, **kw)
    two = dfwd.flash_attn_dense_fwd(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    args, _, kw = _packed_inputs("mixed_1_empty_2000", torch.bfloat16, 128,
                                 cuda)
    one = vl.flash_attn_varlen_fwd(*args, **kw)
    two = vl.flash_attn_varlen_fwd(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_varlen_kernels_dropout_masks_bit_equal(cuda, dt):
    """Read K5's and K7's keep masks back as in the dense test: 64 keys
    and 64 q rows a sequence, q = 0, v = I (K5: out[i, j] = keep(i, j) /
    (64 (1 - p))) and dout = I (K7: dv[j, i] likewise)."""
    B, H, n, p = 3, 4, 64, 0.3
    dtype = DTYPES[dt]
    eye = torch.eye(n, device=cuda, dtype=dtype)
    q = torch.zeros((B * n, H, n), device=cuda, dtype=dtype)
    v = eye[None, :, None, :].expand(B, n, H, n).reshape(B * n, H, n)
    v = v.contiguous()
    cu = torch.arange(B + 1, dtype=torch.int32, device=cuda) * n
    params = masklib.MaskParams()
    kw = dict(dropout_p=p, dropout_seed=DENSE_SEED)
    out, lse = vl.flash_attn_varlen_fwd(q, q, v, cu, cu, n, n, 0.125, params,
                                        **kw)
    _, _, dv = vl.flash_attn_varlen_bwd(q, q, v, out, v, lse, cu, cu, n, n,
                                        0.125, params, **kw)
    keep = varlen_mod.varlen_dropout_mask(cu, B * n, H, n, p, DENSE_SEED,
                                          cuda)                # (i, h, j)
    assert torch.equal(out > 0, keep)
    dv_keep = dv.view(B, n, H, n).permute(0, 3, 2, 1).reshape(B * n, H, n)
    assert torch.equal(dv_keep > 0, keep)


@pytest.mark.parametrize("p", [0.0, 0.2])
def test_varlen_equal_lengths_bit_equal_to_flash_attn_func(cuda, p,
                                                           monkeypatch):
    """cu_seqlens = b * S: K5 is K1's body and K6/K7 are K2/K3's on the
    same sequences, so out, LSE, the dropout mask and dq, dk, dv agree bit
    for bit; the gradients of both paths are also held to the plain
    backward's gate."""
    B, S, Hq, Hk, D = 3, 200, 8, 2, 64
    rng = np.random.default_rng(12)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda, torch.bfloat16)
        for s in ((B, S, Hq, D), (B, S, Hk, D), (B, S, Hk, D),
                  (B, S, Hq, D)))
    cu = torch.arange(B + 1, dtype=torch.int32, device=cuda) * S
    kw = dict(dropout_p=p, dropout_seed=DENSE_SEED, causal=True,
              return_attn_probs=True)
    dense = [t.clone().requires_grad_() for t in (q, k, v)]
    out_d, lse_d, mask_d = fa_mod.flash_attn_func(*dense, **kw)
    out_d.backward(do)

    def varlen():
        packed = [t.reshape(B * S, *t.shape[2:]).clone().requires_grad_()
                  for t in (q, k, v)]
        out, lse, mask = varlen_mod.flash_attn_varlen_func(
            *packed, cu, cu, S, S, **kw)
        out.backward(do.reshape(B * S, Hq, D))
        return out, lse, mask, [t.grad for t in packed]

    out_v, lse_v, mask_v, grads = varlen()
    assert torch.equal(out_v, out_d.reshape(B * S, Hq, D))
    assert torch.equal(lse_v, lse_d.permute(1, 0, 2).reshape(Hq, B * S))
    if p:
        assert torch.equal(mask_v, mask_d.permute(0, 2, 1, 3).reshape(
            B * S, Hq, S))
    plain = {}
    for upcast in (True, False):
        with monkeypatch.context() as m:
            _plain_varlen(m, upcast)
            plain[upcast] = varlen()[3]
    for g, gd, r32, rn, what in zip(grads, dense, plain[True], plain[False],
                                    ("dq", "dk", "dv")):
        assert_bwd_close(g, r32, rn, name=f"varlen {what}")
        gd = gd.grad.reshape(g.shape)
        assert_bwd_close(gd, r32, rn, name=f"flash_attn_func {what}")
        assert torch.equal(g, gd), f"{what}: varlen vs flash_attn_func"


@pytest.mark.parametrize("name", ["causal_gqa_ragged",
                                  "cross_window_softcap_alibi"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_varlen_sequences_bit_equal_to_flash_attn_func_alone(cuda, dt, D,
                                                             name):
    """Each packed sequence's dq, dk and dv from flash_attn_varlen_func
    equal flash_attn_func's on that sequence alone, bit for bit: K6/K7 run
    K2/K3's body with the sequence's bounds (causal, GQA, cross-attention,
    window, softcap and ALiBi; no dropout, whose keep mask is keyed by the
    sequence index)."""
    args, do, kw = _packed_inputs(name, DTYPES[dt], D, cuda)
    q, k, v, cu_q, cu_k, msq, msk, scale, params = args
    slopes = kw["alibi_slopes"]
    fkw = dict(softmax_scale=scale, causal=params.causal,
               window_size=(params.window_left, params.window_right),
               softcap=params.softcap)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = varlen_mod.flash_attn_varlen_func(*leaves, cu_q, cu_k, msq, msk,
                                            alibi_slopes=slopes, **fkw)
    out.backward(do)
    for b, (q0, slq, k0, slk, _) in enumerate(vl.seq_bounds(cu_q, cu_k)):
        sq, sk = slice(q0, q0 + slq), slice(k0, k0 + slk)
        alone = [t[None, s].clone().requires_grad_()
                 for t, s in ((q, sq), (k, sk), (v, sk))]
        o = fa_mod.flash_attn_func(
            *alone, alibi_slopes=None if slopes is None else slopes[b:b + 1],
            **fkw)
        assert torch.equal(o[0], out[sq].detach()), f"sequence {b} out"
        o.backward(do[None, sq])
        for g, t, s, what in zip((leaves[0].grad, leaves[1].grad,
                                  leaves[2].grad), alone, (sq, sk, sk),
                                 ("dq", "dk", "dv")):
            assert torch.equal(g[s], t.grad[0]), f"sequence {b} {what}"


@pytest.mark.parametrize("D", [64, 128])
def test_varlen_backward_kernels_use_no_local_memory(cuda, D):
    """K6 and K7, the varlen instantiation of K2/K3's body, in bf16 and
    fp16, with and without bias/dropout: no spills or stack (local memory)
    and at least 8 warps resident a multiprocessor."""
    import ctypes
    lib = build.load("bwd")
    for dkv in (0, 1):
        for dtype in (0, 1):
            for extra in (0, 1):
                out = (ctypes.c_int * 5)()
                rc = lib.fa_varlen_bwd_occupancy(dkv, dtype, D, extra,
                                                 ctypes.addressof(out))
                assert rc == 0
                blocks, _, threads, _, local = out
                what = f"K{6 + dkv} dtype {dtype} extra {extra}"
                assert local == 0, f"{what}: {local} B of local memory"
                assert blocks * threads // 32 >= 8, f"{what}: {blocks} blocks"


def _plain_varlen(monkeypatch, upcast):
    """Point flash_attn_varlen_func at the plain versions."""
    monkeypatch.setattr(varlen_mod, "flash_attn_varlen_fwd", lambda *a, **k_:
                        vl.flash_attn_varlen_fwd_ref(*a, upcast=upcast, **k_))
    monkeypatch.setattr(varlen_mod, "flash_attn_varlen_bwd", lambda *a, **k_:
                        vl.flash_attn_varlen_bwd_ref(*a, upcast=upcast, **k_))
    monkeypatch.setattr(varlen_mod, "flash_attn_varlen_fwd_paged",
                        lambda *a, **k_: vl.flash_attn_varlen_fwd_paged_ref(
                            *a, upcast=upcast, **k_))


def test_varlen_func_padded_head_dim_unpad_pad(cuda, monkeypatch):
    """head_dim 40 (padded to 64 by the wrappers) through unpad_input ->
    flash_attn_varlen_func -> pad_input and backward, against the same
    path through the plain versions."""
    B, S, Hq, Hk, D = 3, 96, 4, 2, 40
    rng = np.random.default_rng(13)
    x = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        cuda, torch.bfloat16) for s in ((B, S, Hq, D), (B, S, Hk, D),
                                        (B, S, Hk, D), (B, S, Hq, D))]
    mask = (torch.arange(S, device=cuda)[None, :]
            < torch.tensor([96, 50, 7], device=cuda)[:, None])

    def run():
        leaves = [t.clone().requires_grad_() for t in x[:3]]
        qu, idx, cu, ms, _ = padlib.unpad_input(leaves[0], mask)
        ku, vu = (padlib.unpad_input(t, mask)[0] for t in leaves[1:])
        o = varlen_mod.flash_attn_varlen_func(qu, ku, vu, cu, cu, ms, ms,
                                              causal=True)
        out = padlib.pad_input(o, idx, B, S)
        (out.float() * x[3].float()).sum().backward()
        return out.detach(), [t.grad for t in leaves]

    before = _varlen_counts()
    out, grads = run()
    assert _varlen_counts() == tuple(n + 1 for n in before)
    plain = {}
    for upcast in (True, False):
        with monkeypatch.context() as m:
            _plain_varlen(m, upcast)
            plain[upcast] = run()
    assert out.shape == x[0].shape and not out[2, 7:].any()
    assert_fwd_close(out, plain[True][0], plain[False][0], name="out")
    for i, what in enumerate(("dq", "dk", "dv")):
        assert_bwd_close(grads[i], plain[True][1][i], plain[False][1][i],
                         name=what)


def _paged_pool(packed, lens, ps, dev, dtype):
    """Packed (Tk, Hk, D) -> NHD pool (P, ps, Hk, D), shuffled pages."""
    pages = [-(-n // ps) for n in lens]
    P = sum(pages) + 1
    ids = np.random.default_rng(ps).permutation(np.arange(1, P))
    pool = torch.zeros((P, ps) + tuple(packed.shape[1:]), device=dev,
                       dtype=dtype)
    table = np.zeros((len(lens), max(pages)), np.int32)
    at = off = 0
    for b, n in enumerate(lens):
        for j in range(pages[b]):
            m = min(ps, n - j * ps)
            pool[ids[at], :m] = packed[off + j * ps:off + j * ps + m]
            table[b, j] = ids[at]
            at += 1
        off += n
    return pool, torch.from_numpy(table).to(dev)


@pytest.mark.parametrize("route", ["hnd", "nhd128", "nhd_gather"])
def test_varlen_block_table_routes_match_plain(cuda, route, monkeypatch):
    lq, lk, Hq, Hk, D = [64, 100, 17], [300, 128, 37], 8, 2, 64
    rng = np.random.default_rng(17)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda, torch.bfloat16)

    q, k, v, do = t(sum(lq), Hq, D), t(sum(lk), Hk, D), t(sum(lk), Hk, D), \
        t(sum(lq), Hq, D)
    ps = 32 if route == "nhd_gather" else 128
    kp, table = _paged_pool(k, lk, ps, cuda, torch.bfloat16)
    vp, _ = _paged_pool(v, lk, ps, cuda, torch.bfloat16)
    layout = "NHD"
    if route == "hnd":
        kp, vp = (x.permute(2, 0, 1, 3).contiguous() for x in (kp, vp))
        layout = "HND"
    cu_q = torch.tensor(np.concatenate([[0], np.cumsum(lq)]),
                        dtype=torch.int32, device=cuda)
    cu_k = torch.tensor(np.concatenate([[0], np.cumsum(lk)]),
                        dtype=torch.int32, device=cuda)

    def run():
        leaves = [x.clone().requires_grad_() for x in (q, kp, vp)]
        out = varlen_mod.flash_attn_varlen_func(
            *leaves, cu_q, cu_k, max(lq), max(lk), causal=True,
            block_table=table, kv_cache_layout=layout)
        if route != "nhd_gather":
            assert out.grad_fn is None
            return out, []
        out.backward(do)
        return out.detach(), [x.grad for x in leaves]

    before = (vl.flash_attn_varlen_fwd_paged.launches, *_varlen_counts())
    out, grads = run()
    after = (vl.flash_attn_varlen_fwd_paged.launches, *_varlen_counts())
    expect = (1, 0, 0, 0) if route != "nhd_gather" else (0, 1, 1, 1)
    assert tuple(a - b for a, b in zip(after, before)) == expect
    plain = {}
    for upcast in (True, False):
        with monkeypatch.context() as m:
            _plain_varlen(m, upcast)
            plain[upcast] = run()
    assert_fwd_close(out, plain[True][0], plain[False][0], name="out")
    for i, g in enumerate(grads):
        assert_bwd_close(g, plain[True][1][i], plain[False][1][i],
                         name=f"grad {i}")


def test_varlen_paged_rows_past_the_last_sequence_read_zero(cuda):
    """K8 with 5 packed q rows past cu_q[B]: no block covers them, and they
    read O = 0 and LSE = -inf, as in the JAX package."""
    args, kw = _varlen_inputs("causal_prefix", torch.bfloat16, 64, cuda)
    q = torch.cat([args[0], torch.ones_like(args[0][:5])])
    out, lse = vl.flash_attn_varlen_fwd_paged(q, *args[1:], **kw)
    n = args[0].shape[0]
    assert not out[n:].any() and torch.isneginf(lse[:, n:]).all()
    assert out[:n].any()


def test_varlen_kernels_reject_fp32(cuda):
    args, do, kw = _packed_inputs("causal_gqa_ragged", torch.float32, 64,
                                  cuda)
    with pytest.raises(TypeError):
        vl.flash_attn_varlen_fwd(*args, **kw)


# ------------------------------------------------- flash_attn_with_kvcache

def _merged(o_part, lse_part, dtype):
    """The K4 route's merged (o in q's dtype, lse) from plain partials."""
    o, lse = dec.merge_partials(o_part, lse_part)
    return o.to(dtype), lse


def _plain(upcast):
    def decode(*a, **k):
        return _merged(*dec.paged_decode_attention_ref(*a, upcast=upcast,
                                                       **k), a[0].dtype)

    def varlen(*a, **k):
        return vl.flash_attn_varlen_fwd_paged_ref(*a, upcast=upcast, **k)
    return decode, varlen


# name: (paged, layout, T_new, append, rotary, dtype, extra kwargs)
KVCACHE_CASES = {
    "paged_nhd_decode_append_rotary": (True, "NHD", 1, True, "half", "bf16",
                                       {}),
    "paged_hnd_varlen_route_append_rotary": (True, "HND", 256, True,
                                             "interleaved", "bf16", {}),
    "paged_hnd_varlen_route_append": (True, "HND", 256, True, None, "fp16",
                                      dict(window_size=(100, -1))),
    "contig_hnd_append_leftpad_window": (
        False, "HND", 3, True, None, "fp16",
        dict(cache_leftpad=[4, 0, 9], window_size=(10, -1))),
    "contig_nhd_batch_idx_softcap_alibi": (
        False, "NHD", 2, True, "interleaved", "bf16",
        dict(cache_batch_idx=[2, 0, 1], softcap=8.0, alibi=True)),
    "paged_hnd_no_append_lse_splits2": (True, "HND", 1, False, None, "bf16",
                                        dict(num_splits=2)),
}


def _kvcache_inputs(name):
    paged, layout, T, append, rotary, dt, extra = KVCACHE_CASES[name]
    rng = np.random.default_rng(21)
    Hq, Hk, D = 8, 2, 64
    varlen = T * (Hq // Hk) >= kv.VARLEN_PREFILL_MIN_ROWS
    B, ps = (2, 128) if varlen else (3, 16)
    kw = dict(causal=True, kv_cache_layout=layout, return_softmax_lse=True)
    if paged:
        P, mp = 10, 4 if varlen else 8
        shape = (P, ps, Hk, D) if layout == "NHD" else (Hk, P, ps, D)
        kw["block_table"] = np.stack(
            [rng.permutation(np.arange(1, P))[:mp] for _ in range(B)]
        ).astype(np.int32)
        cap = mp * ps
    else:
        N = 64
        shape = (B, N, Hk, D) if layout == "NHD" else (B, Hk, N, D)
        cap = N - 12
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    kc, vc = mk(*shape), mk(*shape)
    cs = rng.integers(5, cap - T, size=B).astype(np.int32)
    q = mk(B, T, Hq, D)
    new = (mk(B, T, Hk, D), mk(B, T, Hk, D)) if append else (None, None)
    if rotary:
        ang = rng.uniform(0, 2 * np.pi, (cap + T, D // 2))
        kw.update(rotary_cos=np.cos(ang).astype(np.float32),
                  rotary_sin=np.sin(ang).astype(np.float32),
                  rotary_interleaved=rotary == "interleaved")
    extra = dict(extra)
    if extra.pop("alibi", False):
        kw["alibi_slopes"] = rng.uniform(0.01, 0.2, (B, Hq)).astype(np.float32)
    for key in ("cache_leftpad", "cache_batch_idx"):
        if key in extra:
            extra[key] = np.asarray(extra[key], np.int32)
    kw.update(extra)
    return DTYPES[dt], q, kc, vc, new, cs, kw, varlen


def _kvcache_call(dev, dtype, q, kc, vc, new, cs, kw):
    def t(x, dt=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)

    caches = (t(kc, dtype), t(vc, dtype))
    tkw = {k: (t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    res = kv.flash_attn_with_kvcache(
        t(q, dtype), *caches, k=None if new[0] is None else t(new[0], dtype),
        v=None if new[1] is None else t(new[1], dtype),
        cache_seqlens=t(cs), **tkw)
    return res, caches


@pytest.mark.parametrize("name", list(KVCACHE_CASES))
def test_kvcache_kernels_match_plain(cuda, name, monkeypatch):
    dtype, q, kc, vc, new, cs, kw, varlen = _kvcache_inputs(name)
    counter = (vl.flash_attn_varlen_fwd_paged if varlen
               else dec.paged_decode_attention)
    before = counter.launches
    res, caches = _kvcache_call(cuda, dtype, q, kc, vc, new, cs, kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1, "the call took the wrong route"
    plain = {}
    for upcast in (True, False):
        with monkeypatch.context() as m:
            fd, fv = _plain(upcast)
            m.setattr(kv, "paged_decode_attention_merged", fd)
            m.setattr(kv, "flash_attn_varlen_fwd_paged", fv)
            plain[upcast] = _kvcache_call(cuda, dtype, q, kc, vc, new, cs,
                                          kw)[0]
    assert len(res) == (3 if new[0] is not None else 2)
    assert_fwd_close(res[0], plain[True][0], plain[False][0],
                     name=f"{name} out")
    _gate_lse(res[1], plain[True][1], plain[False][1], f"{name} lse")
    if new[0] is not None:
        assert res[2][0] is caches[0] and res[2][1] is caches[1]
        if "rotary_cos" not in kw:
            # the append is a copy: bit-equal to the CPU append
            cpu_res, _ = _kvcache_call(torch.device("cpu"), dtype, q, kc, vc,
                                       new, cs, kw)
            assert torch.equal(res[2][0].cpu(), cpu_res[2][0])
            assert torch.equal(res[2][1].cpu(), cpu_res[2][1])


# ------------------------------------------------------- model and engine

def _tiny(dtype):
    # group 8 at head_dim 64, as TinyLlama; a 128-token prefill folds to
    # 1024 q rows and takes the K8 route
    return ModelConfig.tiny(vocab_size=512, dim=256, n_layers=2, n_heads=16,
                            n_kv_heads=2, head_dim=64, ffn_dim=512,
                            max_seq_len=512, dtype=dtype)


def test_decode_step_contiguous_matches_plain(cuda, monkeypatch):
    cfg = _tiny(torch.bfloat16)
    params = tmodel.init_params(cfg, seed=3, device=cuda)
    rng = np.random.default_rng(3)
    steps = [rng.integers(0, cfg.vocab_size, (2, 5)),
             rng.integers(0, cfg.vocab_size, (2, 1))]

    def run():
        caches = tmodel.init_kv_caches(cfg, 2, 64, device=cuda)
        cs = torch.zeros(2, dtype=torch.int32, device=cuda)
        outs = []
        for toks in steps:
            logits, caches = tmodel.decode_step(
                params, caches, torch.from_numpy(toks).to(cuda), cs, cfg)
            outs.append(logits)
            cs = cs + toks.shape[1]
        return outs

    before = dec.paged_decode_attention.launches
    got = run()
    assert dec.paged_decode_attention.launches - before == 2 * cfg.n_layers
    plain = {}
    for upcast in (True, False):
        with monkeypatch.context() as m:
            m.setattr(kv, "paged_decode_attention_merged", _plain(upcast)[0])
            plain[upcast] = run()
    for i, logits in enumerate(got):
        assert_close_rel(logits, plain[True][i], plain[False][i], 2.0, 1e-5,
                         name=f"decode_step {i} logits")


def test_engine_fp16_runs_both_kernels(cuda):
    cfg = _tiny(torch.float16)
    params = tmodel.init_params(cfg, seed=4, device=cuda, lm_head=True)
    eng = ServingEngine(params, cfg, max_batch=4, num_pages=16,
                        page_size=128, device=cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (128, 100, 9)]
    calls0 = dict(eng_mod.paged_forward.calls)
    launches0 = (dec.paged_decode_attention.launches,
                 vl.flash_attn_varlen_fwd_paged.launches)
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    out = eng.run_to_completion()
    calls = {r: eng_mod.paged_forward.calls[r] - calls0[r]
             for r in ("decode", "varlen")}
    launches = {"decode": dec.paged_decode_attention.launches - launches0[0],
                "varlen": vl.flash_attn_varlen_fwd_paged.launches
                - launches0[1]}
    assert sorted(out) == sorted(rids)
    for rid in rids:
        assert len(out[rid]) == 6
        assert all(0 <= tok < cfg.vocab_size for tok in out[rid])
    for route in ("decode", "varlen"):
        assert calls[route] > 0
        assert launches[route] == cfg.n_layers * calls[route]


# ------------------------------------------- K4q, K8q (quantized pools)

QUANT_KINDS = {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "int4": "int4"}
# kernel vs plain LSE: the same fp32 scores summed in another order with
# other exp ulps (P's rounding does not reach the LSE)
QUANT_LSE_ATOL = 1e-4


def _quantize(x, kind, dev, token_axis=-2):
    """A float tensor -> (payload, scales) on `dev`, quantized on the CPU."""
    p, s = quant.quantize_kv(x.float().cpu(), QUANT_KINDS[kind],
                             token_axis=token_axis)
    return p.to(dev), s.to(dev)


def _gate_quant(out, lse, ref, ref_unrounded, lse_ref, name):
    """The kernel against its plain version at the kernel's P grouping,
    within 2x the error P's rounding itself makes (the plain version with
    P unrounded) + 1e-5; the LSE within QUANT_LSE_ATOL."""
    assert_fwd_close(out, ref, ref_unrounded, name=f"{name} out")
    fin = torch.isfinite(lse_ref)
    assert torch.equal(fin, torch.isfinite(lse)), f"{name}: -inf rows differ"
    if fin.any():
        torch.testing.assert_close(lse[fin], lse_ref[fin], rtol=0,
                                   atol=QUANT_LSE_ATOL)


def _decode_quant_inputs(name, kind, dtype, D, dev):
    (q, k, v, *rest), kw = _decode_inputs(name, torch.float32, D, "cpu")
    (kq, ks), (vq, vs) = (_quantize(x, kind, dev) for x in (k, v))
    args = (q.to(dev, dtype), kq, vq, *(x.to(dev) for x in rest))
    kw = {n: (x.to(dev) if isinstance(x, torch.Tensor) else x)
          for n, x in kw.items()}
    kw.update(k_scales=ks, v_scales=vs, int4=kind == "int4")
    return args, kw


@pytest.mark.parametrize("kind", list(QUANT_KINDS))
@pytest.mark.parametrize("name", list(DECODE_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_decode_quant_kernel_matches_plain(cuda, dt, D, name, kind):
    args, kw = _decode_quant_inputs(name, kind, DTYPES[dt], D, cuda)
    before = dec.paged_decode_attention.quant_launches[kind]
    o, lse = dec.merge_partials(*dec.paged_decode_attention(*args, **kw))
    torch.cuda.synchronize()
    assert dec.paged_decode_attention.quant_launches[kind] == before + 1
    ref, lse_ref = dec.merge_partials(*dec.paged_decode_attention_ref(
        *args, **kw))
    unr = dec.merge_partials(*dec.paged_decode_attention_ref(
        *args, round_p=False, **kw))[0]
    _gate_quant(o, lse, ref, unr, lse_ref, f"K4q {kind} {name}")
    if name.startswith("t1_empty_row"):
        assert torch.isneginf(lse[0]).all() and not o[0].any()


def _varlen_quant_inputs(name, kind, dtype, D, dev, cases=VARLEN_CASES):
    (q, k, v, *rest), kw = _varlen_inputs(name, torch.float32, D, "cpu",
                                          cases)
    (kq, ks), (vq, vs) = (_quantize(x, kind, dev) for x in (k, v))
    args = (q.to(dev, dtype), kq, vq,
            *(x.to(dev) if isinstance(x, torch.Tensor) else x for x in rest))
    kw = {n: (x.to(dev) if isinstance(x, torch.Tensor) else x)
          for n, x in kw.items()}
    kw.update(k_scales=ks, v_scales=vs)
    return args, kw


@pytest.mark.parametrize("kind", list(QUANT_KINDS))
@pytest.mark.parametrize("name", list(VARLEN_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_varlen_quant_kernel_matches_plain(cuda, dt, D, name, kind):
    args, kw = _varlen_quant_inputs(name, kind, DTYPES[dt], D, cuda)
    before = vl.flash_attn_varlen_fwd_paged.quant_launches[kind]
    out, lse = vl.flash_attn_varlen_fwd_paged(*args, **kw)
    torch.cuda.synchronize()
    assert vl.flash_attn_varlen_fwd_paged.quant_launches[kind] == before + 1
    ref, lse_ref = vl.flash_attn_varlen_fwd_paged_ref(*args, **kw)
    unr = vl.flash_attn_varlen_fwd_paged_ref(*args, round_p=False, **kw)[0]
    _gate_quant(out, lse, ref, unr, lse_ref, f"K8q {kind} {name}")


def test_quant_kernels_reject_bad_inputs(cuda):
    args, kw = _decode_quant_inputs("t1", "int8", torch.bfloat16, 64, cuda)
    with pytest.raises(TypeError):                       # fp32 q
        dec.paged_decode_attention(args[0].float(), *args[1:], **kw)
    with pytest.raises(ValueError):                      # int4 rows
        dec.paged_decode_attention(*args, **dict(kw, int4=True))
    args, kw = _varlen_quant_inputs("causal_prefix", "int4", torch.bfloat16,
                                    64, cuda)
    with pytest.raises(ValueError):                      # a bf16 pool
        vl.flash_attn_varlen_fwd_paged(
            args[0], *(x.to(torch.bfloat16) for x in args[1:3]), *args[3:],
            **kw)


def test_ieee_div_is_correctly_rounded(cuda):
    """The quantization scales (amax / 127, / 448, / 7) on the card: CUDA
    torch divides by a Python scalar as a product with its reciprocal,
    which can miss the IEEE quotient the kernels compute by an ulp and
    flip a rounded q or P byte.  ieee_div gives the correctly rounded
    quotient, which is float64's quotient rounded once to fp32."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(1 << 20, generator=gen, device=cuda) * 100
    for c in (quant.INT8_MAX, quant.FP8_E4M3_MAX, quant.INT4_MAX):
        assert torch.equal(quant.ieee_div(x, c), (x.double() / c).float())


def _plain_quant(round_p):
    def decode(*a, **k):
        return _merged(*dec.paged_decode_attention_ref(*a, round_p=round_p,
                                                       **k), a[0].dtype)

    def varlen(*a, **k):
        return vl.flash_attn_varlen_fwd_paged_ref(*a, round_p=round_p, **k)
    return decode, varlen


# name: (paged, layout, T_new, extra kwargs)
KVCACHE_QUANT_CASES = {
    "paged_hnd_decode_append": (True, "HND", 1, {}),
    "paged_nhd_varlen_route_append_window": (
        True, "NHD", 256, dict(window_size=(100, -1))),
    "contig_nhd_append_leftpad_alibi": (
        False, "NHD", 3, dict(cache_leftpad=[4, 1, 9], alibi=True)),
}


@pytest.mark.parametrize("kind", list(QUANT_KINDS))
@pytest.mark.parametrize("name", list(KVCACHE_QUANT_CASES))
def test_kvcache_quant_kernels_match_plain(cuda, name, kind, monkeypatch):
    """flash_attn_with_kvcache over a quantized cache on each route: the
    kernel path against the plain versions, and the appended payload and
    scales bit-equal to the CPU append (no rotary)."""
    paged, layout, T, extra = KVCACHE_QUANT_CASES[name]
    rng = np.random.default_rng(23)
    Hq, Hk, D = 8, 2, 64
    varlen = T * (Hq // Hk) >= kv.VARLEN_PREFILL_MIN_ROWS
    B, ps = (2, 128) if varlen else (3, 32)
    kw = dict(causal=True, kv_cache_layout=layout, return_softmax_lse=True)
    if paged:
        mp = 4
        P = 1 + B * mp
        shape = (P, ps, Hk, D) if layout == "NHD" else (Hk, P, ps, D)
        # disjoint pages: two rows appending into one page would make the
        # scatter's winner, and with int4 the merged byte, undefined
        kw["block_table"] = torch.from_numpy(rng.permutation(
            np.arange(1, P))[:B * mp].reshape(B, mp).astype(np.int32))
        cap, tok_axis = mp * ps, (1 if layout == "NHD" else 2)
    else:
        shape = (B, 96, Hk, D)
        cap, tok_axis = 96 - 12, 1
    extra = dict(extra)
    if extra.pop("alibi", False):
        kw["alibi_slopes"] = torch.from_numpy(
            rng.uniform(0.01, 0.2, (B, Hq)).astype(np.float32))
    if "cache_leftpad" in extra:
        extra["cache_leftpad"] = torch.tensor(extra["cache_leftpad"],
                                              dtype=torch.int32)
    kw.update(extra)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    (kc, ks), (vc, vs) = (quant.quantize_kv(mk(*shape), QUANT_KINDS[kind],
                                            token_axis=tok_axis)
                          for _ in range(2))
    cs = torch.from_numpy(rng.integers(5, cap - T, size=B).astype(np.int32))
    q, kn, vn = mk(B, T, Hq, D), mk(B, T, Hk, D), mk(B, T, Hk, D)

    def call(dev, dtype):
        caches = [x.clone().to(dev) for x in (kc, vc, ks, vs)]
        res = kv.flash_attn_with_kvcache(
            q.to(dev, dtype), caches[0], caches[1], k=kn.to(dev, dtype),
            v=vn.to(dev, dtype), cache_seqlens=cs.to(dev),
            k_scales=caches[2], v_scales=caches[3],
            **{n: (x.to(dev) if isinstance(x, torch.Tensor) else x)
               for n, x in kw.items()})
        return res, caches

    counter = (vl.flash_attn_varlen_fwd_paged if varlen
               else dec.paged_decode_attention).quant_launches
    before = counter[kind]
    res, caches = call(cuda, torch.bfloat16)
    torch.cuda.synchronize()
    assert counter[kind] == before + 1, "the call took the wrong route"
    assert all(a is b for a, b in zip(res[2], caches)), "append in place"
    plain = {}
    for round_p in (True, False):
        with monkeypatch.context() as m:
            fd, fv = _plain_quant(round_p)
            m.setattr(kv, "paged_decode_attention_merged", fd)
            m.setattr(kv, "flash_attn_varlen_fwd_paged", fv)
            plain[round_p] = call(cuda, torch.bfloat16)[0]
    _gate_quant(res[0], res[1], plain[True][0], plain[False][0],
                plain[True][1], f"kvcache {kind} {name}")
    cpu_res, _ = call(torch.device("cpu"), torch.bfloat16)
    for got, want in zip(res[2], cpu_res[2]):
        assert torch.equal(quant.payload_bytes(got).cpu(),
                           quant.payload_bytes(want))


@pytest.mark.parametrize("kind", list(QUANT_KINDS))
def test_engine_quant_runs_both_kernels(cuda, kind):
    """A small bf16 model served from a quantized pool: both quantized
    kernels run on their routes and no plain version does."""
    cfg = _tiny(torch.bfloat16)
    params = tmodel.init_params(cfg, seed=5, device=cuda, lm_head=True)
    eng = ServingEngine(params, cfg, max_batch=4, num_pages=16,
                        page_size=128, device=cuda,
                        kv_dtype=QUANT_KINDS[kind])
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (128, 100, 9)]
    calls0 = dict(eng_mod.paged_forward.calls)
    launches0 = (dec.paged_decode_attention.quant_launches[kind],
                 vl.flash_attn_varlen_fwd_paged.quant_launches[kind])
    plain0 = (dec.paged_decode_attention_ref.calls,
              vl.flash_attn_varlen_fwd_paged_ref.calls)
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    out = eng.run_to_completion()
    calls = {r: eng_mod.paged_forward.calls[r] - calls0[r]
             for r in ("decode", "varlen")}
    launches = {
        "decode": dec.paged_decode_attention.quant_launches[kind]
        - launches0[0],
        "varlen": vl.flash_attn_varlen_fwd_paged.quant_launches[kind]
        - launches0[1]}
    assert sorted(out) == sorted(rids)
    for rid in rids:
        assert len(out[rid]) == 6
        assert all(0 <= tok < cfg.vocab_size for tok in out[rid])
    for route in ("decode", "varlen"):
        assert calls[route] > 0
        assert launches[route] == cfg.n_layers * calls[route]
    assert (dec.paged_decode_attention_ref.calls,
            vl.flash_attn_varlen_fwd_paged_ref.calls) == plain0


# ------------------------------------- K8 and K8q on the forward body

# K8's tiles start at cache-row multiples of the key step and its q tiles
# hold 128 rows (64 at D 32/256): q lens one short of, one past and half a
# tile past a q tile, leftpads one short of and one past a key step, a
# 256-row page and a sequence with seqused_k = 0 (a cut past its length)
EDGE_CASES = {
    "q127_129_193_leftpad63_65": ([127, 129, 193], [40, 0, 300], [63, 65, 0],
                                  None, 128,
                                  dict(causal=True, window_right=0), False),
    "ps256_seqused0_leftpad65": ([129, 193, 127], [10, 70, 200], [65, 0, 63],
                                 [0, 10 ** 6, 5], 256,
                                 dict(causal=True, window_right=0), False),
}


def _empty_rows(args, kw):
    """Packed q rows of the sequences whose seqused_k is 0."""
    cu = args[4].tolist()
    used = kw["seqused_k"]
    rows = torch.zeros(cu[-1], dtype=torch.bool)
    for b in range(len(cu) - 1):
        if used is not None and int(used[b]) == 0:
            rows[cu[b]:cu[b + 1]] = True
    return rows


@pytest.mark.parametrize("name", list(EDGE_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_varlen_kernel_tile_edges(cuda, dt, D, name):
    args, kw = _varlen_inputs(name, DTYPES[dt], D, cuda, EDGE_CASES)
    out, lse = vl.flash_attn_varlen_fwd_paged(*args, **kw)
    torch.cuda.synchronize()
    o32, lse32 = vl.flash_attn_varlen_fwd_paged_ref(*args, **kw)
    onat, lsenat = vl.flash_attn_varlen_fwd_paged_ref(*args, upcast=False,
                                                      **kw)
    assert_fwd_close(out, o32, onat, name=f"K8 {name} out")
    _gate_lse(lse, lse32, lsenat, f"K8 {name} lse")
    empty = _empty_rows(args, kw).to(cuda)
    assert not out[empty].any() and torch.isneginf(lse[:, empty]).all()


@pytest.mark.parametrize("kind", list(QUANT_KINDS))
@pytest.mark.parametrize("name", list(EDGE_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_varlen_quant_kernel_tile_edges(cuda, dt, D, name, kind):
    args, kw = _varlen_quant_inputs(name, kind, DTYPES[dt], D, cuda,
                                    EDGE_CASES)
    out, lse = vl.flash_attn_varlen_fwd_paged(*args, **kw)
    torch.cuda.synchronize()
    ref, lse_ref = vl.flash_attn_varlen_fwd_paged_ref(*args, **kw)
    unr = vl.flash_attn_varlen_fwd_paged_ref(*args, round_p=False, **kw)[0]
    _gate_quant(out, lse, ref, unr, lse_ref, f"K8q {kind} {name}")
    empty = _empty_rows(args, kw).to(cuda)
    assert not out[empty].any() and torch.isneginf(lse[:, empty]).all()


def _gathered(args, kw):
    """K8's inputs as K5's: each sequence's cache rows gathered from the
    pools into packed (Tk, Hk, D) K/V split by cu_seqlens_k."""
    q, kp, vp, tbl, cu_q, lens, max_q, max_k, scale, params = args
    ps = kp.shape[2]
    ks, vs = [], []
    for b, n in enumerate(lens.tolist()):
        pages = tbl[b, :-(-n // ps)].long()
        ks.append(kp[:, pages].reshape(kp.shape[0], -1, kp.shape[3])[:, :n])
        vs.append(vp[:, pages].reshape(vp.shape[0], -1, vp.shape[3])[:, :n])
    k = torch.cat(ks, dim=1).transpose(0, 1).contiguous()
    v = torch.cat(vs, dim=1).transpose(0, 1).contiguous()
    cu_k = torch.zeros(len(lens) + 1, dtype=torch.int32, device=q.device)
    cu_k[1:] = torch.cumsum(lens, 0)
    return (q, k, v, cu_q, cu_k, max_q, max_k, scale, params), dict(
        alibi_slopes=kw["alibi_slopes"])


@pytest.mark.parametrize("name", ["causal_prefix", "window_softcap_alibi"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_varlen_paged_bit_equal_to_varlen_fwd(cuda, dt, D, name):
    """With leftpad 0, K8 over the pools and K5 over the same cache rows
    gathered into packed K/V run one body over the same tiles: out and
    LSE bit-equal."""
    args, kw = _varlen_inputs(name, DTYPES[dt], D, cuda)
    out8, lse8 = vl.flash_attn_varlen_fwd_paged(*args, **kw)
    args5, kw5 = _gathered(args, kw)
    out5, lse5 = vl.flash_attn_varlen_fwd(*args5, **kw5)
    assert torch.equal(out8, out5) and torch.equal(lse8, lse5)


@pytest.mark.parametrize("kind", [None] + list(QUANT_KINDS))
def test_varlen_paged_bitwise_deterministic(cuda, kind):
    """K8 and K8q give the same out and LSE bits on two calls."""
    name = "q127_129_193_leftpad63_65"
    if kind is None:
        args, kw = _varlen_inputs(name, torch.bfloat16, 128, cuda,
                                  EDGE_CASES)
    else:
        args, kw = _varlen_quant_inputs(name, kind, torch.bfloat16, 128,
                                        cuda, EDGE_CASES)
    one = vl.flash_attn_varlen_fwd_paged(*args, **kw)
    two = vl.flash_attn_varlen_fwd_paged(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("D", [64, 128])
def test_varlen_paged_kernels_use_no_local_memory(cuda, D):
    """K8 and K8q (each payload kind) in bf16 and fp16, with and without
    bias: no spills or stack (local memory) and at least 8 warps resident
    a multiprocessor."""
    import ctypes
    k8, k8q = build.load("varlen_paged"), build.load("varlen_paged_quant")
    calls = [(f"K8 dtype {dt} extra {ex}", k8.fa_varlen_paged_occupancy,
              (dt, D, ex)) for dt in (0, 1) for ex in (0, 1)]
    calls += [(f"K8q {kind} dtype {dt} extra {ex}",
               k8q.fa_varlen_paged_quant_occupancy, (code, dt, D, ex))
              for kind, code in dec.KIND_CODE.items()
              for dt in (0, 1) for ex in (0, 1)]
    for what, fn, a in calls:
        out = (ctypes.c_int * 5)()
        assert fn(*a, ctypes.addressof(out)) == 0, what
        blocks, _, threads, _, local = out
        assert local == 0, f"{what}: {local} B of local memory"
        assert blocks * threads // 32 >= 8, f"{what}: {blocks} blocks"


# ------------------------------------------- K4 and K4q: stage and split edges

# K4's stages hold 128 keys at D 64 and 64 at D 128, its warps 32-key
# groups; rows > 16 take 64-row blocks.  name: (lens, leftpad, t_new,
# group, page size, table slots, num_splits, mask kwargs)
DECODE_EDGE_CASES = {
    "lens_1_63_64_65_127_129": ([1, 63, 64, 65, 127, 129], None, 1, 8, 32,
                                8, 0, dict(window_right=0)),
    # splits of 4 pages x 32 = 128 rows: lengths at a split boundary +-1
    "split_edge": ([127, 128, 129, 255, 256, 257], None, 1, 4, 32, 12, 3,
                   dict(window_right=0)),
    "leftpad_63_65": ([200, 300], [63, 65], 1, 8, 64, 8, 2,
                      dict(window_right=0)),
    # a window edge inside a stage, 4 new tokens
    "window_in_stage": ([300, 150], [0, 7], 4, 8, 128, 4, 0,
                        dict(causal=True, window_left=40, window_right=0)),
    # the short-prompt prefill (Rq 512) and the largest K4 route (Rq 1016)
    "rq512": ([64, 364], None, 64, 8, 128, 4, 0,
              dict(causal=True, window_right=0)),
    "rq1016": ([127, 500], None, 127, 8, 128, 5, 0,
               dict(causal=True, window_right=0)),
}


def _decode_edge_inputs(name, kind, D, dev, dtype=torch.bfloat16):
    lens, lp, t_new, group, ps, mp, splits, mkw = DECODE_EDGE_CASES[name]
    rng = np.random.default_rng(11)
    B, Hk = len(lens), 2
    Rq = max(-(-group * t_new // 8) * 8, 8)
    P = B * mp + 1
    q = torch.from_numpy(rng.standard_normal((B, Hk, Rq, D)).astype(
        np.float32))
    q[:, :, group * t_new:] = 0
    k, v = (torch.from_numpy(rng.standard_normal((1, Hk, P, ps, D)).astype(
        np.float32)) for _ in range(2))
    tbl = torch.from_numpy(rng.permutation(np.arange(1, P)).reshape(
        B, mp).astype(np.int32))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    lp_t = torch.tensor(lp or [0] * B, dtype=torch.int32)
    kw = dict(qpos_vec=(lens_t - t_new).to(dev), softmax_scale=D ** -0.5,
              params=masklib.MaskParams(**mkw), t_new=t_new, group=group,
              num_splits=splits)
    if kind is None:
        pools = (k.to(dev, dtype), v.to(dev, dtype))
    else:
        (kq, ks), (vq, vs) = (_quantize(x, kind, dev) for x in (k, v))
        pools = (kq, vq)
        kw.update(k_scales=ks, v_scales=vs, int4=kind == "int4")
    args = (q.to(dev, dtype), *pools, tbl.to(dev), lens_t.to(dev),
            lp_t.to(dev))
    return args, kw


def _assert_merged(om, lsem, o, lse, name):
    """The merged entry against merge_partials of the partials, per row:
    RMS error within 2^-8 of the row's RMS (q's 16-bit rounding) + 1e-6;
    LSE within 1e-5, -inf rows equal."""
    o = o.float()
    err = (om.float() - o).pow(2).mean(-1).sqrt()
    gate = 2.0 ** -8 * o.pow(2).mean(-1).sqrt() + 1e-6
    assert bool((err <= gate).all()), (
        f"{name}: merged row err {float((err / gate).max()):.3f} x gate")
    fin = torch.isfinite(lse)
    assert torch.equal(fin, torch.isfinite(lsem)), f"{name}: -inf rows"
    torch.testing.assert_close(lsem[fin], lse[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", [None] + list(QUANT_KINDS))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("name", list(DECODE_EDGE_CASES))
def test_decode_kernel_edges(cuda, name, D, kind):
    """K4 / K4q at stage, group, split and window edges and at Rq 512 /
    1016, against the plain version (K4q: its twin at P_TILE), and the
    merged entry against merge_partials of the partials."""
    args, kw = _decode_edge_inputs(name, kind, D, cuda)
    o, lse = dec.merge_partials(*dec.paged_decode_attention(*args, **kw))
    om, lsem = dec.paged_decode_attention_merged(*args, **kw)
    torch.cuda.synchronize()
    label = f"K4{'' if kind is None else 'q ' + kind} {name}"
    if kind is None:
        o32, lse32 = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, **kw))
        onat, lsenat = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, upcast=False, **kw))
        assert_fwd_close(o, o32, onat, name=f"{label} out")
        _gate_lse(lse, lse32, lsenat, f"{label} lse")
    else:
        ref, lse_ref = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, **kw))
        unr = dec.merge_partials(*dec.paged_decode_attention_ref(
            *args, round_p=False, **kw))[0]
        _gate_quant(o, lse, ref, unr, lse_ref, label)
    assert om.dtype == args[0].dtype
    _assert_merged(om, lsem, o, lse, label)


@pytest.mark.parametrize("kind", [None] + list(QUANT_KINDS))
def test_decode_merged_deterministic_and_graph_replay(cuda, kind):
    """Two merged calls give the same bits (the merge sums the splits in
    order whatever block arrives last), and a CUDA-graph replay of the
    call, reusing the arrival counters, gives the eager call's bits."""
    args, kw = _decode_edge_inputs("split_edge", kind, 128, cuda)
    one = dec.paged_decode_attention_merged(*args, **kw)
    two = dec.paged_decode_attention_merged(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = dec.paged_decode_attention_merged(*args, **kw)
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, one))


def test_decode_long_context_bf16(cuda):
    """K4 at the 32k-context decode shape at B 1 (32 / 8 heads x 128, page
    512, table arange), merged in the launch, against the plain version."""
    Hk, group, D, ctx, ps = 8, 4, 128, 32768, 512
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((1, Hk, 8, D), generator=gen, device=cuda).to(
        torch.bfloat16)
    q[:, :, group:] = 0
    k, v = (torch.randn((1, Hk, ctx // ps, ps, D), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    tbl = torch.arange(ctx // ps, dtype=torch.int32, device=cuda)[None]
    lens = torch.full((1,), ctx, dtype=torch.int32, device=cuda)
    kw = dict(softmax_scale=D ** -0.5,
              params=masklib.MaskParams(window_right=0), t_new=1,
              group=group)
    args = (q, k, v, tbl, lens, None)
    om, lsem = dec.paged_decode_attention_merged(*args, **kw)
    o32, lse32 = dec.merge_partials(*dec.paged_decode_attention_ref(
        *args, **kw))
    onat, lsenat = dec.merge_partials(*dec.paged_decode_attention_ref(
        *args, upcast=False, **kw))
    assert_fwd_close(om[:, :, :group], o32[:, :, :group],
                     onat[:, :, :group], name="K4 32k")
    _gate_lse(lsem[:, :, :group], lse32[:, :, :group],
              lsenat[:, :, :group], "K4 32k lse")


@pytest.mark.parametrize("D", [64, 128])
def test_decode_kernels_use_no_local_memory(cuda, D):
    """K4 and K4q (each payload kind) in bf16 and fp16, at 16- and 64-row
    blocks: no spills or stack (local memory); at 16 rows (every decode
    step) at least 8 warps resident a multiprocessor."""
    import ctypes
    k4, k4q = build.load("decode"), build.load("decode_quant")
    calls = [(f"K4 dtype {dt} rows {rows}", k4.fa_decode_occupancy,
              (dt, D, rows)) for dt in (0, 1) for rows in (16, 64)]
    calls += [(f"K4q {kind} dtype {dt} rows {rows}",
               k4q.fa_decode_quant_occupancy, (code, dt, D, rows))
              for kind, code in dec.KIND_CODE.items()
              for dt in (0, 1) for rows in (16, 64)]
    for what, fn, a in calls:
        out = (ctypes.c_int * 5)()
        assert fn(*a, ctypes.addressof(out)) == 0, what
        blocks, _, threads, _, local = out
        assert local == 0, f"{what}: {local} B of local memory"
        if a[-1] == 16:
            assert blocks * threads // 32 >= 8, f"{what}: {blocks} blocks"


# ------------------------------------------------ integrations and utils

def test_hf_conversion_on_the_card_bit_equal_to_the_cpu(cuda):
    """An fp32 HF-named state dict (chip_smoke.hf_state_dict of random
    weights) converted to bf16 on the card and on the CPU: the same bytes
    (both round to nearest even)."""
    import types
    import chip_smoke
    from flash_attn_v100_tpu_torch.integrations.huggingface import (
        convert_hf_model)
    cfg = _tiny(torch.float32)
    params = tmodel.init_params(cfg, seed=9, device="cpu", lm_head=True)
    state = chip_smoke.hf_state_dict(torch, params)
    hf_cfg = types.SimpleNamespace(
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
        intermediate_size=cfg.ffn_dim, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, max_position_embeddings=cfg.max_seq_len,
        model_type="llama")
    on_card, cfg_card = convert_hf_model(state, hf_cfg, device=cuda)
    on_cpu, cfg_cpu = convert_hf_model(state, hf_cfg, device="cpu")
    assert cfg_card == cfg_cpu == ModelConfig(**dict(
        vars(cfg), dtype=torch.bfloat16))
    for a, b in zip(tmodel.param_leaves(on_card),
                    tmodel.param_leaves(on_cpu)):
        assert a.is_cuda and a.dtype == torch.bfloat16
        assert torch.equal(a.cpu(), b)


def test_lora_step_on_the_card_within_the_gradient_gate(cuda):
    """One LoRA step of a small bf16 model through K1-K3 against the same
    step on the CPU through the plain attention (fp32 reference, bf16
    yardstick): loss within 2x + 1e-5, each adapter gradient within
    3x + 1e-4, dL/dA exactly 0 (B = 0), and one K1/K2/K3 launch a layer."""
    from flash_attn_v100_tpu_torch.integrations import lora as lora_mod
    cfg = _tiny(torch.bfloat16)
    lcfg = lora_mod.LoraConfig()
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 129)))

    def run(dev):
        params = tmodel.init_params(cfg, seed=6, device="cpu")
        params = tmodel._map_params(params, lambda t: t.to(dev))
        lora = lora_mod.lora_init(params, lcfg, seed=7, device="cpu")
        lora = dict(layers=[{n: {k: w.detach().to(dev).requires_grad_()
                                 for k, w in ab.items()}
                             for n, ab in ad.items()}
                            for ad in lora["layers"]])
        step, init_opt = lora_mod.make_lora_train_step(cfg, lcfg)
        loss, lora, _ = step(lora, init_opt(lora), params, tokens.to(dev))
        return loss, [t.grad.cpu() for t in lora_mod.lora_leaves(lora)]

    before = (dfwd.flash_attn_dense_fwd.launches, dbwd.dq_kernel.launches,
              dbwd.dkv_kernel.launches)
    loss, grads = run(cuda)
    assert (dfwd.flash_attn_dense_fwd.launches - before[0],
            dbwd.dq_kernel.launches - before[1],
            dbwd.dkv_kernel.launches - before[2]) == (cfg.n_layers,) * 3
    plain = {}
    for upcast in (True, False):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(fa_mod, "flash_attn_dense_fwd", lambda *a, **k_: (
                dfwd.flash_attn_dense_fwd_ref(*a, upcast=upcast, **k_)))
            m.setattr(fa_mod, "flash_attn_dense_bwd", lambda *a, **k_: (
                dbwd.flash_attn_dense_bwd_ref(*a, upcast=upcast, **k_)))
            plain[upcast] = run("cpu")
    assert torch.isfinite(loss)
    assert_close_rel(loss.cpu(), plain[True][0], plain[False][0], 2.0, 1e-5,
                     name="lora loss")
    for i, (g, g32, g16) in enumerate(zip(grads, plain[True][1],
                                          plain[False][1])):
        if i % 2 == 0:
            assert torch.count_nonzero(g) == 0, f"dL/dA {i // 2}"
        assert_bwd_close(g, g32, g16, name=f"adapter grad {i}")


def test_profile_ops_labels_the_dense_kernels(cuda):
    from flash_attn_v100_tpu_torch.utils import profiling
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 256, h, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16).requires_grad_()
        for h in (8, 2, 2))

    def fwd_bwd():
        fa_mod.flash_attn_func(q, k, v, causal=True).sum().backward()

    rows = profiling.profile_ops(fwd_bwd, iters=2, top=0)
    counts = {label: n for label, _, n in rows}
    assert counts.get("K1") == 2 and counts.get("K2") == 2 \
        and counts.get("K3") == 2, counts


def test_measure_of_k1_agrees_with_chip_smoke_time_ms(cuda):
    """utils.benchmarking.measure (queue-delta over CUDA events) against
    chip_smoke.time_ms (CUDA events around each call) for K1 at the
    headline prefill shape (B 4, S 4096, 32/8 heads x 128, causal), where
    a call's host time is a few percent of its device time: within 20%."""
    import chip_smoke
    from flash_attn_v100_tpu_torch.utils import benchmarking
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(4, 4096, 32, 128, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(4, 4096, 8, 128, generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    mp = masklib.MaskParams(causal=True)

    def k1():
        return dfwd.flash_attn_dense_fwd(q, k, v, 128 ** -0.5, mp)

    s = benchmarking.measure(k1, device=cuda)
    ms = chip_smoke.time_ms(torch, k1)
    assert abs(s * 1e3 - ms) <= 0.2 * ms, (s * 1e3, ms)


# ------------------------------------------------ the sequence-sharded call

# name: (T_new, append, kwargs).  The rows are one rank's of a 4-way seq
# sharding with SHARD tokens a shard, on shard 1 (global rows [SHARD,
# 2 SHARD)): appends inside, straddling the start, straddling the end, a
# row wholly before the shard (no live key there: lens_total 0, a
# negative q position) and one past it (q positions past the shard's end)
SHARD = 128
SHARD_LENS = [SHARD + 41, SHARD - 1, 2 * SHARD - 2, 10, 3 * SHARD + 5]
SHARD_CASES = {
    "t3_causal_append": (3, True, {}),
    "t1_window_append": (1, True, dict(window_size=(60, -1))),
    "t3_causal_no_append": (3, False, {}),
}


def _shard_call_inputs(name, paged, kind, rng):
    T, append, extra = SHARD_CASES[name]
    B, Hq, Hk, D = len(SHARD_LENS), 8, 2, 64
    lens = np.asarray(SHARD_LENS, np.int32)
    total = lens + (T if append else 0)
    cs = np.clip(total - SHARD, 0, SHARD) - (T if append else 0)
    kw = dict(causal=True, kv_cache_layout="HND", return_softmax_lse=True,
              cache_seqlens=torch.from_numpy(cs.astype(np.int32)),
              q_position_lens=torch.from_numpy(lens - SHARD),
              append_window=(0, SHARD) if append else None, **extra)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    if paged:
        ps = 32
        mp = SHARD // ps
        P = 1 + B * mp
        shape = (Hk, P, ps, D)
        kw["block_table"] = torch.from_numpy(rng.permutation(
            np.arange(1, P)).reshape(B, mp).astype(np.int32))
    else:
        shape = (B, Hk, SHARD, D)
    k, v = mk(*shape), mk(*shape)
    caches = ([k, v] if kind is None else
              [x for pair in zip(*(quant.quantize_kv(c, QUANT_KINDS[kind])
                                   for c in (k, v))) for x in pair])
    new = [mk(B, T, Hk, D), mk(B, T, Hk, D)] if append else [None, None]
    return mk(B, T, Hq, D), caches, new, kw, cs + (T if append else 0)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
@pytest.mark.parametrize("name", list(SHARD_CASES))
@pytest.mark.parametrize("kind", [None] + list(QUANT_KINDS))
def test_kvcache_shard_call_kernels_match_plain(cuda, kind, name, paged,
                                                monkeypatch):
    """flash_attn_with_kvcache as one rank of the sequence-sharded decode
    calls it (q_position_lens, append_window) through K4 / K4q against the
    plain versions on the card; a row with no live key on the shard gives
    O = 0 and LSE = -inf, and the appends (out-of-window ones dropped) are
    bit-equal to the CPU's."""
    q, caches, new, kw, live = _shard_call_inputs(
        name, paged, kind, np.random.default_rng(31))
    dt = torch.bfloat16

    def call(dev):
        c = [x.clone().to(dev) for x in caches]
        sc = {} if kind is None else dict(k_scales=c[2], v_scales=c[3])
        res = kv.flash_attn_with_kvcache(
            q.to(dev, dt), c[0].to(dt) if kind is None else c[0],
            c[1].to(dt) if kind is None else c[1],
            k=None if new[0] is None else new[0].to(dev, dt),
            v=None if new[1] is None else new[1].to(dev, dt), **sc,
            **{n: (x.to(dev) if isinstance(x, torch.Tensor) else x)
               for n, x in kw.items()})
        return res

    counter = dec.paged_decode_attention
    before = (counter.launches, dict(counter.quant_launches))
    res = call(cuda)
    torch.cuda.synchronize()
    if kind is None:
        assert counter.launches == before[0] + 1
    else:
        assert counter.quant_launches[kind] == before[1][kind] + 1
    label = f"shard call {kind or 'bf16'} {name} {'paged' if paged else ''}"
    plain = {}
    for flag in (True, False):
        with monkeypatch.context() as m:
            fd, fv = _plain(flag) if kind is None else _plain_quant(flag)
            m.setattr(kv, "paged_decode_attention_merged", fd)
            plain[flag] = call(cuda)
    if kind is None:
        assert_fwd_close(res[0], plain[True][0], plain[False][0],
                         name=f"{label} out")
        _gate_lse(res[1], plain[True][1], plain[False][1], f"{label} lse")
    else:
        _gate_quant(res[0], res[1], plain[True][0], plain[False][0],
                    plain[True][1], label)
    for b in np.flatnonzero(live == 0):
        assert not res[0][b].any() and torch.isneginf(res[1][b]).all()
    if new[0] is not None:
        cpu = call(torch.device("cpu"))
        for got, want in zip(res[2], cpu[2]):
            assert torch.equal(quant.payload_bytes(got).cpu(),
                               quant.payload_bytes(want))


def test_four_shard_merge_matches_unsharded_decode(cuda, monkeypatch):
    """Four shards of one contiguous bf16 cache attended one by one on the
    card through flash_attn_with_kvcache_sharded, as the four ranks of the
    sequence-sharded decode attend them (each appending in its window),
    their partials merged by LSE: the output within the forward gate of
    the unsharded call's fp32 plain version, the LSE within 1e-4 of the
    unsharded K4 call's, and the shards' appended caches bit-equal to the
    unsharded call's."""
    from flash_attn_v100_tpu_torch.parallel.mesh import Mesh
    from flash_attn_v100_tpu_torch.parallel.sharded import (
        flash_attn_with_kvcache_sharded)
    rng = np.random.default_rng(37)
    S, B, Hq, Hk, D, n = 4, 3, 8, 2, 128, 256
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda, torch.bfloat16)
    q, kn, vn = mk(B, 1, Hq, D), mk(B, 1, Hk, D), mk(B, 1, Hk, D)
    kc, vc = mk(B, Hk, S * n, D), mk(B, Hk, S * n, D)
    lens = torch.tensor([700, 255, 5], dtype=torch.int32, device=cuda)

    def unsharded():
        k, v = kc.clone(), vc.clone()
        out, lse, _ = kv.flash_attn_with_kvcache(
            q, k, v, kn, vn, cache_seqlens=lens, causal=True,
            kv_cache_layout="HND", return_softmax_lse=True)
        return out, lse, k, v
    out, lse, ref_k, ref_v = unsharded()
    plain = {}
    for upcast in (True, False):
        with monkeypatch.context() as m:
            m.setattr(kv, "paged_decode_attention_merged",
                      _plain(upcast)[0])
            plain[upcast] = unsharded()[0]
    parts, lses, shards = [], [], []
    for s in range(S):
        # rank s of a seq axis of 4, its merge over the axis left out (no
        # process group: the identity) and done by merge_partials below
        mesh = Mesh(np.arange(S).reshape(1, S, 1), s, {"seq": None})
        ks = kc[:, :, s * n:(s + 1) * n].clone()
        vs = vc[:, :, s * n:(s + 1) * n].clone()
        o_s, l_s, _ = flash_attn_with_kvcache_sharded(
            q, ks, vs, mesh, lens, k=kn, v=vn, causal=True,
            return_softmax_lse=True)
        parts.append(o_s.float().permute(0, 2, 1, 3))      # (B, Hq, 1, D)
        lses.append(l_s[..., None])                        # (B, Hq, 1, 1)
        shards.append((ks, vs))
    om, lm = dec.merge_partials(torch.stack(parts, 2), torch.stack(lses, 2))
    assert_fwd_close(om.permute(0, 2, 1, 3).to(torch.bfloat16), plain[True],
                     plain[False], name="4-shard merge")
    torch.testing.assert_close(lm[..., 0], lse, rtol=0, atol=1e-4)
    assert torch.equal(torch.cat([k for k, _ in shards], 2), ref_k)
    assert torch.equal(torch.cat([v for _, v in shards], 2), ref_v)


# ------------------------------------------------- P1-P4 (cost probes)

from flash_attn_v100_tpu_torch.ops.cuda import probe_int4 as p4  # noqa: E402
from flash_attn_v100_tpu_torch.ops.cuda import probes  # noqa: E402

PROBE_VARIANTS = {f"{suite} {name}": probe for suite, d in (
    ("P1", probes.P1_VARIANTS), ("P2", probes.P2_VARIANTS),
    ("P3", probes.P3_VARIANTS)) for name, probe in d.items()}


def _probe_inputs(B, Hq, Hk, M, N, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B * h, n, 128), generator=g, device="cuda").to(
        torch.bfloat16) for h, n in ((Hq, M), (Hk, N), (Hk, N))]


def _probe_check(probe, q, k, v, B, scale, **kw):
    if probe.strided:
        q, k, v = (x.view(B, -1, *x.shape[1:]) for x in (q, k, v))
    M, N = q.shape[-2], k.shape[-2]
    before = probes.flash_step.launches
    out = probes.flash_step(q, k, v, probe, scale, **kw)
    torch.cuda.synchronize()
    assert probes.flash_step.launches == before + 1
    pairs = (probes.rect_pairs(M // 128, N // probe.bk) if probe.pairs
             else None)
    ref = probes.flash_step_ref(q, k, v, probe, scale, bk=probe.bk,
                                pairs=pairs, **kw)
    res = (probes.compare(out[0], ref[0], out[1], ref[1]) if probe.lse
           else probes.compare(out, ref))
    assert res["ok"], res
    return out, ref


@pytest.mark.parametrize("name", list(PROBE_VARIANTS))
@pytest.mark.parametrize("shape", [(2, 4, 2, 256, 512), (1, 2, 1, 384, 128)],
                         ids=["gqa", "m_gt_n"])
def test_probe_kernels_match_their_twin(cuda, name, shape):
    """Every P1-P3 variant against its twin (NaN masks of the exp-without-
    max variant included) at two small shapes."""
    probe = PROBE_VARIANTS[name]
    B, Hq, Hk, M, N = shape
    if N % probe.bk:
        N = probe.bk * 2
    q, k, v = _probe_inputs(B, Hq, Hk, M, N)
    zq = torch.zeros(M, dtype=torch.int32, device="cuda")
    zk = torch.zeros(N, dtype=torch.int32, device="cuda")
    out, _ = _probe_check(
        probe, q, k, v, B,
        probes.SCALE if name.startswith("P1") else probes.SCALE_LOG2,
        qside=[zq + i for i in range(probe.n_qside)],
        kside=[zk + i for i in range(probe.n_kside)], qseg=zq, kseg=zk)
    if "exp" in probe.stages and "max" not in probe.stages:
        assert torch.isnan(out.float()).all()


def test_probe_branches_on_ragged_segments(cuda):
    """The branch variant's three paths and its skipped tiles: segment
    words that change inside q blocks and key tiles."""
    probe = probes.P3_VARIANTS["seg-reduce + 3 branches"]
    q, k, v = _probe_inputs(1, 2, 1, 512, 512, seed=1)
    rows = torch.arange(512, device="cuda", dtype=torch.int32)
    qseg, kseg = rows // 200, rows // 96
    out, ref = _probe_check(probe, q, k, v, 1, probes.SCALE_LOG2,
                            qseg=qseg, kseg=kseg)
    full = probes.flash_step(q, k, v, probes.Probe(), probes.SCALE_LOG2)
    assert not torch.equal(out, full), "no tile was skipped"


def test_probe_kernels_are_deterministic_and_raise_on_bad_shapes(cuda):
    q, k, v = _probe_inputs(1, 4, 1, 256, 256)
    probe = probes.P2_VARIANTS["+prefetch pairs"]
    a = probes.flash_step(q, k, v, probe, probes.SCALE_LOG2)
    b = probes.flash_step(q, k, v, probe, probes.SCALE_LOG2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="multiple of 128"):
        probes.flash_step(q[:, :200].contiguous(), k, v, probe,
                          probes.SCALE_LOG2)
    with pytest.raises(TypeError, match="bf16"):
        probes.flash_step(q.half(), k.half(), v.half(), probe,
                          probes.SCALE_LOG2)


def test_probe_sass_holds_every_stage(cuda):
    """The tensor-core and exp2 instructions each variant's stages claim
    are in its SASS: nvcc deleted no unread stage."""
    counts = probes.sass_counts()
    for name, probe in PROBE_VARIANTS.items():
        c = counts[probe.flags]
        assert (c["hgmma_ss"], c["hgmma_rs"]) == probes.expected_hgmma(
            probe), name
        assert c["ex2"] >= probes.expected_ex2(probe), name


@pytest.mark.parametrize("MNK", [(128, 256, 128), (256, 384, 512)])
def test_int4_products_are_exact(cuda, MNK):
    M, N, K = MNK
    g = torch.Generator().manual_seed(M + N + K)
    a = torch.randint(-8, 8, (M, K), generator=g, dtype=torch.int8)
    b = torch.randint(-8, 8, (N, K), generator=g, dtype=torch.int8)
    ref = a.long() @ b.long().T
    bp = p4.pack_int4(b).cuda()
    c8 = p4.int8_int4_matmul(a.cuda(), bp)
    c4 = p4.int4_matmul(p4.pack_int4(a).cuda(), bp)
    assert torch.equal(c8.cpu().long(), ref)
    assert torch.equal(c4.cpu().long(), ref)
    with pytest.raises(ValueError, match="multiples of 128"):
        p4.int8_int4_matmul(a[:, :64].cuda(), p4.pack_int4(b[:, :64]).cuda())
