"""Shared cases of tests/test_torch_kvcache_sharded*.py: port
flash_attn_with_kvcache with `q_position_lens` / `append_window`
(the call one rank of the sequence-sharded decode makes) against the JAX
package's with the same kwargs: contiguous and paged HND caches, fp32 and
int8 / fp8 / int4 pools, T_new 1 and 3, causal and windowed, rotary, and
rows whose appends fall inside, straddle either end of, or miss the
shard's window, including a row with no live key on the shard
(lens_total 0, O = 0, LSE = -inf) and q positions before and past the
shard.  Outputs and LSE within 1e-5 (quantized: P grouped per page, as
JAX groups it, at one split count), appended payload bytes and scales bit-equal, and the
quantized outputs within the JAX package's oracle gates (0.1 int8 / fp8,
0.3 int4) of fp32 attention over the float caches."""

import jax.numpy as jnp
import numpy as np
import torch

from flash_attn_v100_tpu import flash_attn_with_kvcache as jax_kvcache
from flash_attn_v100_tpu.ops import quant as jq
from flash_attn_v100_tpu_torch import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops import quant as tq
from flash_attn_v100_tpu_torch.ops.cuda import decode as tdec

torch.set_num_threads(1)

ATOL = 1e-5
N_SHARD, PS = 32, 8                 # a shard's tokens; the paged pool's page
KINDS = {None: (None, None), "int8": (torch.int8, jnp.int8),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
         "int4": ("int4", "int4")}
GATE = {"int8": 0.1, "fp8": 0.1, "int4": 0.3}

# name: (T_new, append, shard index, global pre-append lengths, kwargs).
# With N_SHARD 32, shard 1 holds global rows [32, 64):
#   41 appends inside; 30 straddles the start (T 3); 62 straddles the end;
#   10 lies before the shard (its rows there: none, lens_total 0); 70 past
#   it (all 32 rows live, the appends dropped, q positions past the end).
SCENARIOS = {
    "t3_causal_append": (3, True, 1, [41, 30, 62, 10, 70], {}),
    "t3_rotary_append_shard0": (3, True, 0, [5, 30, 40, 0, 31],
                                dict(rotary=True)),
    "t1_window_append": (1, True, 1, [41, 31, 63, 10, 70],
                         dict(window_size=(20, -1))),
    "t3_causal_no_append": (3, False, 1, [41, 30, 62, 10, 70], {}),
}
# the quantized pools take the two appending scenarios without rotary
QUANT_SCENARIOS = ["t3_causal_append", "t1_window_append"]


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return tq.payload_bytes(a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _shard_args(T, append, shard, lens):
    """cache_seqlens, q_position_lens and append_window of the shard's
    call, computed as parallel/sharded.py computes them."""
    lens = np.asarray(lens, np.int32)
    start = shard * N_SHARD
    total = lens + (T if append else 0)
    cs = np.clip(total - start, 0, N_SHARD) - (T if append else 0)
    return (cs.astype(np.int32), (lens - start).astype(np.int32),
            (0, N_SHARD) if append else None)


def run_case(scenario, kind, paged, monkeypatch):
    """One shard's call through both packages (see the module docstring)."""
    monkeypatch.setattr(tdec, "P_TILE", None)
    T, append, shard, lens, extra = SCENARIOS[scenario]
    extra = dict(extra)
    rotary = extra.pop("rotary", False)
    rng = np.random.default_rng(7)
    B, Hq, Hk, D = len(lens), 4, 2, 32
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    # two KV splits on both sides (fp8's P rounding reads each split's
    # running max, and the two packages' automatic split rules differ)
    kw = dict(causal=True, kv_cache_layout="HND", return_softmax_lse=True,
              num_splits=2, **extra)
    if paged:
        mp, P = N_SHARD // PS, len(lens) * (N_SHARD // PS) + 1
        tbl = rng.permutation(np.arange(1, P)).reshape(B, mp).astype(np.int32)
        kw["block_table"] = tbl
        kf, vf = mk(Hk, P, PS, D), mk(Hk, P, PS, D)
    else:
        kf, vf = mk(B, Hk, N_SHARD, D), mk(B, Hk, N_SHARD, D)
    q = mk(B, T, Hq, D)
    new = [mk(B, T, Hk, D), mk(B, T, Hk, D)] if append else [None, None]
    if rotary:
        kw.update(rotary_cos=mk(4 * N_SHARD, D // 2),
                  rotary_sin=mk(4 * N_SHARD, D // 2),
                  rotary_interleaved=False)
    cs, qlens, window = _shard_args(T, append, shard, lens)
    kw.update(cache_seqlens=cs, q_position_lens=qlens, append_window=window)

    tdt, jdt = KINDS[kind]
    if kind is None:
        jcaches = [jnp.asarray(kf), jnp.asarray(vf)]
    else:
        (jk, jks), (jv, jvs) = (jq.quantize_kv(jnp.asarray(x), jdt,
                                               token_axis=2)
                                for x in (kf, vf))
        jcaches = [jk, jv, jks, jvs]
    tcaches = [tq.payload_from_numpy(np.asarray(a)) for a in jcaches]
    jarr = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}
    tarr = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}
    sc = {} if kind is None else dict(k_scales=2, v_scales=3)
    jres = jax_kvcache(
        jnp.asarray(q), jcaches[0], jcaches[1],
        *[None if x is None else jnp.asarray(x) for x in new],
        **{n: jcaches[i] for n, i in sc.items()}, **jarr)
    tres = flash_attn_with_kvcache(
        torch.from_numpy(q), tcaches[0], tcaches[1],
        *[None if x is None else torch.from_numpy(x) for x in new],
        **{n: tcaches[i] for n, i in sc.items()}, **tarr)

    assert len(tres) == len(jres)
    np.testing.assert_allclose(tres[0].numpy(), np.asarray(jres[0]),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tres[1].numpy(), np.asarray(jres[1]),
                               rtol=0, atol=ATOL)
    # a row with no live key on the shard: O = 0, LSE = -inf
    live = cs + (T if append else 0)
    for b in np.flatnonzero(live == 0):
        assert not tres[0][b].any() and torch.isinf(tres[1][b]).all()
    if append:
        assert all(a is b for a, b in zip(tres[2], tcaches)), "in place"
        for got, want in zip(tres[2], jres[2]):
            assert np.array_equal(_bytes(got), _bytes(want))
    if kind is not None and not rotary:
        # the oracle: fp32 attention over the float caches, rows with keys
        ref = _oracle(q, kf, vf, new, kw, paged, T, append)
        rows = live > 0
        err = float((tres[0][rows] - ref[rows]).abs().max())
        assert err <= GATE[kind], (kind, err)


def _oracle(q, kf, vf, new, kw, paged, T, append):
    """fp32 attention of the shard's rows over the float caches with the
    kept appends, q at its shard-local positions (the kernel's frame)."""
    B = q.shape[0]
    if paged:
        tbl = kw["block_table"]
        kf, vf = (x[:, tbl].transpose(1, 2, 3, 0, 4).reshape(
            B, -1, x.shape[0], x.shape[-1]) for x in (kf, vf))
    else:
        kf, vf = (x.transpose(0, 2, 1, 3) for x in (kf, vf))
    kf, vf = np.array(kf), np.array(vf)
    cs, qlens = kw["cache_seqlens"], kw["q_position_lens"]
    if append:
        for b in range(B):
            for t in range(T):
                p = qlens[b] + t
                if 0 <= p < N_SHARD:
                    kf[b, p], vf[b, p] = new[0][b, t], new[1][b, t]
    live = cs + (T if append else 0)
    wl = kw.get("window_size", (-1, -1))[0]
    group = q.shape[2] // kf.shape[2]
    out = torch.zeros(q.shape)
    for b in range(B):
        n = int(live[b])
        first = int(qlens[b]) - (0 if append else T)   # row 0's position
        if n == 0:
            continue
        kk = torch.from_numpy(kf[b, :n]).repeat_interleave(group, 1)
        vv = torch.from_numpy(vf[b, :n]).repeat_interleave(group, 1)
        s = torch.einsum("thd,nhd->htn", torch.from_numpy(q[b]), kk)
        s = s * q.shape[-1] ** -0.5
        qpos = first + torch.arange(T)[:, None]
        j = torch.arange(n)[None, :]
        vis = (j <= qpos) & ((j >= qpos - wl) if wl >= 0 else True)
        s = s.masked_fill(~vis, float("-inf"))
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)
        out[b] = torch.einsum("htn,nhd->thd", p, vv)
    return out
