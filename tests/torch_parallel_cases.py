"""Rank bodies of the multi-process port tests (tests/test_torch_parallel_*.py
and tests/test_torch_engine_sharded*.py; tests/torch_parallel_jax.py holds
the JAX side).

`spawn` starts `world` processes with the spawn method, joins them in one
gloo process group (a file:// rendezvous under the test's tmp_path, so
that test workers never share a port), and runs one body on every rank:
the body builds its meshes, runs all of its file's cases on its own
shards, and returns a picklable result that the parent reads back, one
per rank.  This module imports torch, numpy and the port only, so a
spawned child never imports JAX; the parent holds the results against
the JAX package.  The inputs are numpy arrays made from seeds by the
`*_inputs` functions below, which the parent calls too.
"""

from __future__ import annotations

import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from flash_attn_v100_tpu_torch import ModelConfig, ServingEngine
from flash_attn_v100_tpu_torch.models.transformer import shard_params
from flash_attn_v100_tpu_torch.ops.cuda import decode as tdec
from flash_attn_v100_tpu_torch.ops.quant import quantize_kv
from flash_attn_v100_tpu_torch.parallel import (
    MODEL_AXIS, SEQ_AXIS, flash_attn_func_sharded,
    flash_attn_with_kvcache_sharded, local_shard, make_hybrid_mesh,
    make_mesh, merge_lse_across)
from flash_attn_v100_tpu_torch.parallel.mesh import all_reduce

SPAWN_TIMEOUT_S = 120


def spawn(body: str, world: int, tmp_path: Path, inputs=None) -> list:
    """Run the rank body named `body` on `world` gloo ranks; returns the
    ranks' results in rank order.  A rank that raises fails the spawn."""
    tmp_path = Path(tmp_path)
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.start_processes(
        _rank_main, args=(world, str(tmp_path), body), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{body} on {world} ranks took over "
                               f"{SPAWN_TIMEOUT_S} s")
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, tmp: str, body: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    try:
        with open(f"{tmp}/inputs.pkl", "rb") as f:
            inputs = pickle.load(f)
        res = globals()[body](inputs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# head-sharded dense attention, meshes, the LSE merge

# (data, seq, model) meshes of the dense cases over 4 ranks
DENSE_MESHES = [(1, 1, 4), (2, 1, 2)]
# name: (mesh, B, M, Hq, Hk, D, causal)
DENSE_CASES = {
    "model4_noncausal": ((1, 1, 4), 4, 64, 8, 4, 32, False),
    "model4_causal": ((1, 1, 4), 4, 64, 8, 4, 32, True),
    "model4_kv_replicated": ((1, 1, 4), 2, 64, 8, 2, 32, True),
    "data2_model2_causal": ((2, 1, 2), 4, 64, 8, 4, 32, True),
}


def dense_inputs(name):
    _, B, M, Hq, Hk, D, _ = DENSE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(q=mk(B, M, Hq, D), k=mk(B, M, Hk, D), v=mk(B, M, Hk, D),
                do=mk(B, M, Hq, D))


def merge_inputs(n_shards=4, rows=6, D=8):
    """Per-shard partials; row 0 empty on every shard, row 1 on all but
    one, row 2 on the first shard only."""
    rng = np.random.default_rng(3)
    o = rng.standard_normal((n_shards, rows, D)).astype(np.float32)
    lse = rng.standard_normal((n_shards, rows, 1)).astype(np.float32) * 3
    lse[:, 0] = -np.inf
    lse[1:, 1] = -np.inf
    lse[0, 2] = -np.inf
    o[np.isinf(lse[..., 0])] = 0.0
    return o, lse


def parallel_body(inputs):
    """The dense cases named in inputs["dense"] (head-sharded attention,
    output and gradients) and, with inputs["mesh"], the meshes, the LSE
    merge alone and make_hybrid_mesh's checks, on 4 ranks."""
    res = {"dense": {}}
    meshes = {s: make_mesh(*s) for s in DENSE_MESHES}
    for name in inputs["dense"]:
        ms, *_shape, causal = DENSE_CASES[name]
        mesh = meshes[ms]
        x = dense_inputs(name)
        q, k, v = (_t(x[n]).requires_grad_(True) for n in "qkv")
        out = flash_attn_func_sharded(q, k, v, mesh, causal=causal)
        do = local_shard(_t(x["do"]), (
            "data", None, MODEL_AXIS, None), mesh)
        (out * do).sum().backward()
        # every rank's gradient covers its blocks: the sum is the whole
        grads = [all_reduce(g.grad.contiguous(), mesh, "data")
                 for g in (q, k, v)]
        grads = [all_reduce(g, mesh, MODEL_AXIS) for g in grads]
        res["dense"][name] = dict(coords=mesh.coords, out=_np(out),
                                  grads=[_np(g) for g in grads])
    if not inputs["mesh"]:
        return res
    rank = dist.get_rank()
    m = make_mesh(data=1, seq=2, model=2)
    sums = {}
    for ax in (SEQ_AXIS, MODEL_AXIS):
        t = torch.tensor([float(rank)])
        sums[ax] = float(all_reduce(t, m, ax)[0])
    m2 = make_mesh(data=2, seq=1, model=-1)
    res["mesh"] = dict(shape=m.shape, coords=m.coords, sums=sums,
                       shape2=m2.shape, coords2=m2.coords)
    errs = []
    for kw in (dict(seq=4, ranks_per_host=2), dict(data=3, seq=2),
               dict(seq=3), dict(seq=2, ranks_per_host=3)):
        try:
            make_hybrid_mesh(**kw)
        except ValueError:
            errs.append(True)
        else:
            errs.append(False)
    hm = make_hybrid_mesh(seq=2, ranks_per_host=2)
    res["hybrid"] = dict(errors=errs, shape=hm.shape, coords=hm.coords)

    mseq = make_mesh(seq=4)
    o, lse = merge_inputs()
    s = mseq.index(SEQ_AXIS)
    om, lm = merge_lse_across(_t(o[s]), _t(lse[s]), mseq, SEQ_AXIS)
    res["merge"] = dict(o=_np(om), lse=_np(lm))
    return res


# ---------------------------------------------------------------------------
# sequence-sharded KV-cache attention

DECODE_CASES = ["contig_decode", "contig_append_rotary_tnew",
                "contig_window_alibi", "paged_int8", "paged_append"]


def decode_inputs(name, sp):
    """Global numpy inputs of a decode case on a seq axis of `sp` (the
    JAX package's test_parallel.py cases)."""
    rng = np.random.default_rng(sum(map(ord, name)) + sp)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    B, Hq, Hk, D = 2, 4, 2, 64
    kw = dict(causal=True)
    if name.startswith("contig"):
        N = 512
        T = {"contig_decode": 1, "contig_append_rotary_tnew": 3,
             "contig_window_alibi": 2}[name]
        x = dict(q=mk(B, T, Hq, D), kc=mk(B, Hk, N, D), vc=mk(B, Hk, N, D),
                 lens=np.asarray([300, 77] if T != 2 else [400, 150],
                                 np.int32))
        if name == "contig_append_rotary_tnew":
            x.update(k=mk(B, T, Hk, D), v=mk(B, T, Hk, D),
                     cos=mk(N, D // 2), sin=mk(N, D // 2))
        if name == "contig_window_alibi":
            kw["window_size"] = (200, -1)
            x["slopes"] = rng.uniform(0.01, 0.2, (Hq,)).astype(np.float32)
        return x, kw
    ps, mp_local = 64, 2
    P_local = B * mp_local
    x = dict(q=mk(B, 1, Hq, D))
    pools_k, pools_v, tbls = [], [], []
    for _ in range(sp):
        pools_k.append(mk(Hk, P_local, ps, D))
        pools_v.append(mk(Hk, P_local, ps, D))
        tbls.append(rng.permutation(P_local).reshape(B, mp_local).astype(
            np.int32))
    x["pool_k"] = np.concatenate(pools_k, axis=1)
    x["pool_v"] = np.concatenate(pools_v, axis=1)
    x["tbl_sharded"] = np.concatenate(tbls, axis=1)
    x["tbl_global"] = np.concatenate(
        [tbls[s] + s * P_local for s in range(sp)], axis=1)
    if name == "paged_int8":
        x["lens"] = np.asarray([mp_local * ps - 13, 70], np.int32)
    else:
        x["lens"] = np.asarray([mp_local * ps + 2, 63], np.int32)
        x.update(k=mk(B, 1, Hk, D), v=mk(B, 1, Hk, D))
    return x, kw


def decode_body(inputs):
    """Every decode case on the (data, seq, model) mesh inputs["mesh"]:
    this rank's out / LSE blocks and its cache shards after the call."""
    tdec.P_TILE = None          # P grouped per page, as the JAX package
    res = {}
    for ms, mesh in [(inputs["mesh"], make_mesh(*inputs["mesh"]))]:
        sp = mesh.shape[SEQ_AXIS]
        for name in DECODE_CASES:
            x, kw = decode_inputs(name, sp)
            head = (None, None, MODEL_AXIS, None)
            q = local_shard(_t(x["q"]), head, mesh).contiguous()
            args = {}
            if "k" in x:
                args.update(k=local_shard(_t(x["k"]), head, mesh),
                            v=local_shard(_t(x["v"]), head, mesh))
            if "cos" in x:
                args.update(rotary_cos=_t(x["cos"]), rotary_sin=_t(x["sin"]))
            if "slopes" in x:
                args["alibi_slopes"] = local_shard(_t(x["slopes"]),
                                                   (MODEL_AXIS,), mesh)
            if name.startswith("contig"):
                spec = (None, MODEL_AXIS, SEQ_AXIS, None)
                caches = [x["kc"], x["vc"]]
            else:
                spec = (MODEL_AXIS, SEQ_AXIS, None, None)
                caches = [x["pool_k"], x["pool_v"]]
                args["block_table"] = local_shard(
                    _t(x["tbl_sharded"]), (None, SEQ_AXIS), mesh)
            if name == "paged_int8":
                # the port's quantize_kv: bit-equal to the JAX package's
                (kq, ks), (vq, vs) = (
                    (_np(a), _np(b)) for a, b in (
                        quantize_kv(_t(c), torch.int8) for c in caches))
                caches = [kq, vq]
                args.update(k_scales=local_shard(_t(ks), spec,
                                                 mesh).contiguous(),
                            v_scales=local_shard(_t(vs), spec,
                                                 mesh).contiguous())
            kc, vc = (local_shard(_t(c), spec, mesh).contiguous()
                      for c in caches)
            out = flash_attn_with_kvcache_sharded(
                q, kc, vc, mesh, _t(x["lens"]), return_softmax_lse=True,
                **args, **kw)
            r = dict(coords=mesh.coords, out=_np(out[0]), lse=_np(out[1]))
            if "k" in x:
                r["caches"] = [_np(c) for c in out[2]]
            res[(ms, name)] = r
    return res


# ---------------------------------------------------------------------------
# the sharded serving engine

def tiny_cfg(**kw):
    base = dict(max_seq_len=64, vocab_size=64)
    base.update(kw)
    return ModelConfig.tiny(**base)


LONG_PROMPT = [int(x) % 60 for x in range(7, 27)]   # 20 + 14 = 34 tokens
SHORT_PROMPT = [3, 1, 4, 1, 5]
PREFIX_PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3,
                 2, 3, 8, 4, 6, 2, 6, 4, 3, 5]      # 3 full pages + 2

# name: (mesh, engine kwargs, script name)
ENGINE_CASES = {
    "tp_model2": ((1, 1, 2), dict(num_pages=16), "two_prompts"),
    "seq2_model2_int8": ((1, 2, 2), dict(num_pages=16, kv_dtype=torch.int8),
                         "two_prompts_6"),
    "seq2_model2_fp32": ((1, 2, 2), dict(num_pages=16), "two_prompts_6"),
    "seq4_long_context": ((1, 4, 1), dict(num_pages=16), "long"),
    "seq4_capacity": ((1, 4, 1), dict(num_pages=2), "long_and_short"),
    "seq4_prefix_offsets": ((1, 4, 1), dict(num_pages=16, max_batch=4),
                            "prefix"),
}


def run_script(eng, script: str) -> dict:
    """Drive an engine (the JAX package's or the port's) through one named
    request sequence; returns {name: tokens} and the prefix metrics."""
    if script in ("two_prompts", "two_prompts_6"):
        n = 5 if script == "two_prompts" else 6
        prompts = ([[3, 1, 4, 1, 5], [2, 7, 1]] if n == 5
                   else [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1]])
        rids = {i: eng.submit(p, max_new_tokens=n)
                for i, p in enumerate(prompts)}
    elif script == "long":
        rids = {"long": eng.submit(LONG_PROMPT, max_new_tokens=14)}
    elif script == "long_and_short":
        rids = {"long": eng.submit(LONG_PROMPT, max_new_tokens=14),
                "short": eng.submit(SHORT_PROMPT, max_new_tokens=4)}
    elif script == "prefix":
        rids = {"first": eng.submit(PREFIX_PROMPT, max_new_tokens=8)}
        eng.step()                   # the first prefills, its pages commit
        rids["second"] = eng.submit(PREFIX_PROMPT, max_new_tokens=5)
    else:
        raise ValueError(script)
    out = eng.run_to_completion()
    toks = {k: [int(t) for t in out[r]] for k, r in rids.items()}
    return dict(tokens=toks, prefix_hits=eng.metrics["prefix_hits"],
                prefix_tokens_reused=eng.metrics["prefix_tokens_reused"])


def numpy_params(params) -> dict:
    """A port parameter dict as numpy arrays, to send to the ranks."""
    out = {k: v.numpy() for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: v.numpy() for k, v in lp.items()}
                     for lp in params["layers"]]
    return out


def engine_body(inputs):
    """Every engine case on its mesh; ranks outside a mesh sit it out."""
    params = {k: _t(v) for k, v in inputs["params"].items()
              if k != "layers"}
    params["layers"] = [{k: _t(v) for k, v in lp.items()}
                        for lp in inputs["params"]["layers"]]
    cfg = tiny_cfg()
    res = {}
    for name in inputs["cases"]:
        ms, kw, script = ENGINE_CASES[name]
        mesh = make_mesh(*ms)
        if not mesh.is_member:
            continue
        kw = dict(dict(max_batch=2, page_size=8), **kw)
        eng = ServingEngine(shard_params(params, cfg, mesh), cfg,
                            device="cpu", mesh=mesh, **kw)
        r = run_script(eng, script)
        r["seq_shards"] = eng.seq_shards
        r["pool_shape"] = tuple(eng.k_pool.shape)
        res[name] = r
    return res
