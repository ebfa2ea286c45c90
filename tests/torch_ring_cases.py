"""Rank bodies of the port's sequence-parallel tests
(tests/test_torch_parallel_ring*.py, _zigzag.py, _ulysses.py, _train*.py),
run on spawned gloo ranks by tests/torch_parallel_cases.py::spawn; the JAX
side is tests/torch_ring_jax.py.  Like torch_parallel_cases.py, this
module imports torch, numpy and the port only.  The inputs are numpy
arrays made from seeds by the `*_inputs` functions below, which the parent
calls too."""

from __future__ import annotations

import numpy as np
import torch

from flash_attn_v100_tpu_torch.models import transformer as tt
from flash_attn_v100_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, local_shard, make_mesh,
    ring_attention, ulysses_attention, zigzag_shard)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# ring attention (contiguous and zigzag) and Ulysses

# name: ((data, seq, model), B, M, Hq, Hk, D, kwargs); the JAX package's
# tests/test_parallel.py ring cases, narrowed
RING_CASES = {
    "seq2_causal": ((1, 2, 1), 1, 64, 2, 2, 32, dict(causal=True)),
    "seq2_noncausal": ((1, 2, 1), 1, 64, 2, 2, 32, dict(causal=False)),
    "seq4_causal": ((1, 4, 1), 1, 128, 2, 2, 32, dict(causal=True)),
    "seq4_noncausal": ((1, 4, 1), 1, 128, 2, 2, 32, dict(causal=False)),
    "seq2_model2_gqa": ((1, 2, 2), 1, 64, 4, 2, 32, dict(causal=True)),
    "seq4_window_softcap": ((1, 4, 1), 1, 128, 2, 2, 32,
                            dict(causal=True, window_size=(40, -1),
                                 softcap=9.0)),
    "seq2_window_noncausal": ((1, 2, 1), 1, 64, 2, 2, 32,
                              dict(causal=False, window_size=(20, 9))),
    "seq2_model2_alibi": ((1, 2, 2), 1, 64, 4, 4, 32,
                          dict(causal=True, alibi=True)),
    "data2_seq2_dropout": ((2, 2, 1), 2, 64, 2, 2, 32,
                           dict(causal=True, dropout_p=0.3)),
    "zigzag_seq2_softcap": ((1, 2, 1), 1, 64, 2, 2, 32,
                            dict(causal=True, layout="zigzag",
                                 softcap=6.0)),
    "zigzag_seq4": ((1, 4, 1), 1, 128, 2, 2, 32,
                    dict(causal=True, layout="zigzag")),
}
RING_SEED = (123, 456)

# name: ((data, seq, model), B, M, Hq, Hk, D, kwargs): test_parallel.py's
# ulysses cases (the three kwarg sets of test_ulysses_attention, and the
# gradient of test_ulysses_grad), narrowed
ULYSSES_CASES = {
    "causal": ((1, 4, 1), 1, 64, 8, 4, 32, dict(causal=True)),
    "causal_window": ((1, 4, 1), 1, 64, 8, 4, 32,
                      dict(causal=True, window_size=(20, -1))),
    "noncausal_softcap": ((1, 4, 1), 1, 64, 8, 4, 32,
                          dict(causal=False, softcap=10.0)),
    "data2_seq2_causal": ((2, 2, 1), 2, 64, 4, 4, 32, dict(causal=True)),
}


def attn_inputs(name, cases):
    _, B, M, Hq, Hk, D, kw = cases[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = dict(q=mk(B, M, Hq, D), k=mk(B, M, Hk, D), v=mk(B, M, Hk, D),
             do=mk(B, M, Hq, D))
    if kw.get("alibi"):
        x["slopes"] = rng.uniform(0.01, 0.2, (B, Hq)).astype(np.float32)
    return x


def ring_kwargs(name, x):
    """The case's ring_attention kwargs (the same for both packages but
    the seed's name)."""
    kw = dict(RING_CASES[name][-1])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = x["slopes"]
    if kw.get("dropout_p"):
        kw["dropout_seed"] = np.asarray(RING_SEED, np.uint32)
    return kw


def _attn_case(mesh, x, fn, q_spec):
    """fn on the global inputs; this rank's output block and its
    gradients of sum(out * do) w.r.t. the global q, k, v."""
    q, k, v = (_t(x[n]).requires_grad_(True) for n in "qkv")
    out = fn(q, k, v)
    do = local_shard(_t(x["do"]), q_spec, mesh)
    (out * do).sum().backward()
    return dict(coords=mesh.coords, out=_np(out),
                grads=[_np(t.grad) for t in (q, k, v)])


def ring_body(inputs):
    """Every ring case named in inputs["ring"] and every Ulysses case in
    inputs["ulysses"] on its mesh; ranks outside a case's mesh sit it out.
    Zigzag cases take zigzag_shard-ed inputs."""
    res = {"ring": {}, "ulysses": {}}
    meshes = {}
    for group, cases in (("ring", RING_CASES), ("ulysses", ULYSSES_CASES)):
        for name in inputs.get(group, ()):
            shape = cases[name][0]
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape)
            mesh = meshes[shape]
            if not mesh.is_member:
                continue
            x = attn_inputs(name, cases)
            if group == "ring":
                kw = ring_kwargs(name, x)
                if kw.get("layout") == "zigzag":
                    n = shape[1]
                    x = {k: _np(zigzag_shard(_t(a), n))
                         for k, a in x.items()}
                spec = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS, None)
                r = _attn_case(mesh, x, lambda q, k, v: ring_attention(
                    q, k, v, mesh, **kw), spec)
            else:
                kw = cases[name][-1]
                spec = (DATA_AXIS, SEQ_AXIS, None, None)
                r = _attn_case(mesh, x, lambda q, k, v: ulysses_attention(
                    q, k, v, mesh, **kw), spec)
            res[group][name] = r
    return res


# ---------------------------------------------------------------------------
# the sharded model: forward, loss_fn, gradients, sgd_train_step and one
# make_train_step AdamW step

TRAIN_B, TRAIN_S = 4, 33         # 32 rows after the shift, seq-divisible
SGD_LR = 5e-2


def train_tokens():
    return np.random.default_rng(3).integers(
        0, 256, (TRAIN_B, TRAIN_S)).astype(np.int32)


def _params(tree):
    out = {k: _t(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: _t(v) for k, v in lp.items()}
                     for lp in tree["layers"]]
    return out


def _leaves(params):
    return [_np(t) for t in tt.param_leaves(params)]


def train_body(inputs):
    """The model on inputs["mesh"]: this rank's logits block, the loss,
    its gradient shards (summed over "data" and "seq"), the shards after
    one sgd_train_step and after one make_train_step AdamW step."""
    cfg = tt.ModelConfig.tiny(dropout_p=inputs["dropout_p"],
                              n_layers=inputs["n_layers"])
    mesh = make_mesh(*inputs["mesh"])
    if not mesh.is_member:
        return None
    tokens = _t(inputs["tokens"])
    seeds = inputs["seeds"]
    shard = tt.shard_params(_params(inputs["params"]), cfg, mesh)
    res = dict(coords=mesh.coords)
    with torch.no_grad():
        res["logits"] = _np(tt.forward(shard, tokens[:, :-1], cfg,
                                       mesh=mesh, dropout_seeds=seeds))
    leaves = tt._map_params(shard, lambda t: t.clone().requires_grad_(True))
    loss = tt.loss_fn(leaves, tokens, cfg, mesh=mesh, dropout_seeds=seeds)
    loss.backward()
    grads = [t.grad for t in tt.param_leaves(leaves)]
    tt._reduce_grads(grads, mesh)
    res.update(loss=float(loss), grads=[_np(g) for g in grads])
    sgd_loss, sgd = tt.sgd_train_step(shard, tokens, cfg, lr=SGD_LR,
                                      mesh=mesh, dropout_seeds=seeds)
    res.update(sgd_loss=float(sgd_loss), sgd=_leaves(sgd))
    step, init_opt = tt.make_train_step(cfg, mesh=mesh)
    leaves = tt._map_params(shard, lambda t: t.clone().requires_grad_(True))
    opt = init_opt(leaves)
    adam_loss, leaves, opt = step(leaves, opt, tokens, dropout_seeds=seeds)
    res.update(adam_loss=float(adam_loss), adam=_leaves(leaves))
    return res


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_gpu_ring.py): ring and Ulysses attention
# through K1-K3 on 2 gloo ranks sharing the device

# name: (dtype, B, M, Hq, Hk, D, kwargs); seq 2, so 256 rows a rank
GPU_CASES = {
    "causal_d64": ("bf16", 1, 512, 4, 2, 64, dict(causal=True)),
    "causal_fp16_d128": ("fp16", 2, 512, 4, 2, 128, dict(causal=True)),
    # rows past 355 of rank 1 see no key of rank 0's chunk: O = 0 and
    # LSE = -inf from K1, dropped by the merge
    "window_softcap_d128": ("bf16", 1, 512, 4, 2, 128,
                            dict(causal=True, window_size=(100, -1),
                                 softcap=10.0)),
    "noncausal_window_d64": ("bf16", 1, 512, 4, 4, 64,
                             dict(window_size=(60, 30))),
    "alibi_d64": ("bf16", 2, 512, 4, 2, 64, dict(causal=True, alibi=True)),
    "dropout_d64": ("bf16", 2, 512, 4, 2, 64,
                    dict(causal=True, dropout_p=0.1)),
    "zigzag_d128": ("bf16", 1, 512, 4, 2, 128,
                    dict(causal=True, layout="zigzag")),
    "ulysses_d64": ("bf16", 1, 512, 4, 2, 64, dict(causal=True)),
    "ulysses_window_d128": ("bf16", 1, 512, 4, 2, 128,
                            dict(causal=True, window_size=(100, -1))),
}


def gpu_inputs(name):
    """A card case's global inputs as fp32 numpy (cast on the card) and
    its kwargs (ALiBi slopes (B, Hq), the dropout seed)."""
    _, B, M, Hq, Hk, D, kw = GPU_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = dict(q=mk(B, M, Hq, D), k=mk(B, M, Hk, D), v=mk(B, M, Hk, D),
             do=mk(B, M, Hq, D))
    kw = dict(kw)
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = rng.uniform(0.01, 0.2, (B, Hq)).astype(
            np.float32)
    if kw.get("dropout_p"):
        kw["dropout_seed"] = RING_SEED
    return x, kw


def gpu_ring_body(inputs):
    """Every card case on seq 2: this rank's output block, its gradient
    blocks of the global inputs (zigzag order for zigzag), and its K1-K3
    launches and plain-twin calls; the Ulysses cases also whether the
    rank's rows are bit-equal to the unsharded flash_attn_func's."""
    from flash_attn_v100_tpu_torch import flash_attn_func
    from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
    from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
    mesh = make_mesh(seq=2)
    s = mesh.index(SEQ_AXIS)
    res = {}
    for name in inputs["cases"]:
        dt, B, M, *_ = GPU_CASES[name]
        dtype = torch.bfloat16 if dt == "bf16" else torch.float16
        x, kw = gpu_inputs(name)
        t = {k: _t(a).to("cuda", dtype) for k, a in x.items()}
        if kw.get("layout") == "zigzag":
            t = {k: zigzag_shard(a, 2) for k, a in t.items()}
        if "alibi_slopes" in kw:
            kw["alibi_slopes"] = _t(kw["alibi_slopes"]).cuda()
        rows = slice(s * (M // 2), (s + 1) * (M // 2))
        q, k, v = (t[n].clone().requires_grad_(True) for n in "qkv")
        counters = (dfwd.flash_attn_dense_fwd, dbwd.dq_kernel,
                    dbwd.dkv_kernel)
        before = [c.launches for c in counters]
        plain = (dfwd.flash_attn_dense_fwd_ref.calls,
                 dbwd.flash_attn_dense_bwd_ref.calls)
        if name.startswith("ulysses"):
            out = ulysses_attention(q, k, v, mesh, **kw)
        else:
            out = ring_attention(q, k, v, mesh, **kw)
        out.backward(t["do"][:, rows])
        torch.cuda.synchronize()
        r = dict(out=out.detach().cpu(),
                 grads=[g.grad[:, rows].cpu() for g in (q, k, v)],
                 launches=[c.launches - b for c, b in zip(counters, before)],
                 plain=[dfwd.flash_attn_dense_fwd_ref.calls - plain[0],
                        dbwd.flash_attn_dense_bwd_ref.calls - plain[1]])
        if name.startswith("ulysses"):
            qu, ku, vu = (t[n].clone().requires_grad_(True) for n in "qkv")
            ref = flash_attn_func(qu, ku, vu, **kw)
            ref.backward(t["do"])
            r["bit_equal"] = [torch.equal(out, ref[:, rows])] + [
                torch.equal(a.grad[:, rows], b.grad[:, rows])
                for a, b in zip((q, k, v), (qu, ku, vu))]
        res[name] = r
    return res


# ---------------------------------------------------------------------------
# LoRA on a mesh (tests/test_torch_lora_mesh*.py): the base sharded by
# shard_params, the adapters replicated

def lora_body(inputs):
    """make_lora_train_step(mesh=) on inputs["mesh"]: whether materialize
    on this rank's shard equals the shard of the unsharded materialize (and
    their largest difference), the step's loss, the adapters' gradients
    (summed over the mesh) and the adapters after the AdamW step."""
    from flash_attn_v100_tpu_torch.integrations import lora as tl
    cfg = tt.ModelConfig.tiny(n_layers=inputs["n_layers"])
    lcfg = tl.LoraConfig(rank=inputs["rank"], targets=inputs["targets"])
    mesh = make_mesh(*inputs["mesh"])
    if not mesh.is_member:
        return None
    tokens = _t(inputs["tokens"])
    full = _params(inputs["params"])
    shard = tt.shard_params(full, cfg, mesh)
    lora = tl.lora_from_jax(inputs["lora"], device="cpu")
    res = dict(coords=mesh.coords)
    with torch.no_grad():
        cut = tt.param_leaves(tl.materialize(shard, lora, lcfg, mesh))
        whole = tt.param_leaves(tt.shard_params(
            tl.materialize(full, lora, lcfg), cfg, mesh))
        res["materialize_equal"] = all(torch.equal(a, b)
                                       for a, b in zip(cut, whole))
        res["materialize_err"] = max(float((a - b).abs().max())
                                     for a, b in zip(cut, whole))
    step, init_opt = tl.make_lora_train_step(cfg, lcfg, mesh=mesh)
    opt = init_opt(lora)
    loss, lora, opt = step(lora, opt, shard, tokens)
    leaves = tl.lora_leaves(lora)
    res.update(loss=float(loss), grads=[_np(t.grad) for t in leaves],
               adam=[_np(t) for t in leaves])
    return res
