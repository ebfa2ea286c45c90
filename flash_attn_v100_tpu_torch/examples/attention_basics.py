"""Tour of the three public attention functions (dense / varlen / kvcache),
the port's counterpart of the JAX package's examples/attention_basics.py.

    python -m flash_attn_v100_tpu_torch.examples.attention_basics
    python -m flash_attn_v100_tpu_torch.examples.attention_basics --device cpu

On the GPU the calls run K1-K3 (dense, with gradients), K5 (varlen) and
K4q (decode from an int8 pool); with --device cpu their plain versions.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from flash_attn_v100_tpu_torch import (
    flash_attn_func, flash_attn_varlen_func, flash_attn_with_kvcache,
    quantize_kv)
from flash_attn_v100_tpu_torch.config import resolve_device
from flash_attn_v100_tpu_torch.ops.padding import pad_input, unpad_input


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    def mk(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
            dev, torch.bfloat16)

    # ---- dense, GQA, causal; differentiable ----------------------------
    B, M, Hq, Hk, D = 2, 256, 8, 4, 64
    q, k, v = (x.requires_grad_() for x in (mk(B, M, Hq, D), mk(B, M, Hk, D),
                                            mk(B, M, Hk, D)))
    with torch.no_grad():
        out = flash_attn_func(q, k, v, causal=True)
    loss = flash_attn_func(q, k, v, causal=True, window_size=(256, 0),
                           softcap=30.0).float().sum()
    dq, dk, dv = torch.autograd.grad(loss, (q, k, v))
    print("dense:", tuple(out.shape), "grads:", tuple(dq.shape),
          tuple(dk.shape), tuple(dv.shape))

    # ---- varlen: a ragged batch packed with the bert_padding helpers ----
    lens = torch.tensor([180, 256], device=dev)
    mask = torch.arange(M, device=dev)[None, :] < lens[:, None]
    q_p, idx, cu, maxlen, _ = unpad_input(q.detach(), mask)
    k_p = unpad_input(k.detach(), mask)[0]
    v_p = unpad_input(v.detach(), mask)[0]
    with torch.no_grad():
        out_p = flash_attn_varlen_func(q_p, k_p, v_p, cu, cu, maxlen, maxlen,
                                       causal=True)
    out_batch = pad_input(out_p, idx, B, M)
    print("varlen:", tuple(out_p.shape), "->", tuple(out_batch.shape))

    # ---- kvcache decode: a paged int8 pool, rotary, append --------------
    ps, N = 128, 1024
    pages = B * N // ps
    kq, ks = quantize_kv(mk(Hk, pages, ps, D), torch.int8)
    vq, vs = quantize_kv(mk(Hk, pages, ps, D), torch.int8)
    table = torch.arange(pages, dtype=torch.int32, device=dev).reshape(B, -1)
    cs = torch.tensor([700, 400], dtype=torch.int32, device=dev)
    qd, kn, vn = mk(B, 1, Hq, D), mk(B, 1, Hk, D), mk(B, 1, Hk, D)
    inv = 10000.0 ** (-torch.arange(0, D, 2, device=dev) / D)
    ang = torch.arange(N, device=dev)[:, None] * inv[None, :]
    out_d = flash_attn_with_kvcache(
        qd, kq, vq, k=kn, v=vn, cache_seqlens=cs, block_table=table,
        k_scales=ks, v_scales=vs, rotary_cos=torch.cos(ang),
        rotary_sin=torch.sin(ang), causal=True, kv_cache_layout="HND")
    o = out_d[0] if isinstance(out_d, tuple) else out_d
    if not all(torch.isfinite(t.float()).all() for t in (out, dq, out_p, o)):
        raise RuntimeError("attention_basics: non-finite output")
    print("decode:", tuple(o.shape), "int8 pool bytes/token:",
          Hk * (D + 4) * 2)
    return dict(dense=tuple(out.shape), varlen=tuple(out_p.shape),
                decode=tuple(o.shape))


if __name__ == "__main__":
    main()
