"""Plain PyTorch reference attention (the oracle).

Semantics:
  offset = seqlen_k - seqlen_q                  # bottom-right aligned
  causal  masks  j - offset >  i
  window  masks  j - offset <  i - window_left   (window_left  >= 0)
                 j - offset >  i + window_right  (window_right >= 0)
  val = s * softmax_scale
  val = val - alibi_slope * |i - (j - offset)|   (before softcap)
  val = softcap * tanh(val / softcap)            (after scale + alibi)
  masked positions -> -inf
Fully-masked rows produce out = 0 and lse = -inf.  `upcast=True` computes
in fp32; `upcast=False` keeps the input dtype for both products (the
same-bit-width yardstick of utils/testing.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from flash_attn_v100_tpu_torch.ops.rotary import apply_rotary_emb


def mha_reference(q, k, v, softmax_scale: Optional[float] = None,
                  causal: bool = False,
                  window_size: Tuple[int, int] = (-1, -1),
                  softcap: float = 0.0, alibi_slopes=None,
                  upcast: bool = True, return_lse: bool = False):
    """q (B, M, Hq, D), k/v (B, N, Hk, D) -> out (B, M, Hq, D)
    [, lse (B, Hq, M) fp32]."""
    dtype_og = q.dtype
    B, M, Hq, D = q.shape
    N, Hk = k.shape[1], k.shape[2]
    group = Hq // Hk
    if softmax_scale is None:
        softmax_scale = D ** -0.5
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(group, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(group, dim=1)
    s = torch.einsum("bhmd,bhnd->bhmn", qt, kt).float() * softmax_scale

    dev = q.device
    i = torch.arange(M, device=dev)[:, None]
    j = torch.arange(N, device=dev)[None, :]
    offset = N - M
    allowed = torch.ones((M, N), dtype=torch.bool, device=dev)
    if causal:
        allowed &= (j - offset) <= i
    wl, wr = window_size
    if wl >= 0:
        allowed &= (j - offset) >= (i - wl)
    if wr >= 0:
        allowed &= (j - offset) <= (i + wr)
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=dev)
        if slopes.dim() == 1:
            slopes = slopes[None].expand(B, Hq)
        dist = (i - (j - offset)).abs().float()
        s = s - slopes[:, :, None, None] * dist
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(allowed, s, torch.full_like(s, float("-inf")))

    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(torch.isfinite(s), torch.exp(s - m_safe),
                    torch.zeros_like(s))
    l = e.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    p = e / l_safe
    lse = torch.where(l[..., 0] == 0, torch.full_like(l[..., 0], float("-inf")),
                      m_safe[..., 0] + torch.log(l_safe[..., 0]))
    o = torch.einsum("bhmn,bhnd->bhmd", p.to(vt.dtype), vt)
    out = o.transpose(1, 2).to(dtype_og)
    return (out, lse.float()) if return_lse else out


def mha_reference_kvcache(q, k_cache, v_cache, k_new=None, v_new=None,
                          rotary_cos=None, rotary_sin=None,
                          cache_seqlens=None, cache_batch_idx=None,
                          cache_leftpad=None, softmax_scale=None,
                          causal=False, window_size=(-1, -1), softcap=0.0,
                          rotary_interleaved=True, alibi_slopes=None,
                          upcast=True, return_lse=False):
    """KV-cache oracle, one batch row at a time.  Caches are contiguous
    token-major (Bc, N, Hk, D) and are not modified.  Optional RoPE on q /
    new k, append at leftpad + cache_seqlens, attention of the T_new queries
    against cache[leftpad : leftpad + cache_seqlens + T_new] with
    bottom-right causal.  Returns (out, updated k_cache, updated v_cache
    [, lse (B, Hq, T_new)])."""
    B, T_new, Hq, D = q.shape
    Bc, N, Hk, _ = k_cache.shape
    dev = q.device
    if cache_seqlens is None:
        cs = torch.full((B,), 0 if k_new is not None else N, dtype=torch.long)
    else:
        cs = torch.as_tensor(cache_seqlens).to(torch.long).cpu().reshape(-1)
        if cs.numel() == 1:
            cs = cs.expand(B)
    lp = (torch.zeros(B, dtype=torch.long) if cache_leftpad is None
          else torch.as_tensor(cache_leftpad).to(torch.long).cpu())
    bidx = (torch.arange(B) if cache_batch_idx is None
            else torch.as_tensor(cache_batch_idx).to(torch.long).cpu())
    local = window_size[0] >= 0 or window_size[1] >= 0

    if rotary_cos is not None:
        ar = torch.arange(T_new)
        pos_q = cs[:, None] + ar if (causal or local) else \
            cs[:, None].expand(B, T_new)
        q = apply_rotary_emb(q, rotary_cos, rotary_sin, pos_q.to(dev),
                             interleaved=rotary_interleaved)
        if k_new is not None:
            k_new = apply_rotary_emb(k_new, rotary_cos, rotary_sin,
                                     (cs[:, None] + ar).to(dev),
                                     interleaved=rotary_interleaved)

    kc = k_cache.float().clone()
    vc = v_cache.float().clone()
    if k_new is not None:
        for b in range(B):
            s0 = int(lp[b] + cs[b])
            kc[bidx[b], s0:s0 + T_new] = k_new[b].float()
            vc[bidx[b], s0:s0 + T_new] = v_new[b].float()

    total = cs + (T_new if k_new is not None else 0)
    wl, wr = window_size
    if causal:
        wr = 0
    cd = torch.float32 if upcast else q.dtype
    outs, lses = [], []
    for b in range(B):
        lo, hi = int(lp[b]), int(lp[b] + total[b])
        kb = kc[bidx[b], lo:hi][None].to(cd)
        vb = vc[bidx[b], lo:hi][None].to(cd)
        slopes_b = None
        if alibi_slopes is not None:
            sl = torch.as_tensor(alibi_slopes)
            slopes_b = sl if sl.dim() == 1 else sl[b]
        o_b, lse_b = mha_reference(
            q[b:b + 1].to(cd), kb, vb, softmax_scale=softmax_scale,
            causal=bool(causal and T_new > 1), window_size=(wl, wr),
            softcap=softcap, alibi_slopes=slopes_b, upcast=upcast,
            return_lse=True)
        outs.append(o_b[0].to(q.dtype))
        lses.append(lse_b[0])
    out = torch.stack(outs)
    kc, vc = kc.to(k_cache.dtype), vc.to(v_cache.dtype)
    if return_lse:
        return out, kc, vc, torch.stack(lses)
    return out, kc, vc
