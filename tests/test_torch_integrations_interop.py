"""The port's integrations/torch_interop.py against the JAX package's on the
same CPU tensors: the five names, each on the port's own entry points
(K1-K3, K5, K4 on the card; their plain versions on CPU tensors), the JAX
side through dlpack into its Pallas kernels in interpret mode.

Tolerances (fp32): outputs 1e-5, gradients 1e-4; the appended caches
bit-equal."""

import numpy as np
import torch

from flash_attn_v100_tpu.integrations import torch_interop as jti
from flash_attn_v100_tpu_torch.integrations import torch_interop as tti

torch.set_num_threads(1)

B, M, Hq, Hk, D = 2, 48, 4, 2, 32


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _close(a, b, atol):
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               rtol=0, atol=atol)


def test_flash_attn_func_torch():
    rng = np.random.default_rng(11)
    q, k, v = _t(rng, B, M, Hq, D), _t(rng, B, M, Hk, D), _t(rng, B, M, Hk, D)
    kw = dict(causal=True, window_size=(16, 0))
    _close(tti.flash_attn_func_torch(q, k, v, **kw),
           jti.flash_attn_func_torch(q, k, v, **kw), 1e-5)


def test_flash_attn_varlen_func_torch():
    rng = np.random.default_rng(12)
    lens = [30, 7, 40]
    cu = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32)
    tot = sum(lens)
    q, k, v = _t(rng, tot, Hq, D), _t(rng, tot, Hk, D), _t(rng, tot, Hk, D)
    args = (q, k, v, cu, cu, max(lens), max(lens))
    _close(tti.flash_attn_varlen_func_torch(*args, causal=True),
           jti.flash_attn_varlen_func_torch(*args, causal=True), 1e-5)


def test_flash_attn_with_kvcache_torch():
    """A decode step appending one token to non-contiguous (transposed)
    caches: the port appends in place, JAX returns new caches."""
    rng = np.random.default_rng(13)
    N = 64
    q, k1, v1 = _t(rng, B, 1, Hq, D), _t(rng, B, 1, Hk, D), _t(rng, B, 1, Hk, D)
    kc = _t(rng, B, Hk, N, D).transpose(1, 2)
    vc = _t(rng, B, Hk, N, D).transpose(1, 2)
    cs = torch.tensor([40, 17], dtype=torch.int32)
    out_j, (kc_j, vc_j) = jti.flash_attn_with_kvcache_torch(
        q, kc, vc, k=k1, v=v1, cache_seqlens=cs, causal=True)
    out_t, (kc_t, vc_t) = tti.flash_attn_with_kvcache_torch(
        q, kc, vc, k=k1, v=v1, cache_seqlens=cs, causal=True)
    assert kc_t is kc and vc_t is vc
    _close(out_t, out_j, 1e-5)
    assert torch.equal(kc, kc_j) and torch.equal(vc, vc_j)


def test_flash_attn_backward_torch():
    rng = np.random.default_rng(14)
    q, k, v = _t(rng, B, M, Hq, D), _t(rng, B, M, Hk, D), _t(rng, B, M, Hk, D)
    dout = _t(rng, B, M, Hq, D)
    got = tti.flash_attn_backward_torch(q, k, v, dout, causal=True)
    want = jti.flash_attn_backward_torch(q, k, v, dout, causal=True)
    for name, a, b, atol in zip(("out", "dq", "dk", "dv"), got, want,
                                (1e-5, 1e-4, 1e-4, 1e-4)):
        assert a.shape == b.shape, name
        _close(a, b, atol)


def test_make_torch_autograd_fn():
    rng = np.random.default_rng(15)
    q0, k0, v0 = (_t(rng, B, M, Hq, D), _t(rng, B, M, Hk, D),
                  _t(rng, B, M, Hk, D))
    grads = []
    for mod in (tti, jti):
        fa = mod.make_torch_autograd_fn(causal=True)
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
        out = fa(q, k, v)
        out.square().sum().backward()
        grads.append((out, q.grad, k.grad, v.grad))
    _close(grads[0][0], grads[1][0], 1e-5)
    for a, b in zip(grads[0][1:], grads[1][1:]):
        _close(a, b, 1e-4)
