"""The port's flash_attn_varlen_func against the JAX package's with packed
rows and keys that belong to no sequence (O = 0, LSE = -inf, zero
gradients), the dropout mask of `return_attn_probs` on such rows (keyed as
segment -1, position 0) against the JAX package's construction of it, and
the port's mha_reference_varlen (the third oracle) against JAX's.
Tolerances of tests/torch_varlen_cases.py: out and LSE 1e-5, gradients
1e-4, fp32, dmask bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_varlen_cases as vc
from flash_attn_v100_tpu.ops import philox as jax_philox
from flash_attn_v100_tpu.ops.pallas.varlen import build_ragged_info
from flash_attn_v100_tpu.ops.reference import \
    mha_reference_varlen as jax_reference_varlen
from flash_attn_v100_tpu_torch.ops.flash_attention import normalize_seed
from flash_attn_v100_tpu_torch.ops.reference import mha_reference_varlen
from flash_attn_v100_tpu_torch.ops.varlen import varlen_dropout_mask

torch.set_num_threads(1)


def test_varlen_uncovered_rows_and_keys_match_jax():
    """7 packed q rows and 5 keys past the last sequence."""
    out, lse, dq, dk, dv = vc.check_varlen(
        [40, 24], [40, 24], dict(causal=True), extra_q=7, extra_k=5)
    assert not out[64:].any() and torch.isneginf(lse[:, 64:]).all()
    assert not dq[64:].any() and not dk[64:].any() and not dv[64:].any()


def test_varlen_dropout_mask_matches_jax_on_uncovered_rows():
    """Sequences [5, 0, 30] and 6 rows past them; the mask as JAX's
    flash_attn_varlen_func builds it (ops/varlen.py:352-366 there)."""
    cu = np.asarray([0, 5, 5, 35], np.int32)
    Tq, hq, msk, p = 41, 3, 50, 0.3
    seed = normalize_seed(p, 99)
    q_seg, q_pos, *_ = build_ragged_info(jnp.asarray(cu), jnp.asarray(cu),
                                         Tq, Tq, Tq, Tq)
    bh = q_seg[:, None, None] * hq + jnp.arange(hq)[None, :, None]
    keep_j = jax_philox.dropout_keep_mask(
        q_pos[:, None, None], jnp.arange(msk)[None, None, :], bh,
        jnp.uint32(int(seed[0])), jnp.uint32(int(seed[1])), p)
    keep_t = varlen_dropout_mask(torch.from_numpy(cu), Tq, hq, msk, p, seed)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))


# ---------------------------------------------------------- the oracle

@pytest.mark.parametrize("kw", [
    dict(causal=True, softcap=20.0, window_size=(40, 0)),
    dict(causal=True, dropout_p=0.3, dropout_seed=7,
         alibi_slopes=np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32),
         seqused_k=np.asarray([100, 0], np.int32)),
], ids=["softcap_window", "dropout_alibi_seqused"])
def test_mha_reference_varlen_matches_jax(kw):
    q, k, v, _, cu_q, cu_k, _, _ = vc.packed([48, 80], [120, 96])
    out_j, lse_j = jax_reference_varlen(
        *(jnp.asarray(x) for x in (q, k, v, cu_q, cu_k)), return_lse=True,
        **vc._jax_kw(kw))
    out_t, lse_t = mha_reference_varlen(
        *(torch.from_numpy(x) for x in (q, k, v, cu_q, cu_k)),
        return_lse=True, **vc._torch_kw(kw))
    vc.close(out_t, out_j, vc.OUT_ATOL, "out")
    vc.close_lse(lse_t, lse_j)
