"""Port flash_attn_with_kvcache over quantized paged caches (int8, fp8 e4m3,
int4) against the JAX package's, NHD and HND layouts, without an append
and with a 2-token append at an even and at an odd offset; the checks and
tolerances are tests/torch_kvcache_quant_cases.py's."""

import pytest

import torch_kvcache_quant_cases as qc


@pytest.mark.parametrize("append", [False, True])
@pytest.mark.parametrize("layout", ["NHD", "HND"])
@pytest.mark.parametrize("kind", list(qc.KINDS))
def test_kvcache_quant_paged_matches_jax(kind, layout, append, monkeypatch):
    qc.run_case(kind, "paged", layout, append, monkeypatch)
