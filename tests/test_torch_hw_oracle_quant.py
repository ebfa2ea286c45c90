"""The port's quantized paged case of its varlen sweep
(flash_attn_v100_tpu_torch/benchmarks/sweep_varlen.py::run_paged_quant_case:
K8q over int8, fp8 and int4 pools against the fp32 oracle over the
dequantized pool, the JAX package's 0.1 / 0.3 gates) on the CPU at a tiny
size, where flash_attn_with_kvcache takes the plain versions: each payload
passes, and an output scaled by 1.5 fails every gate."""

import numpy as np
import pytest
import torch

from flash_attn_v100_tpu_torch.benchmarks import sweep_varlen

torch.set_num_threads(1)

TINY = dict(device="cpu", Hq=4, Hk=2, D=32, ps=128, T=16,
            lens_k=(37, 150))


@pytest.mark.parametrize("kind", list(sweep_varlen.QUANT_GATES))
def test_quant_paged_case_passes(kind):
    rng = np.random.default_rng(sweep_varlen.SEED)
    assert sweep_varlen.run_paged_quant_case(rng, kind, **TINY)


@pytest.mark.parametrize("kind", list(sweep_varlen.QUANT_GATES))
def test_quant_paged_case_catches_a_scaled_output(kind, monkeypatch):
    real = sweep_varlen.flash_attn_with_kvcache
    monkeypatch.setattr(sweep_varlen, "flash_attn_with_kvcache",
                        lambda *a, **k: real(*a, **k) * 1.5)
    rng = np.random.default_rng(sweep_varlen.SEED)
    assert not sweep_varlen.run_paged_quant_case(rng, kind, **TINY)
