"""Port flash_attn_with_kvcache with `q_position_lens` / `append_window`
against the JAX package's, int8 and fp8 (e4m3) pools (tests/torch_kvcache_sharded_cases.py: the
call one rank of the sequence-sharded decode makes, rows inside,
straddling and outside the shard's window, a row with lens_total 0)."""

import pytest
import torch

import torch_kvcache_sharded_cases as cases

torch.set_num_threads(1)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
@pytest.mark.parametrize("scenario", cases.QUANT_SCENARIOS)
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_kvcache_shard_call_matches_jax_quant(kind, scenario, paged,
                                           monkeypatch):
    cases.run_case(scenario, kind, paged, monkeypatch)
