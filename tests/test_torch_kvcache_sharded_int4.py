"""Port flash_attn_with_kvcache with `q_position_lens` / `append_window`
against the JAX package's, int4-packed pools (tests/torch_kvcache_sharded_cases.py: the
call one rank of the sequence-sharded decode makes, rows inside,
straddling and outside the shard's window, a row with lens_total 0)."""

import pytest
import torch

import torch_kvcache_sharded_cases as cases

torch.set_num_threads(1)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
@pytest.mark.parametrize("scenario", cases.QUANT_SCENARIOS)
@pytest.mark.parametrize("kind", ["int4"])
def test_kvcache_shard_call_matches_jax_int4(kind, scenario, paged,
                                           monkeypatch):
    cases.run_case(scenario, kind, paged, monkeypatch)
