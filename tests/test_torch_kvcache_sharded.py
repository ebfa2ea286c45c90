"""Port flash_attn_with_kvcache with `q_position_lens` / `append_window`
against the JAX package's, fp32 pools (tests/torch_kvcache_sharded_cases.py: the
call one rank of the sequence-sharded decode makes, rows inside,
straddling and outside the shard's window, a row with lens_total 0)."""

import pytest
import torch

import torch_kvcache_sharded_cases as cases

from flash_attn_v100_tpu_torch.ops import kvcache as tkv

torch.set_num_threads(1)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
@pytest.mark.parametrize("scenario", list(cases.SCENARIOS))
def test_kvcache_shard_call_matches_jax_fp32(scenario, paged, monkeypatch):
    cases.run_case(scenario, None, paged, monkeypatch)


def test_varlen_route_off_in_the_sharded_form():
    assert tkv.uses_varlen_route(True, 8, 128, 128)
    assert not tkv.uses_varlen_route(True, 8, 128, 128,
                                     q_position_lens=torch.zeros(1))
    assert not tkv.uses_varlen_route(True, 8, 128, 128, append_window=(0, 8))
