"""Port ServingEngine vs the JAX package's with the prefill on the paged
varlen route (K8): page_size 128 and VARLEN_PREFILL_MIN_ROWS lowered in
both packages, tiny fp32 config.  Greedy tokens must be identical."""

import torch

from flash_attn_v100_tpu.ops import kvcache as jkv
from flash_attn_v100_tpu_torch.ops import kvcache as tkv
from flash_attn_v100_tpu_torch.runtime import engine as tengine

import torch_engine_scenarios as sc

torch.set_num_threads(1)


def test_engine_varlen_prefill_route_matches_jax(monkeypatch):
    # tiny config: group 2, so a prefill bucket of T >= 8 has >= 16 rows
    monkeypatch.setattr(jkv, "VARLEN_PREFILL_MIN_ROWS", 16)
    monkeypatch.setattr(tkv, "VARLEN_PREFILL_MIN_ROWS", 16)
    before = dict(tengine.paged_forward.calls)
    j, t = sc.both(sc.three_prompts, cfg_kw=dict(max_seq_len=256),
                   jax_kw=dict(decode_fuse=1), torch_kw=dict(decode_fuse=1),
                   max_batch=4, num_pages=8, page_size=128)
    assert (sc.assert_same(j, t) == 6).all()
    calls = {k: tengine.paged_forward.calls[k] - before[k] for k in before}
    assert calls["varlen"] >= 1 and calls["decode"] >= 5, calls
