"""Port ServingEngine vs the JAX package's with fused decode and staggered
admission (tiny fp32 config, page_size 8): identical greedy tokens."""

import torch

import torch_engine_scenarios as sc

torch.set_num_threads(1)


def test_engine_decode_fuse_and_staggered_admission_match_jax():
    """decode_fuse 8 (back-to-back decode steps, no host read between them)
    and max_prefill_seqs 1 give the tokens of the unfused JAX engine."""
    def script(eng):
        rids = sc.three_prompts(eng, n_new=11)
        rids[3] = eng.submit([4, 4], max_new_tokens=9)
        return rids
    j, t = sc.both(script, jax_kw=dict(decode_fuse=1),
                   torch_kw=dict(decode_fuse=8), max_batch=4, num_pages=32,
                   page_size=8, max_prefill_seqs=1)
    sc.assert_same(j, t)
