"""Port ServingEngine vs the JAX package's through preemption and the
prefix cache with chunked prefill (tiny fp32 config, page_size 8).  Greedy
tokens and the engine counters must be identical."""

import torch

import torch_engine_scenarios as sc

torch.set_num_threads(1)


def test_engine_preemption_matches_jax():
    """6 pages of 8 tokens for three ~20-token requests: the youngest is
    preempted and re-prefilled (prompt + emitted tokens)."""
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8], [1, 1, 2, 3, 5, 8]]

    def script(eng):
        return {i: eng.submit(p, max_new_tokens=10)
                for i, p in enumerate(prompts)}
    # unfused in both: a fused window moves the step at which the pool
    # runs dry, so the re-prefill counters would differ (tokens would not)
    j, t = sc.both(script, jax_kw=dict(decode_fuse=1),
                   torch_kw=dict(decode_fuse=1), max_batch=3, num_pages=6,
                   page_size=8)
    sc.assert_same(j, t)
    assert t[2] >= 1, "the scenario must preempt"


def test_engine_prefix_cache_chunked_prefill_matches_jax():
    """A second request copies the first one's 4 committed prompt pages and
    chunk-prefills only its suffix (prefill_chunk 8)."""
    prompt = sc.prng_prompt(33, 11)

    def script(eng):
        r1 = eng.submit(prompt, max_new_tokens=6)
        for _ in range(5):
            eng.step()                 # r1: 5 chunk steps, now decoding
        return {"r1": r1, "r2": eng.submit(prompt, max_new_tokens=4)}
    j, t = sc.both(script, jax_kw=dict(decode_fuse=1), max_batch=4,
                   num_pages=32, page_size=8, prefill_chunk=8)
    sc.assert_same(j, t)
    assert t[1]["prefix_hits"] == 1 and t[1]["prefix_tokens_reused"] == 32
    assert t[0]["r2"] == t[0]["r1"][:4]
