"""prof_ttft_tail's chunked-prefill set against the JAX engine's
scheduler decisions (tests/torch_ttft_jax.py; the staggered set and the
script's own run are in test_torch_measure_ttft.py)."""

import torch
import torch_ttft_jax as tj

from flash_attn_v100_tpu_torch.benchmarks import prof_ttft_tail as tt

torch.set_num_threads(1)


def test_scheduler_decisions_match_jax_chunked():
    tj.check_set(tt, "chunk1024")
