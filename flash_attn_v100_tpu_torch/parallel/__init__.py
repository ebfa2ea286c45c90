"""Parallelism on torch.distributed: (data, seq, model) meshes of ranks,
head-sharded dense attention, sequence-sharded KV-cache attention with the
cross-rank LSE merge, and the multi-process entry points.  Ring and
Ulysses sequence parallelism for training come with the next port slice."""

from flash_attn_v100_tpu_torch.parallel.distributed import (
    initialize, make_hybrid_mesh)
from flash_attn_v100_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, attention_specs, local_shard,
    make_mesh)
from flash_attn_v100_tpu_torch.parallel.sharded import (
    flash_attn_func_sharded, flash_attn_with_kvcache_sharded,
    merge_lse_across)

__all__ = [
    "make_mesh", "attention_specs", "DATA_AXIS", "SEQ_AXIS", "MODEL_AXIS",
    "Mesh", "local_shard",
    "flash_attn_func_sharded", "flash_attn_with_kvcache_sharded",
    "merge_lse_across", "initialize", "make_hybrid_mesh",
]
