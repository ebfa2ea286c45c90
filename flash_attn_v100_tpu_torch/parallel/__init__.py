"""Parallelism on torch.distributed: (data, seq, model) meshes of ranks
and their collectives, head-sharded dense attention, sequence-sharded
KV-cache attention with the cross-rank LSE merge, ring attention
(contiguous and zigzag layouts, streaming backward) and Ulysses sequence
parallelism, and the multi-process entry points."""

from flash_attn_v100_tpu_torch.parallel.distributed import (
    initialize, make_hybrid_mesh)
from flash_attn_v100_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, all_to_all, attention_specs,
    copy_to_model, local_shard, make_mesh, reduce_from_model, ring_shift)
from flash_attn_v100_tpu_torch.parallel.ring import (
    ring_attention, ring_attention_local, ulysses_attention, zigzag_order,
    zigzag_shard, zigzag_unshard)
from flash_attn_v100_tpu_torch.parallel.sharded import (
    flash_attn_func_sharded, flash_attn_with_kvcache_sharded,
    merge_lse_across)

__all__ = [
    "make_mesh", "attention_specs", "DATA_AXIS", "SEQ_AXIS", "MODEL_AXIS",
    "Mesh", "local_shard",
    "flash_attn_func_sharded", "flash_attn_with_kvcache_sharded",
    "merge_lse_across", "initialize", "make_hybrid_mesh",
    "ring_attention", "ring_attention_local", "ulysses_attention",
    "zigzag_order", "zigzag_shard", "zigzag_unshard",
    "ring_shift", "all_to_all", "copy_to_model", "reduce_from_model",
]
