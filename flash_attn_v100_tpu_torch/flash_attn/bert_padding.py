"""`flash_attn.bert_padding`: the padded <-> packed helpers of
ops/padding.py under their canonical import path."""

from flash_attn_v100_tpu_torch.ops.padding import (
    index_first_axis,
    index_first_axis_residual,
    index_put_first_axis,
    pad_input,
    unpad_input,
    unpad_input_for_concatenated_sequences,
)

__all__ = [
    "index_first_axis", "index_first_axis_residual", "index_put_first_axis",
    "pad_input", "unpad_input", "unpad_input_for_concatenated_sequences",
]
