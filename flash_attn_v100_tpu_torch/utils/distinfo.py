"""flash-attn dist-info masquerade.

The reference fabricates a `flash_attn-2.8.3.dist-info` at install so
`importlib.metadata`-based ecosystem probes (HF `is_flash_attn_2_available`,
unsloth) detect a flash-attn 2.8.3 installation.  Same contract here:
`write_dist_info(target_dir)` emits the minimal METADATA + top_level.txt,
byte for byte the JAX package's.
"""

from __future__ import annotations

import os

FLASH_ATTN_VERSION = "2.8.3"

_METADATA = (
    "Metadata-Version: 2.4\n"
    "Name: flash-attn\n"
    f"Version: {FLASH_ATTN_VERSION}\n"
)


def write_dist_info(target_dir: str) -> str:
    """Create `flash_attn-2.8.3.dist-info` under `target_dir`; returns the
    dist-info path.  Idempotent."""
    dst = os.path.join(target_dir,
                       f"flash_attn-{FLASH_ATTN_VERSION}.dist-info")
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(dst, "METADATA"), "w") as f:
        f.write(_METADATA)
    with open(os.path.join(dst, "top_level.txt"), "w") as f:
        f.write("flash_attn\n")
    return dst
