"""flash-attn dist-info masquerade.

The reference fabricates a `flash_attn-2.8.3.dist-info` at install so
`importlib.metadata`-based ecosystem probes (HF `is_flash_attn_2_available`,
unsloth) detect a flash-attn 2.8.3 installation.  Same contract here:
`write_dist_info(target_dir)` emits the minimal METADATA + top_level.txt,
byte for byte the JAX package's.

The JAX package holds the `flash_attn` import name by its place at the
repository root; `install_canonical_name()` gives it to the port instead,
in one process: it registers the port's `flash_attn` package (its
`__init__`, `flash_attn_interface` and `bert_padding`) in `sys.modules`
under the canonical names.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import Optional

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


CANONICAL = "flash_attn"
_SUBMODULES = ("flash_attn_interface", "bert_padding")
_SHIM_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "flash_attn")


def _is_port_shim(module) -> bool:
    spec = getattr(module, "__spec__", None)
    return (spec is not None and spec.origin is not None
            and os.path.dirname(os.path.abspath(spec.origin)) == _SHIM_DIR)


def install_canonical_name(dist_info_dir: Optional[str] = None):
    """Register the port's `flash_attn` package as `flash_attn`,
    `flash_attn.flash_attn_interface` and `flash_attn.bert_padding` in
    `sys.modules`, each loaded from its file under that name (so
    `importlib.util.find_spec("flash_attn")` resolves), and return the
    `flash_attn` module.  Given `dist_info_dir`, also write the dist-info
    there and put the directory first on `sys.path`, so that
    `importlib.metadata.version("flash_attn")` is "2.8.3".

    Raises if another `flash_attn` (the JAX package's root shim, or any
    other) is already imported; a second call after the first returns the
    installed module."""
    have = sys.modules.get(CANONICAL)
    if have is not None and not _is_port_shim(have):
        raise RuntimeError(
            f"another {CANONICAL!r} is already imported "
            f"({getattr(have, '__file__', have)!r}); install the port's "
            f"name before anything imports {CANONICAL!r}")
    if dist_info_dir is not None:
        write_dist_info(dist_info_dir)
        if dist_info_dir not in sys.path:
            sys.path.insert(0, dist_info_dir)
    if have is not None:
        return have
    spec = importlib.util.spec_from_file_location(
        CANONICAL, os.path.join(_SHIM_DIR, "__init__.py"),
        submodule_search_locations=[_SHIM_DIR])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[CANONICAL] = pkg
    try:
        spec.loader.exec_module(pkg)
        for name in _SUBMODULES:
            full = f"{CANONICAL}.{name}"
            sub_spec = importlib.util.spec_from_file_location(
                full, os.path.join(_SHIM_DIR, f"{name}.py"))
            sub = importlib.util.module_from_spec(sub_spec)
            sys.modules[full] = sub
            sub_spec.loader.exec_module(sub)
            setattr(pkg, name, sub)
    except BaseException:
        for name in (CANONICAL, *(f"{CANONICAL}.{n}" for n in _SUBMODULES)):
            sys.modules.pop(name, None)
        raise
    return pkg
