"""ctypes loader for the native runtime core (`csrc/fa_runtime.cpp` at the
repository root: paged allocator + continuous-batching scheduler).

Built with g++ on first use into the port's own git-ignored build directory
(`flash_attn_v100_tpu_torch/build/`), and loaded with the C ABI below.  If no
toolchain is available the callers fall back to the pure-Python versions in
allocator.py / scheduler.py — same semantics, slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "fa_runtime.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "build"
_CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    sigs = {
        "fa_alloc_create": ([ctypes.c_int32, ctypes.c_int32], ctypes.c_void_p),
        "fa_alloc_can_extend": ([ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int32], ctypes.c_int32),
        "fa_alloc_destroy": ([ctypes.c_void_p], None),
        "fa_alloc_num_free": ([ctypes.c_void_p], ctypes.c_int32),
        "fa_alloc_extend": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                             i32p], ctypes.c_int32),
        "fa_alloc_pages_of": ([ctypes.c_void_p, ctypes.c_int64, i32p,
                               ctypes.c_int32], ctypes.c_int32),
        "fa_alloc_release": ([ctypes.c_void_p, ctypes.c_int64], None),
        "fa_sched_create": ([ctypes.c_int32, ctypes.c_int32, ctypes.c_int32],
                            ctypes.c_void_p),
        "fa_sched_destroy": ([ctypes.c_void_p], None),
        "fa_sched_add": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                          ctypes.c_int32], ctypes.c_int32),
        "fa_sched_step": ([ctypes.c_void_p, i64p, i8p, ctypes.c_int32],
                          ctypes.c_int32),
        "fa_sched_advance": ([ctypes.c_void_p, ctypes.c_int64], ctypes.c_int32),
        "fa_sched_finish": ([ctypes.c_void_p, ctypes.c_int64], ctypes.c_int32),
        "fa_sched_pages_of": ([ctypes.c_void_p, ctypes.c_int64, i32p,
                               ctypes.c_int32], ctypes.c_int32),
        "fa_sched_num_free_pages": ([ctypes.c_void_p], ctypes.c_int32),
        "fa_sched_num_waiting": ([ctypes.c_void_p], ctypes.c_int32),
        "fa_sched_num_running": ([ctypes.c_void_p], ctypes.c_int32),
        "fa_sched_num_preemptions": ([ctypes.c_void_p], ctypes.c_int64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _so_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_CXXFLAGS).encode())
    return _BUILD / f"libfa_runtime-{h.hexdigest()[:16]}.so"


def load() -> Optional[ctypes.CDLL]:
    """The native library, built if needed; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = _so_path()
        if not so.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *_CXXFLAGS, "-o", str(tmp), str(_SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        _lib = _declare(ctypes.CDLL(str(so)))
    except (OSError, subprocess.SubprocessError, AttributeError):
        _lib = None
    return _lib


def available() -> bool:
    return load() is not None
