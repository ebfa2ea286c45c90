"""Build and load the package's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface, at first use, into
`flash_attn_v100_tpu_torch/build/` (git-ignored).  The libraries are loaded
with ctypes; pointers and the stream are passed as `c_void_p`.  A library's
file name carries a hash of its sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

`build_all()` starts one `nvcc` for every source at once and waits for all
of them; `chip_smoke.py` calls it so that the build is timed on its own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

PKG_ROOT = Path(__file__).resolve().parents[2]
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "build"

# kernel name -> source file in csrc/
SOURCES = {"decode": "decode.cu", "varlen_paged": "varlen_paged.cu",
           "fwd": "fwd.cu", "bwd": "bwd.cu",
           "decode_quant": "decode_quant.cu",
           "varlen_paged_quant": "varlen_paged_quant.cu",
           "probes": "probes.cu", "probe_int4": "probe_int4.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint

# mask (causal, window_left, window_right, softcap, has_alibi), then dropout
# (enabled, seed_lo, seed_hi, threshold, scale, q0, k0, b0, h0, num_heads)
_MASK_DROPOUT = [_I, _I, _I, _F, _I] + [_I, _U, _U, _U, _F] + [_I] * 5

# C signatures of the entry points of each library
SIGNATURES = {
    # partials, then the merged outputs and their arrival counters
    "decode": {
        "fa_decode_launch": ([_I] + [_P] * 13 + [_LL] * 4 + [_I] * 11
                             + [_F, _I, _I, _I, _F, _I, _P], _I),
        # (dtype, D, rows, int out[5]): occupancy of K4
        "fa_decode_occupancy": ([_I, _I, _I, _P], _I),
    },
    "varlen_paged": {
        "fa_varlen_paged_launch": ([_I, _P, _P, _P, _P, _I] + [_P] * 6
                                   + [_P] + [_LL] * 3 + [_I] * 8
                                   + [_F, _I, _I, _I, _F, _I, _P], _I),
        # (dtype, D, extra, int out[5]): occupancy of K8
        "fa_varlen_paged_occupancy": ([_I, _I, _I, _P], _I),
    },
    "fwd": {
        "fa_fwd_launch": ([_I] + [_P] * 6 + [_I] * 7 + [_F] + _MASK_DROPOUT
                          + [_P], _I),
        "fa_varlen_fwd_launch": ([_I] + [_P] * 10 + [_I] * 6 + [_F]
                                 + _MASK_DROPOUT + [_P], _I),
        # (dtype, D, extra, int out[5]): occupancy of K1
        "fa_fwd_occupancy": ([_I, _I, _I, _P], _I),
    },
    "bwd": {
        **{name: ([_I] + [_P] * 10 + [_I] * 7 + [_F] + _MASK_DROPOUT + [_P],
                  _I)
           for name in ("fa_dq_launch", "fa_dkv_launch")},
        # K6 / K7, the varlen instantiation: no dropout position bases
        **{name: ([_I] + [_P] * 14 + [_I] * 7 + [_F] + _MASK_DROPOUT[:10]
                  + [_P], _I)
           for name in ("fa_varlen_dq_launch", "fa_varlen_dkv_launch")},
        # (dkv, dtype, D, extra, int out[5]): occupancy of K2 / K3 (K6 / K7)
        **{name: ([_I, _I, _I, _I, _P], _I)
           for name in ("fa_bwd_occupancy", "fa_varlen_bwd_occupancy")},
    },
    # (kind, dtype) first; payload then scale strides
    "decode_quant": {
        "fa_decode_quant_launch": ([_I, _I] + [_P] * 15 + [_LL] * 8
                                   + [_I] * 11
                                   + [_F, _I, _I, _I, _F, _I, _P], _I),
        # (kind, dtype, D, rows, int out[5]): occupancy of K4q
        "fa_decode_quant_occupancy": ([_I, _I, _I, _I, _P], _I),
    },
    "varlen_paged_quant": {
        "fa_varlen_paged_quant_launch": (
            [_I, _I] + [_P] * 6 + [_I] + [_P] * 7 + [_LL] * 6 + [_I] * 8
            + [_F, _F] + [_I] * 4 + [_F, _I, _P], _I),
        # (kind, dtype, D, extra, int out[5]): occupancy of K8q
        "fa_varlen_paged_quant_occupancy": ([_I, _I, _I, _I, _P], _I),
    },
    # P1-P3: (flags, q, k, v, out, lse, strides[14], B, Hq, Hk, M, N,
    # key tiles, trip, pairs, n_pairs, 3 q-side, 3 k-side, qseg, kseg,
    # scale, stream)
    "probes": {
        "fa_probe_launch": ([_I] + [_P] * 6 + [_I] * 6 + [_P] * 2 + [_I]
                            + [_P] * 8 + [_F, _P], _I),
        # (flags, int out[4]): registers, local bytes, shared bytes, blocks
        "fa_probe_occupancy": ([_I, _P], _I),
    },
    # P4: (kind, a, b, c, M, N, K, stream)
    "probe_int4": {
        "fa_int4_mma_launch": ([_I, _P, _P, _P, _I, _I, _I, _P], _I),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the GPU")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where library `name` of the current sources is (or will be) built."""
    return _lib_path(name)


def _start(name: str):
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path, timeout: float) -> str:
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out building {name}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}:\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all(names: Optional[List[str]] = None,
              timeout: float = 600.0) -> Dict[str, float]:
    """Compile every kernel that is not built yet, all `nvcc`s at once.
    Returns {name: seconds} for the ones compiled here."""
    names = list(SOURCES) if names is None else names
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names if not _lib_path(n).exists()}
    secs = {}
    for n, (proc, tmp, out) in started.items():
        _finish(n, proc, tmp, out, timeout)
        secs[n] = time.perf_counter() - t0
    return secs


def build_log(name: str) -> str:
    """nvcc's output (with -Xptxas -v: registers, shared memory, spills)."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def counted(fn):
    """`fn` with a `.calls` count of its calls (the plain twins' counters:
    a main path that runs the kernels leaves them at 0)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        wrapper.calls += 1
        return fn(*args, **kwargs)
    wrapper.calls = 0
    return wrapper
