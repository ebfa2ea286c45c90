"""Build and load the package's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface (two libraries have further translation
units, `PARTS`, compiled by nvccs of their own and linked in), at first
use, into
`flash_attn_v100_tpu_torch/build/` (git-ignored).  The libraries are loaded
with ctypes; pointers and the stream are passed as `c_void_p`.  A library's
file name carries a hash of its sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

`build_all()` starts one `nvcc` for every source at once and waits for all
of them; `chip_smoke.py` calls it so that the build is timed on its own.

Variant libraries (`VARIANTS`): a source built again with `-D` macros, into
a library whose file name carries the variant's name and whose hash covers
its flags, for the tile and unroll sweeps (benchmarks/prof_*).  The
shipped libraries are built with no `-D`; only `benchmarks/`,
`chip_smoke.py` and the tests ask for a variant (`load(name, variant)`),
no kernel wrapper does.
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
from typing import Dict, List, Optional, Tuple

PKG_ROOT = Path(__file__).resolve().parents[2]
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "build"

# kernel name -> source file in csrc/
SOURCES = {"decode": "decode.cu", "varlen_paged": "varlen_paged.cu",
           "fwd": "fwd.cu", "bwd": "bwd.cu",
           "decode_quant": "decode_quant.cu",
           "varlen_paged_quant": "varlen_paged_quant.cu",
           "probes": "probes.cu", "probe_int4": "probe_int4.cu",
           # the fp32 bodies: K1, K5, K8; K2/K3, K6/K7; K4 (the decode
           # body's fp32 instantiation)
           "fwd_f32": "fwd_f32.cu", "bwd_f32": "bwd_f32.cu",
           "decode_f32": "decode_f32.cu"}
# further translation units of a library, each compiled by an nvcc of its
# own beside the library's source and linked with it: the quantized
# kernels' q types (fp16, fp32), which would otherwise make those two
# libraries the build's longest by far
PARTS = {"decode_quant": ("decode_quant_f16.cu", "decode_quant_f32.cu"),
         "varlen_paged_quant": ("varlen_paged_quant_f16.cu",
                                "varlen_paged_quant_f32.cu")}
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
    # (..., Hq, Hk, D, D_in, ...): D_in the rows' columns (D, or below D 32)
    "fwd": {
        "fa_fwd_launch": ([_I] + [_P] * 6 + [_I] * 8 + [_F] + _MASK_DROPOUT
                          + [_P], _I),
        "fa_varlen_fwd_launch": ([_I] + [_P] * 10 + [_I] * 7 + [_F]
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
    # the fp32 bodies take the arguments of the 16-bit entries (dtype 2)
    "fwd_f32": {
        "fa_fwd_f32_launch": ([_I] + [_P] * 6 + [_I] * 8 + [_F]
                              + _MASK_DROPOUT + [_P], _I),
        "fa_varlen_fwd_f32_launch": ([_I] + [_P] * 10 + [_I] * 7 + [_F]
                                     + _MASK_DROPOUT + [_P], _I),
        "fa_varlen_paged_f32_launch": ([_I, _P, _P, _P, _P, _I] + [_P] * 6
                                       + [_P] + [_LL] * 3 + [_I] * 8
                                       + [_F, _I, _I, _I, _F, _I, _P], _I),
    },
    "bwd_f32": {
        **{name: ([_I] + [_P] * 10 + [_I] * 7 + [_F] + _MASK_DROPOUT + [_P],
                  _I)
           for name in ("fa_dq_f32_launch", "fa_dkv_f32_launch")},
        **{name: ([_I] + [_P] * 14 + [_I] * 7 + [_F] + _MASK_DROPOUT[:10]
                  + [_P], _I)
           for name in ("fa_varlen_dq_f32_launch",
                        "fa_varlen_dkv_f32_launch")},
    },
    "decode_f32": {
        "fa_decode_f32_launch": ([_I] + [_P] * 13 + [_LL] * 4 + [_I] * 11
                                 + [_F, _I, _I, _I, _F, _I, _P], _I),
        # (dtype 2, D, rows, int out[5]): occupancy of K4 fp32
        "fa_decode_f32_occupancy": ([_I, _I, _I, _P], _I),
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

# library -> variant -> ({macro: value}, what the build is restricted to,
# the variant library's C entry points).  FA_SWEEP=1 compiles a source's
# sweep entries in place of its shipped ones: the kernel variants of
# flash_attn_v100_tpu_torch/benchmarks/variants.py, bf16 at D 128 (K4's
# copies ablation at D 256).
_SWEEP = {"FA_SWEEP": 1}
VARIANTS: Dict[str, Dict[str, tuple]] = {
    "fwd": {"sweep": (
        _SWEEP, "K1 and K5 at bf16, D 128, no bias or dropout: 7 tiles and "
        "schedules", {
            "fa_fwd_sweep_launch": ([_I] + SIGNATURES["fwd"]["fa_fwd_launch"][0],
                                    _I),
            "fa_varlen_fwd_sweep_launch": (
                [_I] + SIGNATURES["fwd"]["fa_varlen_fwd_launch"][0], _I),
            # (id, varlen, int out[5])
            "fa_fwd_sweep_occupancy": ([_I, _I, _P], _I)})},
    "varlen_paged": {"sweep": (
        _SWEEP, "K8 at bf16, D 128, no bias, pages of a multiple of 128 "
        "rows: U 2 / 4 / 8", {
            "fa_varlen_paged_sweep_launch": (
                [_I] + SIGNATURES["varlen_paged"]["fa_varlen_paged_launch"][0],
                _I),
            "fa_varlen_paged_sweep_occupancy": ([_I, _P], _I)})},
    "bwd": {"sweep": (
        _SWEEP, "dense K2 / K3 at bf16, D 128, no bias or dropout: K2 at 64 "
        "keys a step, K3 at 64 q rows a step or 128 keys a block", {
            **{f"fa_{k}_sweep_launch": (
                [_I] + SIGNATURES["bwd"][f"fa_{k}_launch"][0], _I)
               for k in ("dq", "dkv")},
            # (dkv, id, int out[5])
            "fa_bwd_sweep_occupancy": ([_I, _I, _P], _I)})},
    "decode": {"sweep": (
        _SWEEP, "K4 at bf16, D 256, Rq <= 16: the ring alone, no products "
        "(timing only)", {
            "fa_decode_sweep_launch": (
                [_I] + SIGNATURES["decode"]["fa_decode_launch"][0], _I),
            "fa_decode_sweep_occupancy": ([_I, _P], _I)})},
    "decode_quant": {"sweep": (
        _SWEEP, "K4q over int4 pools at bf16 q, D 128, Rq <= 16: three "
        "ablations of the nibble chain (timing only)", {
            "fa_decode_quant_sweep_launch": (
                [_I] + SIGNATURES["decode_quant"]["fa_decode_quant_launch"][0],
                _I),
            "fa_decode_quant_sweep_occupancy": ([_I, _P], _I)})},
}

_libs: Dict[tuple, ctypes.CDLL] = {}


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


def _sources(name: str, variant: Optional[str] = None) -> List[Path]:
    """The library's translation units; a variant's is its main source."""
    parts = () if variant else PARTS.get(name, ())
    return [CSRC / f for f in (SOURCES[name], *parts)]


def _defines(name: str, variant: Optional[str]) -> List[str]:
    """A variant's -D flags (none for a shipped library)."""
    if variant is None:
        return []
    macros = VARIANTS[name][variant][0]
    return [f"-D{k}={v}" for k, v in sorted(macros.items())]


def _tag(name: str, variant: Optional[str]) -> str:
    return name if variant is None else f"{name}-{variant}"


def _lib_path(name: str, variant: Optional[str] = None) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + _sources(name, variant):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + _defines(name, variant)).encode())
    return BUILD_DIR / f"lib{_tag(name, variant)}-{h.hexdigest()[:16]}.so"


def library_path(name: str, variant: Optional[str] = None) -> Path:
    """Where library `name` (or its variant) of the current sources is (or
    will be) built."""
    return _lib_path(name, variant)


def _start(name: str, variant: Optional[str] = None):
    """nvcc for each of the library's translation units, all at once: one
    that writes the library, or (several units) one object file each."""
    out = _lib_path(name, variant)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    srcs = _sources(name, variant)
    objs = ([tmp.with_suffix(f".{i}.o") for i in range(len(srcs))]
            if len(srcs) > 1 else [])
    flags = ([f for f in NVCC_FLAGS if f != "-shared"] + ["-c"] if objs
             else NVCC_FLAGS) + _defines(name, variant)
    procs = [subprocess.Popen(
        [nvcc_path(), *flags, "-I", str(CSRC), "-o", str(dst), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for dst, src in zip(objs or [tmp], srcs)]
    return procs, objs, tmp, out


def _finish(tag: str, procs, objs: List[Path], tmp: Path, out: Path,
            timeout: float) -> str:
    logs = []
    try:
        for proc in procs:
            log, _ = proc.communicate(timeout=timeout)
            logs.append(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {tag}:\n{log}")
        if objs:   # the units' objects into the library
            link = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *map(str, objs)],
                capture_output=True, text=True, timeout=timeout)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc failed linking {tag}:\n{logs[-1]}")
        os.replace(tmp, out)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"nvcc timed out building {tag}") from None
    finally:
        for proc in procs:   # a unit still compiling after a failure
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    log = "".join(logs)
    (BUILD_DIR / f"{tag}.log").write_text(log)
    return log


def all_variants() -> List[Tuple[str, str]]:
    """(library, variant) of every variant library."""
    return [(n, v) for n, vs in VARIANTS.items() for v in vs]


def build_all(names: Optional[List[str]] = None,
              timeout: float = 600.0,
              variants: Optional[List[Tuple[str, str]]] = None
              ) -> Dict[str, float]:
    """Compile every library of `names` (default all shipped ones) and of
    `variants` ((library, variant) pairs; default none) that is not built
    yet, all `nvcc`s at once.  Returns {name or name-variant: seconds} for
    the ones compiled here."""
    names = list(SOURCES) if names is None else names
    jobs = [(n, None) for n in names] + list(variants or ())
    t0 = time.perf_counter()
    started = {(n, v): _start(n, v) for n, v in jobs
               if not _lib_path(n, v).exists()}
    secs = {}
    for (n, v), job in started.items():
        _finish(_tag(n, v), *job, timeout)
        secs[_tag(n, v)] = time.perf_counter() - t0
    return secs


def build_log(name: str, variant: Optional[str] = None) -> str:
    """nvcc's output (with -Xptxas -v: registers, shared memory, spills)."""
    p = BUILD_DIR / f"{_tag(name, variant)}.log"
    return p.read_text() if p.exists() else ""


def parse_sass(sass: str, names: Dict[str, str],
               ops: Optional[Dict[str, Tuple[str, ...]]] = None
               ) -> Dict[str, Dict[str, int]]:
    """{kernel: {"hgmma": n, "hmma": n, "mufu_ex2": n}} from `cuobjdump
    -sass` text: the warpgroup (HGMMA, wgmma) and warp (HMMA, mma.sync)
    tensor-core instructions and the exponentials on the special-function
    unit (MUFU.EX2) of each function, keyed by `names[mangled]` where the
    mangled name is there, else by the mangled name.  `ops` adds a count a
    key of the lines that hold every one of its strings (e.g. "tf32":
    ("HMMA.", ".TF32"))."""
    ops = ops or {}
    counts: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            cur = counts.setdefault(names.get(fn, fn),
                                    dict(hgmma=0, hmma=0, mufu_ex2=0,
                                         **{k: 0 for k in ops}))
            continue
        if cur is None:
            continue
        if "HGMMA." in line:
            cur["hgmma"] += 1
        elif "HMMA." in line:
            cur["hmma"] += 1
        elif "MUFU.EX2" in line:
            cur["mufu_ex2"] += 1
        for k, parts in ops.items():
            if all(p in line for p in parts):
                cur[k] += 1
    return counts


def _demangle(mangled: List[str]) -> Dict[str, str]:
    """{mangled: demangled} through `cu++filt` beside the build's nvcc."""
    if not mangled:
        return {}
    out = subprocess.run([str(Path(nvcc_path()).with_name("cu++filt"))]
                         + mangled, check=True, capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    assert len(out) == len(mangled), "cu++filt: one name a line"
    return dict(zip(mangled, out))


def sass_counts(name: str, ops: Optional[Dict[str, Tuple[str, ...]]] = None
                ) -> Dict[str, Dict[str, int]]:
    """`parse_sass` of library `name` (with `ops`), built first if needed,
    keyed by the demangled kernel names (`cuobjdump` beside the build's
    nvcc)."""
    load(name)
    sass = subprocess.run([str(Path(nvcc_path()).with_name("cuobjdump")),
                           "-sass", str(library_path(name))], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    mangled = sorted({ln.split("Function : ", 1)[1].strip()
                      for ln in sass.splitlines() if "Function : " in ln})
    return parse_sass(sass, _demangle(mangled), ops)


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """{mangled kernel: {"registers", "stack", "spill_stores",
    "spill_loads"}} from nvcc -Xptxas -v output."""
    res: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        for key in ("Compiling entry function '", "Function properties for "):
            if key in line:
                cur = res.setdefault(line.split(key, 1)[1].split("'")[0]
                                     .split()[0], {})
        if cur is None:
            continue
        if "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif "Used " in line and " registers" in line:
            cur["registers"] = int(line.split("Used ", 1)[1].split()[0])
    return res


def ptxas_usage(name: str) -> Dict[str, Dict[str, int]]:
    """`parse_ptxas` of library `name`'s build log (built first if needed),
    keyed by the demangled kernel names."""
    load(name)
    usage = parse_ptxas(build_log(name))
    names = _demangle(sorted(usage))
    return {names[m]: u for m, u in usage.items()}


def load(name: str, variant: Optional[str] = None) -> ctypes.CDLL:
    """The kernel library `name`, or its variant `variant` (VARIANTS), built
    first if needed."""
    lib = _libs.get((name, variant))
    if lib is not None:
        return lib
    path = _lib_path(name, variant)
    if not path.exists():
        if variant is None:
            build_all([name])
        else:
            build_all([], variants=[(name, variant)])
    lib = ctypes.CDLL(str(path))
    sigs = (SIGNATURES[name] if variant is None
            else VARIANTS[name][variant][2])
    for fn, (argtypes, restype) in sigs.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _libs[(name, variant)] = lib
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
