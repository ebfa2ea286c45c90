"""The kernel libraries' registry in flash_attn_v100_tpu_torch/ops/cuda/
build.py against the CUDA sources and the wrappers, read as text (no nvcc,
no GPU): every registered source exists and every source is registered
(as a library's source or one of its further translation units),
every entry point in `SIGNATURES` is an `extern "C" int` function of its
library's source with as many parameters as its ctypes signature, every
such function is registered, and every entry point a wrapper module names
belongs to a library that module loads."""

import re
from pathlib import Path

import pytest
import torch

from flash_attn_v100_tpu_torch.ops.cuda import build

torch.set_num_threads(1)

CUDA_OPS = Path(build.__file__).resolve().parent
WRAPPERS = sorted(p for p in CUDA_OPS.glob("*.py")
                  if "build.load(" in p.read_text())
EXTERN = re.compile(r'extern "C" int (fa_\w+)\(([^)]*)\)')


def _macros(text: str) -> dict:
    """#define NAME body, with the body's line continuations joined."""
    joined = text.replace("\\\n", " ")
    return {m.group(1): m.group(2)
            for m in re.finditer(r"^#define (\w+)\s+(.*)$", joined, re.M)}


def _entries(lib: str) -> dict:
    """{name: number of parameters} of the library's extern "C" functions,
    macro parameter lists expanded."""
    text = (build.CSRC / build.SOURCES[lib]).read_text()
    macros = _macros(text)

    def count(params: str) -> int:
        pieces = [p.strip() for p in params.split(",") if p.strip()]
        return sum(count(macros[p]) if p in macros else 1 for p in pieces)

    return {name: count(params) for name, params in EXTERN.findall(text)}


def test_registry_found():
    assert len(build.SOURCES) >= 6 and set(build.SIGNATURES) == set(
        build.SOURCES)
    assert len(WRAPPERS) >= 4


@pytest.mark.parametrize("lib", sorted(build.SOURCES))
def test_registered_source_exists(lib):
    assert (build.CSRC / build.SOURCES[lib]).is_file(), build.SOURCES[lib]


@pytest.mark.parametrize("path", sorted(build.CSRC.glob("*.cu")),
                         ids=lambda p: p.name)
def test_every_source_is_registered(path):
    units = set(build.SOURCES.values()).union(*build.PARTS.values())
    assert path.name in units, \
        f"csrc/{path.name} is built by no entry of build.SOURCES / PARTS"


@pytest.mark.parametrize("lib", sorted(build.PARTS))
def test_parts_belong_to_a_library_and_define_no_entry(lib):
    """A library's further translation units exist, belong to one library
    and hold none of its C entry points (the library's source does)."""
    assert lib in build.SOURCES
    for part in build.PARTS[lib]:
        text = (build.CSRC / part).read_text()
        assert not EXTERN.findall(text), part
        assert sum(part in p for p in build.PARTS.values()) == 1


@pytest.mark.parametrize("lib", sorted(build.SOURCES))
def test_signatures_are_defined_in_their_source(lib):
    entries = _entries(lib)
    for name, (argtypes, _) in build.SIGNATURES[lib].items():
        assert name in entries, \
            f'{name} is no extern "C" int function of {build.SOURCES[lib]}'
        assert entries[name] == len(argtypes), (
            f"{name}: {entries[name]} C parameters, {len(argtypes)} ctypes "
            "argtypes")


@pytest.mark.parametrize("lib", sorted(build.SOURCES))
def test_entry_points_are_registered(lib):
    missing = set(_entries(lib)) - set(build.SIGNATURES[lib])
    assert not missing, f"{build.SOURCES[lib]}: {sorted(missing)} unregistered"


@pytest.mark.parametrize("path", WRAPPERS, ids=lambda p: p.name)
def test_wrappers_name_registered_entry_points(path):
    text = path.read_text()
    libs = set(re.findall(r'build\.load\("(\w+)"\)', text))
    assert libs and libs <= set(build.SOURCES), \
        f"{path.name} loads {sorted(libs - set(build.SOURCES))}"
    for lib, name in re.findall(r'build\.load\("(\w+)"\)\.(fa_\w+)', text):
        assert name in build.SIGNATURES[lib], f"{lib}.{name}"
    known = set().union(*(build.SIGNATURES[lib] for lib in libs))
    named = set(re.findall(r'[."](fa_\w+)', text))
    assert named and named <= known, \
        f"{path.name} names {sorted(named - known)} outside {sorted(libs)}"


# each 16-bit entry point of K1-K8 and its fp32 twin (csrc/*_f32.cu), which
# takes the same arguments (dtype code 2)
FP32_TWINS = {
    ("fwd", "fa_fwd_launch"): ("fwd_f32", "fa_fwd_f32_launch"),
    ("fwd", "fa_varlen_fwd_launch"): ("fwd_f32", "fa_varlen_fwd_f32_launch"),
    ("varlen_paged", "fa_varlen_paged_launch"):
        ("fwd_f32", "fa_varlen_paged_f32_launch"),
    ("bwd", "fa_dq_launch"): ("bwd_f32", "fa_dq_f32_launch"),
    ("bwd", "fa_dkv_launch"): ("bwd_f32", "fa_dkv_f32_launch"),
    ("bwd", "fa_varlen_dq_launch"): ("bwd_f32", "fa_varlen_dq_f32_launch"),
    ("bwd", "fa_varlen_dkv_launch"): ("bwd_f32", "fa_varlen_dkv_f32_launch"),
    ("decode", "fa_decode_launch"): ("decode_f32", "fa_decode_f32_launch"),
}


@pytest.mark.parametrize("entry", sorted(FP32_TWINS), ids=lambda e: e[1])
def test_fp32_entries_take_the_16bit_arguments(entry):
    lib32, fn32 = FP32_TWINS[entry]
    lib, fn = entry
    assert build.SIGNATURES[lib32][fn32] == build.SIGNATURES[lib][fn]
    assert _entries(lib32)[fn32] == _entries(lib)[fn]
