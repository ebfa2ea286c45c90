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


def _variant_sigs(lib: str) -> dict:
    """Every entry point of the library's variant builds."""
    return {fn: sig for v in build.VARIANTS.get(lib, {}).values()
            for fn, sig in v[2].items()}


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
    missing = (set(_entries(lib)) - set(build.SIGNATURES[lib])
               - set(_variant_sigs(lib)))
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


# ------------------------------------------------------ variant libraries

PKG = CUDA_OPS.parents[1]


def test_variant_registry_found():
    assert set(build.VARIANTS) == {"fwd", "varlen_paged", "bwd", "decode",
                                   "decode_quant"}
    assert build.all_variants() == [(lib, v) for lib in build.VARIANTS
                                    for v in build.VARIANTS[lib]]


@pytest.mark.parametrize("lib", sorted(build.VARIANTS))
def test_variant_signatures_are_defined_in_their_source(lib):
    entries = _entries(lib)
    for name, (argtypes, _) in _variant_sigs(lib).items():
        assert name in entries, name
        assert entries[name] == len(argtypes), name
        assert name not in build.SIGNATURES[lib]


@pytest.mark.parametrize("lib", sorted(build.VARIANTS))
def test_variant_macros_default_to_the_shipped_build(lib):
    """Each macro is defined in the variant's source as 0 unless given: the
    shipped library is built with no -D and compiles its shipped entries,
    the variant's -D sets the macro to its value."""
    text = (build.CSRC / build.SOURCES[lib]).read_text()
    for variant, (macros, what, _) in build.VARIANTS[lib].items():
        assert what and macros
        for macro, value in macros.items():
            assert f"#ifndef {macro}\n#define {macro} 0\n#endif" in text
            assert value != 0
            assert f"-D{macro}={value}" in build._defines(lib, variant)
    assert build._defines(lib, None) == []


@pytest.mark.parametrize("lib", sorted(build.VARIANTS))
def test_variant_library_paths(lib, monkeypatch):
    """A variant's library file carries its name and its flags' hash; a
    shipped library's path does not depend on VARIANTS."""
    shipped = build.library_path(lib)
    for variant in build.VARIANTS[lib]:
        path = build.library_path(lib, variant)
        assert path != shipped and path.name.startswith(f"lib{lib}-{variant}-")
    monkeypatch.setattr(build, "VARIANTS", {})
    assert build.library_path(lib) == shipped


def test_tune_defaults_are_the_shipped_tiles():
    """The kernels' tile and schedule parameters default to the shipped
    values (0: the body's own choice for D), and no shipped kernel names
    them before their sweep dispatch (#else)."""
    fwd = (build.CSRC / "fwd_body.cuh").read_text()
    assert ("template <int KT = 0, int U = 1, int G = 0, bool FAST = false,\n"
            "          bool PP = false>\nstruct FwdTune" in fwd)
    assert "static constexpr int BK = U * KT;" in fwd
    assert "TN::kKT ? TN::kKT : (D == 256 && KV == kKvFp8 ? 32 : 64)" in fwd
    # two warpgroups (128 q rows) a block at every head dim since D 32
    # moved to wgmma
    assert "static constexpr int kGroups = TN::kG ? TN::kG : 2;" in fwd
    bwd = (build.CSRC / "bwd.cu").read_text()
    assert ("template <int DQBK = 0, int DKVBQ = 0, int KG = 1>\n"
            "struct BwdTune" in bwd)
    assert "TN::kDqBK ? TN::kDqBK : (D <= 64 ? 64 : 32)" in bwd
    assert "TN::kDkvBQ ? TN::kDkvBQ : (D <= 64 ? 64 : 32)" in bwd
    dec = (build.CSRC / "decode_body.cuh").read_text()
    assert "template <typename T, int D, int KIND, int ROWS, int ABL = 0>" in dec
    for f in ("fwd.cu", "varlen_paged.cu", "bwd.cu", "decode_quant.cu",
              "varlen_paged_quant.cuh", "decode.cu"):
        shipped = (build.CSRC / f).read_text().split("#else")[0]
        assert not re.search(r"(Fwd|Bwd)Tune<[^>]", shipped), f


@pytest.mark.parametrize("kernel", ["K1", "K8", "K2", "K3", "K4q", "K4"])
def test_variant_ids_are_the_sources(kernel):
    """benchmarks/variants.py's ids are the sweep entries' (the table in
    the comment above each source's sweep dispatch)."""
    from flash_attn_v100_tpu_torch.benchmarks import variants as var
    table, lib = var.TABLES[kernel]
    text = (build.CSRC / build.SOURCES[lib]).read_text()
    prefix = f"{kernel} " if lib == "bwd" else ""
    for name, vid in table.items():
        assert re.search(rf"^//   {prefix}{vid} {re.escape(name)}\b", text,
                         re.M), (kernel, name)
        assert (kernel, name) in var.WHAT


def test_only_benchmarks_ask_for_a_variant():
    """No module of the port outside benchmarks/ loads a variant library or
    imports the variants' launchers: no main-path wrapper reaches one
    (build/, the git-ignored build output, holds no module of the
    port)."""
    for path in PKG.rglob("*.py"):
        rel = path.relative_to(PKG)
        if (rel.parts[0] in ("benchmarks", "build")
                or rel == Path("ops/cuda/build.py")):
            continue
        text = path.read_text()
        assert not re.search(r"build\.load\([^)]*,", text), rel
        assert "benchmarks.variants" not in text, rel
        assert "benchmarks import variants" not in text, rel


SASS = """\
        code for sm_90a
                Function : _Z3fooPf
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0110*/                   HGMMA.64x256x16.F32.BF16 R24, R152, gdesc[UR8], R24 ;
        /*0120*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0130*/                   MUFU.EX2 R5, R6 ;
        /*0140*/                   MUFU.RCP R7, R8 ;
                Function : _Z3barPf
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""

PTXAS = """\
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas info    : Function properties for _Z3barPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
"""


def test_parse_sass_counts_warpgroup_and_warp_products():
    """`cuobjdump -sass` text -> each function's HGMMA (wgmma) and HMMA
    (mma.sync) instructions and its MUFU.EX2 (no other MUFU), under the
    names given for its mangled name."""
    got = build.parse_sass(SASS, {"_Z3fooPf": "foo(float*)"})
    assert got == {"foo(float*)": dict(hgmma=2, hmma=1, mufu_ex2=1),
                   "_Z3barPf": dict(hgmma=0, hmma=1, mufu_ex2=0)}


def test_parse_ptxas_registers_and_local_memory():
    """nvcc -Xptxas -v output -> each kernel's registers, stack and
    spills."""
    assert build.parse_ptxas(PTXAS) == {
        "_Z3fooPf": dict(stack=8, spill_stores=4, spill_loads=12,
                         registers=255),
        "_Z3barPf": dict(stack=0, spill_stores=0, spill_loads=0,
                         registers=96)}
