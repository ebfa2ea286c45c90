"""The port stands alone: no file of flash_attn_v100_tpu_torch/, and not
chip_smoke.py, imports jax, the JAX package or its flash_attn shim."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flash_attn_v100_tpu", "flash_attn"}
PKG = ROOT / "flash_attn_v100_tpu_torch"
# build/ holds generated, git-ignored output, not sources of the port
FILES = sorted(p for p in PKG.rglob("*.py")
               if "build" not in p.relative_to(PKG).parts) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_found():
    assert len(FILES) > 15 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_does_not_import_jax(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


MEASURE_SCRIPTS = ["common", "profile_kernels", "prof_calibrate",
                   "prof_decode_scan", "prof_decode_int8", "prof_int4",
                   "prof_decode_pagesize", "prof_int4_rmw",
                   "prof_decode_attrib", "prof_ttft_tail", "bench_scaling",
                   "check_ring_overlap",
                   # the tile and unroll sweeps and their variants
                   "variants", "prof_prefill", "prof_varlen", "prof_bwd",
                   "prof_bwd_unroll", "prof_dkv_wide", "prof_fwd_pipeline",
                   "prof_fwd_unroll", "prof_varlen_unroll",
                   "prof_int4_ablate"]


@pytest.mark.parametrize("name", MEASURE_SCRIPTS)
def test_measurement_scripts_are_guarded(name):
    """The measurement, attribution and sweep scripts are among the files
    held free of JAX above."""
    assert PKG / "benchmarks" / f"{name}.py" in FILES


def _levels_up(node: ast.AST):
    """How many directories above its own file a path expression built from
    `__file__` climbs (Path(...).parents[N], .parent, os.path.dirname), or
    None for an expression not built from `__file__`."""
    if isinstance(node, ast.Name):
        return 0 if node.id == "__file__" else None
    if isinstance(node, ast.Attribute) and node.attr == "parent":
        inner = _levels_up(node.value)
        return None if inner is None else inner + 1
    if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute)
            and node.value.attr == "parents"
            and isinstance(node.slice, ast.Constant)):
        inner = _levels_up(node.value.value)
        return None if inner is None else inner + node.slice.value + 1
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
        if name in ("resolve", "absolute") and isinstance(fn, ast.Attribute):
            return _levels_up(fn.value)
        if name in ("Path", "abspath", "realpath", "normpath") and node.args:
            return _levels_up(node.args[0])
        if name == "dirname" and node.args:
            inner = _levels_up(node.args[0])
            return None if inner is None else inner + 1
    return None


def _deepest_climb(source: str) -> int:
    levels = [_levels_up(n) for n in ast.walk(ast.parse(source))]
    return max((x for x in levels if x is not None), default=0)


@pytest.mark.parametrize("src, levels", [
    ("Path(__file__).resolve().parents[2] / 'csrc'", 3),
    ("Path(__file__).parent.parent", 2),
    ("os.path.dirname(os.path.dirname(os.path.abspath(__file__)))", 2),
    ("x = 1", 0),
])
def test_climb_counter(src, levels):
    assert _deepest_climb(src) == levels


PKG_FILES = [p for p in FILES if PKG in p.parents]


@pytest.mark.parametrize("path", PKG_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_paths_stay_in_package(path):
    """No port module reaches a file outside flash_attn_v100_tpu_torch/
    through a path built from its own __file__: a file at depth n below the
    package may climb n directories at most (to the package itself)."""
    depth = len(path.relative_to(PKG).parts)
    assert _deepest_climb(path.read_text()) <= depth, (
        f"{path.relative_to(ROOT)} builds a path outside the package")


def test_native_runtime_source_is_the_ports_copy():
    """The native runtime builds from the port's own copy of the scheduler
    and allocator source, not the JAX package's file at the repository
    root."""
    from flash_attn_v100_tpu_torch.runtime import native
    src = Path(native._SRC)
    assert src == PKG / "csrc" / "fa_runtime.cpp"
    assert src.is_file()
    assert native._so_path().parent == PKG / "build"
