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
