"""`install_canonical_name` (utils/distinfo.py) in fresh processes: it
gives the port's drop-in surface the `flash_attn` import name (find_spec
and importlib.metadata resolve, the names are the port's, no JAX is
imported), from a directory without the repository's root shim on the path
and from the root, where it is; and it refuses when the root shim over the
JAX package is already imported."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

INSTALL = """
import importlib.metadata, importlib.util, sys
from flash_attn_v100_tpu_torch.utils.distinfo import install_canonical_name
from flash_attn_v100_tpu_torch.ops import padding, varlen
mod = install_canonical_name(sys.argv[1])
import flash_attn
from flash_attn.bert_padding import pad_input, unpad_input
from flash_attn.flash_attn_interface import flash_attn_varlen_func
assert flash_attn is mod and install_canonical_name() is mod
spec = importlib.util.find_spec("flash_attn")
assert spec.name == "flash_attn" and spec.submodule_search_locations
assert importlib.util.find_spec("flash_attn.bert_padding").name == (
    "flash_attn.bert_padding")
assert importlib.metadata.version("flash_attn") == "2.8.3"
assert unpad_input is padding.unpad_input and pad_input is padding.pad_input
assert flash_attn_varlen_func is varlen.flash_attn_varlen_func
assert flash_attn.flash_attn_varlen_func is varlen.flash_attn_varlen_func
assert "jax" not in sys.modules, "jax imported"
print("installed")
"""

REFUSE = """
import sys
import flash_attn                      # the root shim over the JAX package
from flash_attn_v100_tpu_torch.utils.distinfo import install_canonical_name
try:
    install_canonical_name()
except RuntimeError as e:
    assert "already imported" in str(e)
    assert sys.modules["flash_attn"] is flash_attn
    print("refused")
"""


def _python(code, *args, cwd):
    return subprocess.run(
        [sys.executable, "-c", code, *args], cwd=cwd, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=str(ROOT)))


def test_install_canonical_name_in_a_fresh_process(tmp_path):
    """From a directory where the root shim is not on the path, and from
    the repository root, where it is (sys.modules wins)."""
    for cwd in (tmp_path, ROOT):
        r = _python(INSTALL, str(tmp_path / "site"), cwd=cwd)
        assert r.returncode == 0 and "installed" in r.stdout, r.stderr


def test_install_canonical_name_refuses_another_flash_attn(tmp_path):
    r = _python(REFUSE, cwd=ROOT)
    assert r.returncode == 0 and "refused" in r.stdout, r.stderr
