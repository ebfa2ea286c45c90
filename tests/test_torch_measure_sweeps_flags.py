"""The port's tile and unroll sweeps (flash_attn_v100_tpu_torch/benchmarks/:
prof_prefill, prof_varlen, prof_bwd, prof_bwd_unroll, prof_dkv_wide,
prof_fwd_pipeline, prof_fwd_unroll, prof_varlen_unroll, prof_int4_ablate)
keep the JAX repository's scripts' settings: every value a JAX script
fixes in its code (shapes, NCH / N_CHAIN, measure's iters, the rounds, the
U lists, the page size, the VARIANTS default), read from its source with
`ast`, is a flag of the port's script with that default (read from the
script's `parser()`).  Documented changes: `--device` and `--rounds` are
added everywhere; the JAX scripts' TPU tile tables (block_sizes) become
the Hopper build variants of benchmarks/variants.py (`--tiles`,
`--dq-tiles`, `--dkv-tiles`, `--variants`), every one of which names a
variant of its kernel; the uniform batch [L] * B is `--uniform B L`."""

import ast
import importlib
import re

import pytest
import torch
from torch_script_flags import JAX, assignments, env_defaults, function_defaults

from flash_attn_v100_tpu_torch.benchmarks import variants as var

torch.set_num_threads(1)

SWEEPS = ["prof_prefill", "prof_varlen", "prof_bwd", "prof_bwd_unroll",
          "prof_dkv_wide", "prof_fwd_pipeline", "prof_fwd_unroll",
          "prof_varlen_unroll", "prof_int4_ablate"]
# the port's variant lists, by flag: the kernels whose variants they name
VARIANT_FLAGS = {"--tiles": ("K1", "K5"), "--dq-tiles": ("K2",),
                 "--dkv-tiles": ("K3",)}


def port(name):
    return importlib.import_module(
        f"flash_attn_v100_tpu_torch.benchmarks.{name}")


def port_flags(name) -> dict:
    """{flag (or positional dest): (type name, default)} of the script's
    parser."""
    out = {}
    for a in port(name).parser()._actions:
        if a.dest == "help":
            continue
        key = a.option_strings[0] if a.option_strings else a.dest
        out[key] = (a.type.__name__ if a.type else None, a.default)
    return out


def _int(x):
    return ("int", int(x))


def _src(name) -> str:
    return (JAX / f"{name}.py").read_text()


def _iters(src: str) -> int:
    """measure(..., iters=N)'s N (one value in each script)."""
    (n,) = set(re.findall(r"iters=(\d+)", src))
    return int(n)


def _rounds(src: str) -> int:
    """The median's rounds: `for _ in range(N)`."""
    (n,) = set(re.findall(r"for _ in range\((\d+)\)", src))
    return int(n)


def _value(src: str, target: str):
    """The value of the script's assignment to `target`, evaluated (the
    mixed batch is an arithmetic expression)."""
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == target):
            return eval(compile(ast.Expression(node.value), "<jax>", "eval"))
    raise KeyError(target)


def expected(name) -> dict:
    src, a = _src(name), assignments(JAX / f"{name}.py")
    want = {"--device": (None, "cuda"), "--rounds": _int(_rounds(src)),
            "--iters": _int(_iters(src))}
    shape = {"--heads": _int(a["Hq"]), "--kv-heads": _int(a["Hk"]),
             "--head-dim": _int(a["D"])}
    if "B" in a:
        shape["--batch"] = _int(a["B"])
    if "M" in a:
        shape["--seqlen"] = _int(a["M"])
    want.update(shape)
    if "NCH" in a:
        want["--chain"] = _int(a["NCH"])
    if name == "prof_prefill":
        assert 'sys.argv[1:] or ["causal", "full", "ceiling"]' in src
        want.update({"which": (None, ["causal", "full", "ceiling"]),
                     "--tiles": (None, ["bk128", "bq64"])})
    elif name == "prof_varlen":
        n, b = re.search(r"bench\(\[(\d+)\] \* (\d+), True", src).groups()
        mixed = ast.literal_eval(re.search(
            r'bench\((\[[\d, ]+\]), True, "mixed', src).group(1))
        assert '"bs" in sys.argv' in src and '"ceiling" in sys.argv' in src
        want.update({"extra": (None, []), "--uniform": ("int", [int(b),
                                                                int(n)]),
                     "--mixed": ("int", mixed),
                     "--tiles": (None, ["bk128", "bq64"])})
    elif name in ("prof_bwd", "prof_bwd_unroll"):
        want["--dq-tiles"] = (None, ["bk64"])
        if name == "prof_bwd":
            want["--dkv-tiles"] = (None, ["bq64", "keys128"])
    elif name == "prof_dkv_wide":
        want["--dkv-tiles"] = (None, ["bq64", "keys128"])
    elif name == "prof_fwd_pipeline":
        want["--variants"] = (None, ["pingpong", "pingpong-bk128"])
    elif name == "prof_fwd_unroll":
        assert "for U in (1, 2, 4):" in src
        want["--unroll"] = ("int", [1, 2, 4])
    elif name == "prof_varlen_unroll":
        uni = _value(src, "uni")
        main = src.split('if __name__ == "__main__":')[1].split(
            "def bench_paged_quant")[0]
        assert re.search(r"for U in \(1, 2, 4\):\n\s+bench\(\"uniform", main)
        assert re.search(r"for U in \(1, 2\):\n\s+bench\(\"mixed", main)
        assert re.search(r"for U in \(1, 2, 4, 8\):\n\s+bench_paged\(", main)
        full = [int(u) for u in re.findall(
            r'bench\("uniform-8x2048", uni, False, (\d+)\)', main)]
        want.update({
            "--uniform": ("int", [len(uni), uni[0]]),
            "--mixed": ("int", _value(src, "mixed")),
            "--unroll": ("int", [1, 2, 4]), "--full-unroll": ("int", full),
            "--mixed-unroll": ("int", [1, 2]),
            "--paged-unroll": ("int", [1, 2, 4, 8]),
            "--page-size": _int(function_defaults(JAX / f"{name}.py",
                                                  "bench_paged")["ps"]),
            "--paged-quant": (None, False)})
        assert "bench_paged_quant(" not in main   # defined, never called
    else:
        assert name == "prof_int4_ablate"
        env = env_defaults(JAX / f"{name}.py")
        want.update({"--ctx": _int(a["ctx"]),
                     "--page-size": _int(env["PS"]),
                     "--chain": _int(env["N_CHAIN"]),
                     "--variants": (None, env["VARIANTS"].split(","))})
    return want


@pytest.mark.parametrize("name", SWEEPS)
def test_flags_and_defaults_are_the_jax_scripts(name):
    assert port_flags(name) == expected(name)


@pytest.mark.parametrize("name", SWEEPS)
def test_variant_flags_name_variants(name):
    """Every default of a variant-list flag is a variant of its kernel."""
    flags = dict(VARIANT_FLAGS)
    if name == "prof_fwd_pipeline":
        flags["--variants"] = ("K1",)
    for flag, (_, default) in port_flags(name).items():
        if flag in flags:
            for kernel in flags[flag]:
                assert set(default) <= set(var.TABLES[kernel][0]), \
                    (name, flag, default)


def test_int4_ablate_names_are_the_jax_scripts():
    """The port's variant names are the JAX script's ALL dict's, its three
    patched modes the port's K4q ablations."""
    from flash_attn_v100_tpu_torch.benchmarks import prof_int4_ablate as ab
    src = _src("prof_int4_ablate")
    body = src.split("ALL = {")[1].split("\n}")[0]
    names = re.findall(r'^\s+"([\w-]+)":', body, re.M)
    assert sorted(names) == sorted(ab.ALL)
    modes = re.findall(r'patch="(\w+)"', body)
    assert sorted(m.replace("_", "-") for m in modes) == sorted(var.INT4)
    assert {f"int4-{m}" for m in var.INT4} == set(ab.ABLATION)


@pytest.mark.parametrize("name", SWEEPS)
def test_sweeps_refuse_to_run_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port(name).main([])


def test_smoke_runs_every_sweep_with_its_flags():
    """chip_smoke.SWEEP_RUNS runs each of the nine scripts once, with
    arguments its parser takes, and its comparisons against
    profile_kernels name rows the reduced runs print."""
    import chip_smoke
    assert [name for name, _ in chip_smoke.SWEEP_RUNS] == SWEEPS
    for name, args in chip_smoke.SWEEP_RUNS:
        port(name).parser().parse_args(list(args))
    scripts = dict(chip_smoke.SWEEP_RUNS)
    for script, row, key, _, kid, spread in chip_smoke.SWEEP_VS_PROFILE:
        assert script in scripts and spread in chip_smoke.SWEEP_SPREAD
        assert kid in ("K1", "K2", "K3", "K5", "K4q")
