"""The port's measurement and attribution scripts
(flash_attn_v100_tpu_torch/benchmarks/: profile_kernels, prof_calibrate,
prof_decode_scan, prof_decode_int8, prof_int4, prof_decode_pagesize,
prof_int4_rmw, prof_decode_attrib, prof_ttft_tail, bench_scaling,
check_ring_overlap) keep the JAX repository's scripts' settings: every
argparse flag of a JAX script with its default, and every value a JAX
script fixes in its code (module level or in a function, environment
defaults included) as a flag of the port's whose default is that value,
read from both files with `ast`.  Documented changes: `--device` is added
everywhere; bench_scaling's `--devices 0` means one rank a card;
check_ring_overlap traces `--ranks` gloo ranks (2) where JAX compiled
for an 8-device TPU topology, and measures K1's causal rate at
`--rate-seqlen` (4096, the JAX script's "4k causal" kernel rate);
prof_ttft_tail selects its knob sets by `--configs` (default: the six of
the JAX script's __main__); the model scripts' widths come from
common.MEASURE_MODEL.  Without a card each script raises."""

import pytest
import torch
from torch_script_flags import (
    JAX, PORT, assignments, calls, env_defaults, flags, function_defaults)

from flash_attn_v100_tpu_torch.benchmarks import common

torch.set_num_threads(1)

DEVICE = {"--device": (None, "cuda")}


def _model_flags():
    """The flags `common.add_model_flags` adds, with their defaults."""
    return {flag: (type(common.MEASURE_MODEL[key]).__name__,
                   common.MEASURE_MODEL[key])
            for key, flag in common._MODEL_FLAGS.items()}


def _int(x):
    return ("int", int(x))


def expected(name):
    """The port script's flags: the JAX script's argparse flags, --device,
    and its fixed values as flags."""
    path = JAX / f"{name}.py"
    a, env, src = assignments(path), env_defaults(path), path.read_text()
    want = dict(flags(path))
    want.update(DEVICE)
    shape = {"--batch": _int(a.get("B", 0)), "--heads": _int(a.get("Hq", 0)),
             "--kv-heads": _int(a.get("Hk", 0)),
             "--head-dim": _int(a.get("D", 0))}
    if name == "profile_kernels":
        want.update(shape, **{"--iters": _int(a["iters"]),
                              "--seqlen": _int(a["M"]),
                              "--decode-batch": _int(a["B2"]),
                              "--ctx": _int(a["ctx"]),
                              "--page-size": _int(a["ps"]),
                              "--lens": ("int", a["lens"])})
    elif name == "prof_calibrate":
        # rng.standard_normal((1 << 30,)), (4096, 4096) operands, range(4)
        # rounds of measure(..., iters=8)
        for text in ("(1 << 30,)", "(4096, 4096)", "range(4)", "iters=8"):
            assert text in src
        want.update({"--elements": _int(1 << 30), "--matmul": _int(4096),
                     "--rounds": _int(4), "--iters": _int(8)})
    elif name in ("prof_decode_scan", "prof_decode_int8"):
        want.update(shape, **{"--ctx": _int(a["ctx"]),
                              "--rounds": _int(env["ROUNDS"])})
        if name == "prof_decode_scan":
            want.update({"--chain": _int(a["N_CHAIN"]),
                         "--set": (None, env["SET"])})
    elif name == "prof_int4":
        want.update(shape, **{"--ctx": _int(env["CTX"]),
                              "--page-size": _int(env["PS"]),
                              "--chain": _int(env["N_CHAIN"])})
    elif name == "prof_decode_pagesize":
        assert "for ps in (128, 256, 512, 1024)" in src
        want.update(shape, **{"--ctx": _int(a["ctx"]),
                              "--chain": _int(a["NCH"]),
                              "--page-sizes": ("int", [128, 256, 512, 1024])})
    elif name == "prof_int4_rmw":
        assert "length=64" in src           # the scan's 64 appends
        want.update({"--kv-heads": _int(a["Hk"]), "--layers": _int(a["L"]),
                     "--batch": _int(a["B"]), "--page-size": _int(a["PS"]),
                     "--head-dim": _int(a["D"]), "--chain": _int(64)})
    elif name == "prof_decode_attrib":
        for text in ("for fuse in (1, 8, 16, 32)", "max_new_tokens=160"):
            assert text in src
        want.update(_model_flags(), **{
            "--batch": _int(a["B"]), "--prompt-len": _int(a["PLEN"]),
            "--page-size": _int(a["PS"]), "--num-pages": _int(a["NPAGES"]),
            "--chain": _int(a["N"]), "--fuse": ("int", [1, 8, 16, 32]),
            "--new-tokens": _int(160)})
    elif name == "prof_ttft_tail":
        assert "page_size=128" in src
        want.update(_model_flags(), **{
            "--requests": _int(a["NREQ"]), "--prompt-len": _int(a["PLEN"]),
            "--new-tokens": _int(a["NEW"]), "--page-size": _int(128),
            "--configs": (None, None)})
    elif name == "bench_scaling":
        pass                                 # its flags are argparse's
    else:
        assert name == "check_ring_overlap"
        want.update({"--ranks": _int(2), "--batch": _int(a["B"]),
                     "--seqlen": _int(a["M"]), "--heads": _int(a["H"]),
                     "--head-dim": _int(a["D"]), "--rate-seqlen": _int(4096)})
    return want


SCRIPTS = ["profile_kernels", "prof_calibrate", "prof_decode_scan",
           "prof_decode_int8", "prof_int4", "prof_decode_pagesize",
           "prof_int4_rmw", "prof_decode_attrib", "prof_ttft_tail",
           "bench_scaling", "check_ring_overlap"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_flags_and_defaults_are_the_jax_scripts(name):
    path = PORT / f"{name}.py"
    port = flags(path)
    if "add_model_flags(ap)" in path.read_text():
        port.update(_model_flags())
    assert port == expected(name)


def test_model_is_the_jax_scripts():
    """MEASURE_MODEL is the ModelConfig both JAX model scripts build."""
    for name in ("prof_decode_attrib", "prof_ttft_tail"):
        (cfg,) = calls(JAX / f"{name}.py", "ModelConfig")
        assert cfg[1] == common.MEASURE_MODEL, name


def test_ttft_knob_sets_are_the_jax_scripts():
    """The nine knob sets, tags and engine keywords, of the JAX script's
    __main__ and quant_configs(), in its order."""
    from flash_attn_v100_tpu_torch.benchmarks import prof_ttft_tail as tt
    jax_sets = [(args[0], kw) for args, kw in calls(
        JAX / "prof_ttft_tail.py", "run")]
    assert [(tag, kw) for tag, kw in tt.CONFIGS.values()] == jax_sets
    assert list(tt.BF16_CONFIGS.values()) == jax_sets[:6]


def test_scaling_shapes_are_the_jax_scripts():
    from flash_attn_v100_tpu_torch.benchmarks import bench_scaling as bs
    path = JAX / "bench_scaling.py"
    ring = function_defaults(path, "bench_ring")
    dec = function_defaults(path, "bench_decode")
    assert {k: bs.RING[k] for k in ring} == ring
    assert {k: bs.DECODE[k] for k in dec} == dec
    src = path.read_text()
    assert f"iters={bs.RING['iters']})" in src.split("def bench_decode")[0]
    assert f"iters={bs.DECODE['iters']})" in src.split("def bench_decode")[1]


def test_decode_scan_variants_are_the_jax_scripts():
    """Every JAX variant name of both sets, in order; U<n> names carry the
    unroll, the others none."""
    from flash_attn_v100_tpu_torch.benchmarks import prof_decode_scan as ds
    src = (JAX / "prof_decode_scan.py").read_text()
    for set_name, variants in ds.SETS.items():
        body = src.split(f'"{set_name}": lambda: {{')[1].split("},")[0]
        names = [ln.split('"')[1] for ln in body.splitlines() if '"' in ln]
        assert list(variants) == names, set_name
        for name, (ps, _, unroll) in variants.items():
            assert f"ps={ps}" in name
            assert (unroll is None) == (" U" not in name), name


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_refuse_to_run_without_a_card(name):
    """Their default device is the card: without one they raise, before
    any work, as the port's entry points do."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = importlib.import_module(
        f"flash_attn_v100_tpu_torch.benchmarks.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
