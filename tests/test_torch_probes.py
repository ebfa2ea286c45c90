"""The cost probes P1-P3 (ops/cuda/probes.py) against the TPU probes of the
JAX repository's benchmark folder: each TPU kernel runs in Pallas interpret
mode at a reduced shape (128-row q blocks, 128-key tiles) and the port's
plain twin runs the same variant on the same numpy inputs at the same
tiles.  Gates as the chip's (probes.compare): out rows within 2 bf16 ulps
of the row's largest |out|, LSE within 1e-5 relatively, NaN / inf masks
equal.

benchmarks/prof_softmax_cost.py runs its whole benchmark at import, so it
is never imported: its source is parsed and only its imports, constants
(overridden) and the `kernel` / `kernel2` definitions are executed, and the
pallas_call is rebuilt here with its BlockSpecs.  prof_fwd_gap.py and
prof_small_streams.py are imported and their shape constants patched."""

import ast
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flash_attn_v100_tpu_torch.ops.cuda import probes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmarks"
D = 128
T = 128                  # the reduced q block and key tile of the TPU kernels


def _module(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_tpu_probe_{name}", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _softmax_cost_ns(nkv: int) -> dict:
    """prof_softmax_cost.py's imports, constants (BQ = BK = T, NKV = nkv)
    and kernel definitions, executed without its benchmark."""
    tree = ast.parse((BENCH / "prof_softmax_cost.py").read_text())
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            keep.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in (
                "kernel", "kernel2"):
            keep.append(node)
    ns = {"__file__": str(BENCH / "prof_softmax_cost.py")}
    exec(compile(ast.Module(body=keep, type_ignores=[]),
                 "prof_softmax_cost.py", "exec"), ns)
    ns.update(BQ=T, BK=T, D=D, NKV=nkv)
    return ns


def _p1_call(stages, q, k, v, nkv):
    """prof_softmax_cost.build's pallas_call (kernel) at the reduced shape."""
    ns = _softmax_cost_ns(nkv)
    BQ, BK = ns["BQ"], ns["BK"]
    return pl.pallas_call(
        functools.partial(ns["kernel"], stages=frozenset(stages)),
        grid=(nkv,),
        in_specs=[pl.BlockSpec((BQ, D), lambda ki: (0, 0)),
                  pl.BlockSpec((BK, D), lambda ki: (ki, 0)),
                  pl.BlockSpec((BK, D), lambda ki: (ki, 0))],
        out_specs=pl.BlockSpec((BQ, D), lambda ki: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((BQ, D), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((BQ, 128), jnp.float32),
                        pltpu.VMEM((BQ, 128), jnp.float32),
                        pltpu.VMEM((BQ, D), jnp.float32)],
    )(q, k, v)


def _p1_call2(q, k, v, nkv):
    """prof_softmax_cost.build2's pallas_call (kernel2)."""
    ns = _softmax_cost_ns(nkv)
    BQ, BK = ns["BQ"], ns["BK"]
    return pl.pallas_call(
        ns["kernel2"],
        grid=(nkv // 2,),
        in_specs=[pl.BlockSpec((BQ, D), lambda ki: (0, 0)),
                  pl.BlockSpec((2 * BK, D), lambda ki: (ki, 0)),
                  pl.BlockSpec((2 * BK, D), lambda ki: (ki, 0))],
        out_specs=pl.BlockSpec((BQ, D), lambda ki: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((BQ, D), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((BQ, 128), jnp.float32),
                        pltpu.VMEM((BQ, 128), jnp.float32),
                        pltpu.VMEM((BQ, D), jnp.float32)],
    )(q, k, v)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(x):
    """numpy fp32 -> (JAX bf16, torch bf16) of the same values."""
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _assert_gates(jax_out, twin_out, jax_lse=None, twin_lse=None, name=""):
    o = torch.from_numpy(np.array(jax_out.astype(jnp.float32)))
    lse = (None if jax_lse is None else
           torch.from_numpy(np.array(jax_lse, np.float32)))
    res = probes.compare(twin_out.reshape(o.shape), o,
                         None if lse is None else twin_lse.reshape(lse.shape),
                         lse)
    assert res["ok"], f"{name}: {res}"
    return res


P1_NKV = 4


@pytest.mark.parametrize("name", list(probes.P1_VARIANTS))
def test_p1_twin_matches_the_tpu_kernel(name):
    probe = probes.P1_VARIANTS[name]
    qn, kn, vn = _inputs(1, (T, D), (T * P1_NKV, D), (T * P1_NKV, D))
    (qj, qt), (kj, kt), (vj, vt) = _both(qn), _both(kn), _both(vn)
    with pltpu.force_tpu_interpret_mode():
        out = (_p1_call2(qj, kj, vj, P1_NKV) if probe.wide else
               _p1_call(probe.stages or ("",), qj, kj, vj, P1_NKV))
    # the TPU kernel's online update covers one BK tile (kernel2: one
    # sub-tile), so the twin runs at bk = T; its bf16 exp2 as lax.exp2
    twin = probes.flash_step_ref(qt[None], kt[None], vt[None], probe,
                                 probes.SCALE, bk=T, bq=T, bf16_exp2="lax")
    res = _assert_gates(out, twin[0], name=name)
    if "exp" in probe.stages and "max" not in probe.stages:
        assert res["masks_equal"] and torch.isnan(twin).all(), name
    if not probe.stages:
        assert not twin.float().abs().max(), "qk only gives zeros"


@pytest.fixture(scope="module")
def fwd_gap():
    mod = _module("prof_fwd_gap")
    for k_, v_ in dict(B=1, Hq=2, Hk=1, M=256, N=256, BQ=T, BK=T, NQ=2,
                       NKV=2, group=2).items():
        setattr(mod, k_, v_)
    return mod


@pytest.mark.parametrize("name", list(probes.P2_VARIANTS))
def test_p2_twin_matches_the_tpu_kernel(fwd_gap, name):
    probe = probes.P2_VARIANTS[name]
    g = fwd_gap
    make = {"minimal 3d rect": g.make_minimal, "+lse": g.make_lse,
            "+prefetch pairs": g.make_prefetch,
            "4d layout (prod-like)": g.make_4d}[name]
    qn, kn, vn = _inputs(2, (g.B * g.Hq, g.M, D), (g.B * g.Hk, g.N, D),
                         (g.B * g.Hk, g.N, D))
    (qj, qt), (kj, kt), (vj, vt) = _both(qn), _both(kn), _both(vn)
    with pltpu.force_tpu_interpret_mode():
        res = make()[0](qj, kj, vj)
    out, lse = res if isinstance(res, tuple) else (res, None)
    if probe.strided:
        qt, kt, vt = (x.reshape(g.B, -1, *x.shape[1:]) for x in (qt, kt, vt))
    twin = probes.flash_step_ref(
        qt, kt, vt, probe, probes.SCALE_LOG2, bk=T, bq=T,
        pairs=probes.rect_pairs(g.NQ, g.NKV) if probe.pairs else None)
    tout, tlse = twin if probe.lse else (twin, None)
    _assert_gates(out, tout, lse, tlse, name)


@pytest.fixture(scope="module")
def streams():
    mod = _module("prof_small_streams")
    for k_, v_ in dict(BH=4, M=256, N=256, BQ=T, BK=T, NQ=2, NKV=2).items():
        setattr(mod, k_, v_)
    return mod


@pytest.mark.parametrize("name", list(probes.P3_VARIANTS))
def test_p3_twin_matches_the_tpu_kernel(streams, name):
    probe = probes.P3_VARIANTS[name]
    s = streams
    f = (s.make_dynamic_grid() if probe.dynamic else
         s.make_branches() if probe.branches else
         s.make(probe.n_qside, probe.n_kside))
    qn, kn, vn = _inputs(3, (s.BH, s.M, D), (s.BH // 4, s.N, D),
                         (s.BH // 4, s.N, D))
    (qj, qt), (kj, kt), (vj, vt) = _both(qn), _both(kn), _both(vn)
    with pltpu.force_tpu_interpret_mode():
        out = f(qj, kj, vj)
    # the TPU kernels' side and segment vectors are zeros
    zq = torch.zeros(s.M, dtype=torch.int32)
    zk = torch.zeros(s.N, dtype=torch.int32)
    twin = probes.flash_step_ref(
        qt, kt, vt, probe, probes.SCALE_LOG2, bk=T, bq=T,
        qside=[zq] * probe.n_qside, kside=[zk] * probe.n_kside,
        qseg=zq, kseg=zk)
    _assert_gates(out, twin, name=name)


def test_twin_branches_skip_tiles_without_overlap():
    """A key tile whose segments meet none of the q block's leaves that
    block's state alone (the TPU kernel's skipped step): with the second
    key tile in another segment, block 0 sees only the first tile."""
    probe = probes.P3_VARIANTS["seg-reduce + 3 branches"]
    qn, kn, vn = _inputs(4, (1, 256, D), (1, 256, D), (1, 256, D))
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (qn, kn, vn))
    qseg = torch.tensor([0] * 128 + [1] * 128, dtype=torch.int32)
    kseg = qseg.clone()
    out = probes.flash_step_ref(q, k, v, probe, probes.SCALE_LOG2, bk=128,
                                bq=128, qseg=qseg, kseg=kseg)
    full = probes.Probe()
    for blk in range(2):
        rows, cols = slice(128 * blk, 128 * (blk + 1)), slice(
            128 * blk, 128 * (blk + 1))
        ref = probes.flash_step_ref(q[:, rows], k[:, cols], v[:, cols], full,
                                    probes.SCALE_LOG2, bk=128, bq=128)
        assert torch.equal(out[:, rows], ref)


def test_cpu_wrapper_takes_the_twin_at_the_kernel_tiles():
    """flash_step on CPU tensors is the twin at bk 64 (128 when wide) and
    128-row blocks, and launches nothing."""
    qn, kn, vn = _inputs(5, (2, 128, D), (1, 256, D), (1, 256, D))
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (qn, kn, vn))
    before = probes.flash_step.launches
    for probe in (probes.P1_VARIANTS["qk+max+pv"],
                  probes.P1_VARIANTS["2048-kv, 2 sub-tiles"],
                  probes.P2_VARIANTS["+prefetch pairs"]):
        out = probes.flash_step(q, k, v, probe, probes.SCALE)
        ref = probes.flash_step_ref(
            q, k, v, probe, probes.SCALE, bk=probe.bk, bq=128,
            pairs=probes.rect_pairs(1, 256 // probe.bk) if probe.pairs
            else None)
        for a, b in zip(out if probe.lse else (out,),
                        ref if probe.lse else (ref,)):
            assert torch.equal(a, b)
    assert probes.flash_step.launches == before
    with pytest.raises(ValueError, match="q-side"):
        probes.flash_step(q, k, v, probes.Probe(n_qside=1), probes.SCALE)


def test_variant_flags_are_the_instantiated_ones():
    """Every variant's flags name an instantiation of csrc/probes.cu, and
    every instantiation a variant."""
    src = (Path(probes.build.CSRC) / "probes.cu").read_text()
    body = src.split("#define FA_PROBE_VARIANTS(X)")[1].split("\n}")[0]
    inst = {int(x) for x in __import__("re").findall(r"X\((\d+)\)", body)}
    assert inst == set(probes.VARIANT_FLAGS)
    assert len(inst) == 16


def test_parse_sass_counts():
    sass = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_112probe_kernelILi27EEEvNS_9ProbeArgsE",
        "        /*0a70*/   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;",
        "        /*0a80*/   HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;",
        "        /*0a90*/   MUFU.EX2 R3, R4 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_112probe_kernelILi0EEEvNS_9ProbeArgsE",
        "        /*0a70*/   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;",
    ])
    assert probes.parse_sass_counts(sass) == {
        27: dict(hgmma_ss=1, hgmma_rs=1, ex2=1),
        0: dict(hgmma_ss=1, hgmma_rs=0, ex2=0)}
    assert probes.expected_hgmma(probes.Probe()) == (16, 8)
    assert probes.expected_hgmma(probes.Probe(stages=())) == (16, 0)
    assert probes.expected_hgmma(probes.Probe(wide=True)) == (16, 16)


def test_compare_gates():
    ref = torch.tensor([[1.0, -0.5, float("nan")], [0.0, 0.0, 0.0]])
    assert probes.compare(ref.clone(), ref)["ok"]
    worse = ref.clone()
    worse[0, 1] += 2 ** -6              # 2 ulps of 1.0 are 2**-6: inside
    assert probes.compare(worse, ref)["ok"]
    worse[0, 1] += 2 ** -8
    assert not probes.compare(worse, ref)["ok"]
    nan_moved = ref.clone()
    nan_moved[0, 2] = 0.0
    assert not probes.compare(nan_moved, ref)["ok"]
    lse = torch.tensor([10.0, float("-inf")])
    assert probes.compare(ref, ref, lse * (1 + 5e-6), lse)["ok"]
    assert not probes.compare(ref, ref, lse * (1 + 5e-5), lse)["ok"]
