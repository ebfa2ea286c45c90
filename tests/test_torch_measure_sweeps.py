"""The port's tile and unroll sweeps on the CPU (`--device cpu`, tiny
shapes): each script's shipped rows run through the kernels' plain twins
and are timed (a call's seconds; no device time off the card), its variant
rows print "needs the card" and are not run, and every row's FLOP or byte
count equals the JAX script's formula, evaluated through the JAX package's
utils/benchmarking.attention_flops where the JAX line uses it."""

import pytest
import torch

from flash_attn_v100_tpu.utils.benchmarking import attention_flops
from flash_attn_v100_tpu_torch.benchmarks import (
    prof_bwd, prof_bwd_unroll, prof_dkv_wide, prof_fwd_pipeline,
    prof_fwd_unroll, prof_int4_ablate, prof_prefill, prof_varlen,
    prof_varlen_unroll)
from flash_attn_v100_tpu_torch.benchmarks.common import NEEDS_CARD

torch.set_num_threads(1)

B, M, HQ, HK, D = 1, 64, 4, 2, 128
DENSE = ["--device", "cpu", "--batch", str(B), "--seqlen", str(M),
         "--heads", str(HQ), "--kv-heads", str(HK), "--rounds", "1",
         "--chain", "1", "--iters", "1"]


def _dense(causal, mult=1.0):
    return int(attention_flops(B, M, M, HQ, D, causal=causal) * mult)


def _jax_varlen(lens, causal):
    """The JAX scripts' varlen count, as written there."""
    return sum(4 * HQ * L * L * D // (2 if causal else 1) for L in lens)


def _shipped_and_variants(rows, n_shipped, n_variants):
    ran = [r for r in rows.values() if "call_s" in r]
    skipped = [r for r in rows.values() if r.get("skipped") == NEEDS_CARD]
    assert len(ran) == n_shipped and len(skipped) == n_variants, rows
    for r in ran:
        assert r["call_s"] > 0 and r["device_s"] is None
        assert r["variant"] is None
    for r in skipped:
        assert r["variant"] is not None and "occupancy" not in r


def test_prof_prefill(capsys):
    rows = prof_prefill.main(DENSE)
    _shipped_and_variants(rows, 2, 5)
    for name, r in rows.items():
        assert r["flops"] == _dense(not name.startswith("full")), name
    assert rows["causal CEILING (every tile unmasked)"]["variant"] == \
        "unmasked"
    assert "needs the card" in capsys.readouterr().out


def test_prof_varlen():
    lens = [30, 64, 7]
    rows = prof_varlen.main(["bs", "ceiling", "--device", "cpu",
                             "--uniform", "2", "64", "--mixed",
                             *map(str, lens), "--heads", str(HQ),
                             "--kv-heads", str(HK), "--rounds", "1",
                             "--chain", "1", "--iters", "1"])
    _shipped_and_variants(rows, 6, 5)
    for name, r in rows.items():
        batch = lens if name.startswith("mixed") else [64, 64]
        fl = _jax_varlen(batch, "full" not in name)
        assert r["flops"] == (int(fl * 2.5) if name.endswith("bwd") else fl)
        if name.endswith("fwd") and r["variant"] is None:
            assert r["check"].startswith("K5 out err")


@pytest.mark.parametrize("mod,mult,n_rows", [
    (prof_bwd, 2.5, (1, 3)), (prof_bwd_unroll, 2.5, (2, 2)),
    (prof_dkv_wide, 3.5, (1, 2))], ids=["prof_bwd", "prof_bwd_unroll",
                                        "prof_dkv_wide"])
def test_backward_sweeps(mod, mult, n_rows):
    rows = mod.main(DENSE)
    rows = {k: v for k, v in rows.items() if not k.startswith("split")}
    _shipped_and_variants(rows, *n_rows)
    for name, r in rows.items():
        assert r["flops"] == _dense("causal=False" not in name, mult), name
        if r["variant"] is None:   # the shipped row held to its twin
            assert r["check"].count("err") == 3


@pytest.mark.parametrize("mod,n_rows", [(prof_fwd_unroll, (2, 4)),
                                        (prof_fwd_pipeline, (2, 4))],
                         ids=["prof_fwd_unroll", "prof_fwd_pipeline"])
def test_forward_sweeps(mod, n_rows):
    rows = mod.main(DENSE)
    _shipped_and_variants(rows, *n_rows)
    for name, r in rows.items():
        assert r["flops"] == _dense("causal=True" in name), name


def test_prof_varlen_unroll():
    lens = [30, 64, 7]
    rows = prof_varlen_unroll.main([
        "--device", "cpu", "--uniform", "2", "128", "--mixed",
        *map(str, lens), "--heads", str(HQ), "--kv-heads", str(HK),
        "--rounds", "1", "--chain", "1", "--iters", "1", "--paged-quant"])
    quant = {k: v for k, v in rows.items() if "-int" in k or "-fp8" in k}
    _shipped_and_variants({k: v for k, v in rows.items() if k not in quant},
                          4, 7)
    for name, r in rows.items():
        batch = lens if name.startswith("mixed") else [128, 128]
        assert r["flops"] == _jax_varlen(batch, "False" not in name), name
    assert len(quant) == 12
    for name, r in quant.items():   # K8q at U 1; no unroll variant
        assert ("call_s" in r) == name.endswith("U=1"), name


def test_prof_int4_ablate():
    Bd, ctx, hk = 2, 1024, 2
    rows = prof_int4_ablate.main([
        "--device", "cpu", "--batch", str(Bd), "--ctx", str(ctx),
        "--heads", "8", "--kv-heads", str(hk), "--rounds", "1", "--chain",
        "1", "--iters", "1", "--variants", *prof_int4_ablate.ALL])
    assert set(rows) == set(prof_int4_ablate.ALL)
    for name, r in rows.items():
        int4 = name != "int8"
        assert r["nbytes"] == 2 * Bd * ctx * hk * ((D // 2 if int4 else D)
                                                   + 4), name
    assert [n for n, r in rows.items() if "call_s" in r] == [
        "int8", "int4-prod", "int4-S2"]
    assert rows["int4-U4"]["skipped"].startswith("n/a on the port")
    assert all(rows[n]["variant"] for n in prof_int4_ablate.ABLATION)
