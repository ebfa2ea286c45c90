"""The port's profile, calibration and decode timing scripts
(flash_attn_v100_tpu_torch/benchmarks/: profile_kernels, prof_calibrate,
prof_decode_scan, prof_decode_int8, prof_int4, prof_decode_pagesize) run
with `--device cpu` (the kernels' plain versions) at a tiny size: each
reaches its end, prints the JAX script's lines with finite numbers, and
counts the JAX script's bytes and FLOPs.  On the CPU no device time is
taken (no graph replay, no device lane)."""

import math
import re

import pytest
import torch

from flash_attn_v100_tpu_torch.benchmarks import (
    prof_calibrate, prof_decode_int8, prof_decode_pagesize,
    prof_decode_scan, prof_int4, profile_kernels)

torch.set_num_threads(1)

NUM = r"([-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?)"
DECODE = ["--device", "cpu", "--batch", "2", "--heads", "8", "--kv-heads",
          "2", "--head-dim", "32", "--ctx", "512"]


def _finite(line):
    nums = [float(x) for x in re.findall(NUM, line)]
    assert nums and all(math.isfinite(x) for x in nums), line
    return nums


def test_profile_kernels_tiny(capsys, tmp_path):
    out = tmp_path / "profiles.md"
    res = profile_kernels.main([
        "--device", "cpu", "--out", str(out), "--iters", "1", "--batch",
        "1", "--seqlen", "64", "--heads", "4", "--kv-heads", "2",
        "--head-dim", "32", "--decode-batch", "2", "--ctx", "256",
        "--page-size", "64", "--lens", "16", "37", "8"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "card: cpu" and lines[-1] == f"wrote {out}"
    assert [r["title"] for r in res] == [
        "Dense causal prefill (B1 S64 Hq4 D32)",
        "Dense causal backward (same shape)",
        "Decode 256 ctx bf16 (B2 Hq4 D32, 64-token pages)",
        "Decode 256 ctx INT8 (same shape)",
        "Varlen mixed-length causal (8..37, Hq4 D32)"]
    text = out.read_text()
    assert text.startswith("# Per-kernel device profiles (NVIDIA H100)")
    for r in res:
        assert f"## {r['title']}" in text
        assert r["total_us"] > 0 and math.isfinite(r["share_pct"])
        assert r["rows"] and all(us >= 0 for _, us, _ in r["rows"])
    # the footer's rate is the JAX script's FLOP / byte count over the time
    fl = 4 * 1 * 64 * 64 * 4 * 32 // 2
    assert res[0]["share_pct"] == pytest.approx(
        100 * fl / (res[0]["total_us"] * 1e-6) / 989e12)
    nbytes = 2 * 2 * 256 * 2 * (32 + 4)
    assert res[3]["share_pct"] == pytest.approx(
        100 * nbytes / (res[3]["total_us"] * 1e-6) / 3.35e12)
    assert len(re.findall(r"Total device time \d+ µs/call; ", text)) == 5


def test_prof_calibrate_tiny(capsys):
    res = prof_calibrate.main(["--device", "cpu", "--elements", "65536",
                               "--matmul", "64", "--rounds", "2",
                               "--iters", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "card: cpu"
    sums = [ln for ln in lines if re.match(r"r\d sum 0.000122\d*GiB bf16:",
                                           ln)]
    mms = [ln for ln in lines if re.match(r"r\d matmul 64\^3: ", ln)]
    assert len(sums) == len(mms) == 2
    for ln in sums + mms:
        _finite(ln)
    assert len(res["sum_gbps"]) == len(res["matmul_tflops"]) == 2
    assert lines[-1].startswith("calibration: best ")
    assert lines[-1].endswith(": OK") == res["ok"]


@pytest.mark.parametrize("set_name", ["main", "unroll"])
def test_prof_decode_scan_tiny(capsys, set_name):
    res = prof_decode_scan.main(DECODE + ["--chain", "2", "--rounds", "1",
                                          "--set", set_name])
    lines = capsys.readouterr().out.splitlines()
    names = list(prof_decode_scan.SETS[set_name])
    assert list(res) == names
    for name in names:
        (ln,) = [x for x in lines if x.startswith(f"{name:19s}: ")]
        unroll = prof_decode_scan.SETS[set_name][name][2]
        if unroll is not None:       # every U<n> row printed, none timed
            assert res[name] is None and "n/a on the port" in ln
            continue
        _finite(ln)
        assert "% of 3.35 TB/s)" in ln and "device:" not in ln
        quant = "int8" in name
        assert res[name]["nbytes"] == 2 * 2 * 512 * 2 * (
            32 + 4 if quant else 32 * 2)
    if set_name == "unroll":
        assert all(r is None for r in res.values())


def test_prof_decode_int8_tiny(capsys):
    res = prof_decode_int8.main(DECODE + ["--rounds", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert list(res) == list(prof_decode_int8.VARIANTS)
    assert len([x for x in lines if re.match(r"  r[01] ", x)]) == 12
    best = lines[lines.index("== best-of rounds ==") + 1:]
    assert len(best) == 6
    for ln in best:
        _finite(ln)
    assert all(r["call_gbps"] > 0 for r in res.values())


def test_prof_int4_tiny(capsys):
    res = prof_int4.main(DECODE + ["--page-size", "128", "--chain", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "== decode int8 vs int4, ctx=512, ps=128 =="
    for kind, per_tok in (("int8", 2 * 512 * 2 * (32 + 4)),
                          ("int4", 2 * 512 * 2 * (16 + 4))):
        (ln,) = [x for x in lines if x.startswith(kind + ": ")]
        _finite(ln)
        assert res[kind]["nbytes"] == 2 * per_tok
    assert lines[-1].startswith("int4/int8 speedup: ")
    assert res["speedup"] == pytest.approx(
        res["int8"]["call_s"] / res["int4"]["call_s"])


def test_prof_decode_pagesize_tiny(capsys):
    res = prof_decode_pagesize.main(
        DECODE[:-2] + ["--ctx", "256", "--chain", "2", "--page-sizes", "64",
                       "128", "256"])
    lines = capsys.readouterr().out.splitlines()
    assert sorted(res) == [64, 128, 256]
    for ps in (64, 128, 256):
        (ln,) = [x for x in lines if f"ps={ps:4d}:" in x]
        assert ln.startswith("decode b2 ctx256 ")
        _finite(ln)
        assert res[ps]["nbytes"] == 2 * 2 * 256 * 2 * 32 * 2


def test_device_busy_reader(tmp_path):
    """common.device_busy_us is the union of the device lane's intervals;
    common.device_lane refuses a card's trace with no device lane (the
    profiler's CPU ops would read as device time) and passes a CPU
    run's."""
    import json

    from flash_attn_v100_tpu_torch.benchmarks import common
    k = [dict(ph="X", cat="kernel", name="K", ts=t, dur=d)
         for t, d in ((0, 10), (5, 10), (30, 5), (31, 1))]
    cpu = [dict(ph="X", cat="cpu_op", name="aten::mm", ts=0, dur=50)]
    assert common.device_busy_us(k) == 20.0
    for name, events in (("gpu", k + cpu), ("cpu", cpu)):
        d = tmp_path / name
        d.mkdir()
        (d / "trace.json").write_text(json.dumps({"traceEvents": events}))
    assert len(common.device_lane(str(tmp_path / "gpu"),
                                  torch.device("cuda"))) == 4
    assert common.device_lane(str(tmp_path / "cpu"),
                              torch.device("cpu")) == cpu
    with pytest.raises(RuntimeError, match="no device lane"):
        common.device_lane(str(tmp_path / "cpu"), torch.device("cuda"))
