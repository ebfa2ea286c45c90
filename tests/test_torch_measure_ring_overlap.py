"""check_ring_overlap (flash_attn_v100_tpu_torch/benchmarks/
check_ring_overlap.py): its overlap detector on synthetic shift windows
and kernel intervals, overlapped and not; the windows read back from
profiler annotations; the device-lane and K1 counts that decide whether
the ranks trace again; its verdict over ranks; its ratio() against the
JAX script's own formula (the nested `ratio` of benchmarks/
check_ring_overlap.py, run as it stands, at ICI's and at NVLink's rate);
and the script on 2 gloo CPU ranks, where it finds each rank's shift but,
with no device lane, makes no claim."""

import pytest
import torch
from torch_script_flags import JAX, function_source

from flash_attn_v100_tpu_torch.benchmarks import check_ring_overlap as co

torch.set_num_threads(1)


def test_detector_on_synthetic_intervals():
    windows = {0: (100.0, 900.0), 1: (1000.0, 1500.0)}
    over = {0: (150.0, 400.0), 1: (1490.0, 1700.0)}
    assert co.overlapped(windows, over) == {0: True, 1: True}
    # a kernel that starts after the transfer's wait returned, or ends
    # before the shift was posted, ran without a transfer in flight
    late = {0: (900.0, 950.0), 1: (500.0, 999.0)}
    assert co.overlapped(windows, late) == {0: False, 1: False}
    # a step with no chunk kernel is not judged
    assert co.overlapped(windows, {1: (1100.0, 1200.0)}) == {1: True}


def test_verdict():
    good = [dict(overlap={0: True}), dict(overlap={0: True})]
    assert co.verdict(good, 2) == (2, 2, True)
    bad = [dict(overlap={0: True}), dict(overlap={0: False})]
    assert co.verdict(bad, 2) == (2, 1, False)
    # the last rank must show all n - 1 of its steps
    missing = [dict(overlap={0: True}), dict(overlap={}),
               dict(overlap={0: True})]
    assert co.verdict(missing, 3)[2] is False
    assert co.chunk_steps(0, 4) == [0] and co.chunk_steps(3, 4) == [0, 1, 2,
                                                                     3]


def test_windows_from_annotations():
    ev = [dict(cat="user_annotation", name="ring_shift 0", ts=10, dur=5),
          dict(cat="user_annotation", name="ring_shift 0 wait", ts=40,
               dur=20),
          dict(cat="user_annotation", name="ring_shift 0 wait", ts=30, dur=2),
          dict(cat="user_annotation", name="ring_shift 1", ts=100, dur=1),
          dict(cat="gpu_user_annotation", name="ring_shift 1 wait", ts=0,
               dur=1),
          dict(cat="kernel", name="ring_shift 2", ts=0, dur=1)]
    assert co.step_windows(ev) == {0: (15.0, 60.0)}


def test_chunk_kernels_take_k1_in_order():
    k1 = ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, 128, 0, "
          "0, 0>(FwdArgs)")
    ev = [dict(cat="kernel", name=k1, ts=50, dur=5),
          dict(cat="kernel", name="elementwise", ts=10, dur=1),
          dict(cat="kernel", name=k1, ts=20, dur=5),
          dict(cat="cpu_op", name=k1, ts=0, dur=1)]
    assert co.chunk_kernels(ev, [0, 1]) == {0: (20.0, 25.0), 1: (50.0, 55.0)}


def test_lane_counts_read_the_device_lane_and_its_k1s():
    k1 = ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, 128, 0, "
          "0, 0>(FwdArgs)")
    ev = [dict(cat="kernel", name=k1, ts=50, dur=5),
          dict(cat="kernel", name="elementwise", ts=10, dur=1),
          dict(cat="gpu_memcpy", name="Memcpy DtoH", ts=0, dur=1),
          dict(cat="cpu_op", name=k1, ts=0, dur=1),
          dict(cat="user_annotation", name="ring_shift 0", ts=0, dur=1)]
    assert co.lane_counts(ev) == (3, 1)
    # a trace with CPU ops only: no lane, so no K1 (the ranks trace again)
    assert co.lane_counts(ev[3:]) == (0, 0)


@pytest.mark.parametrize("shape", [(1, 8192, 4, 4, 128, 8),
                                   (1, 32768, 32, 8, 128, 8),
                                   (2, 4096, 16, 2, 64, 4)])
def test_ratio_is_the_jax_formula(shape):
    for link, rate in ((45e9, 94e12), (co.NVLINK_BYTES_PER_S, 400e12)):
        ns = dict(ICI_GBS=link, KERNEL_TFS=rate)
        exec(function_source(JAX / "check_ring_overlap.py", "ratio"), ns)
        assert co.ratio(*shape, link, rate) == pytest.approx(
            ns["ratio"](*shape), rel=1e-12)


def test_two_cpu_ranks(capsys):
    res = co.main(["--device", "cpu", "--ranks", "2", "--seqlen", "256",
                   "--rate-seqlen", "128"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "card: cpu"
    # each rank shifted once (step 0), and its window closed after it opened
    assert [sorted(r["windows"]) for r in res["ranks"]] == [[0], [0]]
    for r in res["ranks"]:
        a, b = r["windows"][0]
        assert a <= b
    assert res["ok"] is None
    # a CPU run has no device lane to wait for: one traced call a rank
    assert [len(r["attempts"]) for r in res["ranks"]] == [1, 1]
    assert "ring overlap check: n/a (a CPU run has no device lane)" in lines
    assert res["k1_flops_per_s"] > 0
    assert any(ln.startswith("realistic 32k/8-card llama shape: ")
               for ln in lines)
