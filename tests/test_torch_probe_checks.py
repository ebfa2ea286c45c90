"""The probe kernels' operand checks on the CPU: what the TMA pipelines of
csrc/probe_int4.cu (P4) and csrc/probes.cu (P1-P3) cannot take raises in
the wrappers before any launch (`probe_int4.check_operands`,
`probes._check`: shape multiples, dtypes, the 16-byte alignment TMA needs
of every operand it loads), and the P4 SASS counter reads the integer
wgmma and mma.sync instructions of each kernel."""

import pytest
import torch

from flash_attn_v100_tpu_torch.ops.cuda import probe_int4 as p4
from flash_attn_v100_tpu_torch.ops.cuda import probes

torch.set_num_threads(1)


def _misaligned(shape, dtype, offset):
    """A contiguous tensor of `shape` starting `offset` elements into a
    fresh (aligned) buffer."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 64, dtype=dtype)[offset:offset + n].view(shape)


def _int4_operands(M, N, K, kind):
    a = (torch.zeros((M, K // 2), dtype=torch.uint8) if kind == p4.KIND_INT4
         else torch.zeros((M, K), dtype=torch.int8))
    return a, torch.zeros((N, K // 2), dtype=torch.uint8)


@pytest.mark.parametrize("kind", [p4.KIND_INT4, p4.KIND_INT8])
@pytest.mark.parametrize("MNK", [(8, 8, 32), (136, 72, 96), (256, 384, 640),
                                 (4096, 4096, 4096)],
                         ids=lambda m: "x".join(map(str, m)))
def test_int4_checks_take_the_kernels_multiples(kind, MNK):
    M, N, K = MNK
    a, b = _int4_operands(M, N, K, kind)
    assert p4.check_operands(kind, a, b, "p4") == K


@pytest.mark.parametrize("kind", [p4.KIND_INT4, p4.KIND_INT8])
@pytest.mark.parametrize("MNK", [(12, 8, 32), (8, 20, 32), (8, 8, 48),
                                 (0, 8, 32), (8, 8, 16)],
                         ids=lambda m: "x".join(map(str, m)))
def test_int4_checks_raise_off_the_multiples(kind, MNK):
    M, N, K = MNK
    a, b = _int4_operands(M, N, K, kind)
    with pytest.raises(ValueError, match="multiples of 8, K .* of 32"):
        p4.check_operands(kind, a, b, "p4")


@pytest.mark.parametrize("kind", [p4.KIND_INT4, p4.KIND_INT8])
@pytest.mark.parametrize("which", ["a", "b"])
@pytest.mark.parametrize("offset", [1, 8])
def test_int4_checks_raise_off_tma_alignment(kind, which, offset):
    a, b = _int4_operands(128, 128, 128, kind)
    if which == "a":
        a = _misaligned(a.shape, a.dtype, offset)
    else:
        b = _misaligned(b.shape, b.dtype, offset)
    assert a.is_contiguous() and b.is_contiguous()
    with pytest.raises(ValueError, match=f"{which} must start 16-byte"):
        p4.check_operands(kind, a, b, "p4")
    # 16 bytes on is aligned again
    a16, b16 = _int4_operands(128, 128, 128, kind)
    if which == "a":
        a16 = _misaligned(a16.shape, a16.dtype, 16)
    else:
        b16 = _misaligned(b16.shape, b16.dtype, 16)
    assert p4.check_operands(kind, a16, b16, "p4") == 128


def test_int4_checks_raise_on_dtype_and_mismatched_k():
    a, b = _int4_operands(128, 128, 128, p4.KIND_INT8)
    with pytest.raises(TypeError, match="int8"):
        p4.check_operands(p4.KIND_INT8, a.to(torch.uint8), b, "p4")
    with pytest.raises(TypeError, match="uint8"):
        p4.check_operands(p4.KIND_INT4, a, b, "p4")
    with pytest.raises(ValueError, match="b \\(128, 32\\)"):
        p4.check_operands(p4.KIND_INT8, a, b[:, :32], "p4")


def test_int4_parse_sass_counts():
    sass = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_116int4_gemm_kernelILi1EEEv14CU"
        "tensorMap_stS1_Piiii",
        "        /*0a70*/   IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], RZ ;",
        "        /*0a80*/   IGMMA.64x128x32.S8.S8 R88, gdesc[UR8], R88 ;",
        "        /*0a90*/   IMAD R3, R4, R5, RZ ;",
        "\t\tFunction : _ZN12_GLOBAL__N_116int4_gemm_kernelILi0EEEv14CU"
        "tensorMap_stS1_Piiii",
        "        /*0a70*/   IMMA.16832.S8.S8 R24, R4, R8, R24 ;",
        "        /*0a80*/   IGMMA.64x128x32.U8.S8 R24, gdesc[UR4], R24 ;",
    ])
    assert p4.parse_sass_counts(sass) == {
        1: dict(igmma_s8=2, igmma=2, imma=0),
        0: dict(igmma_s8=0, igmma=1, imma=1)}


def _probe_operands(BH=2, BHk=1, M=128, N=128):
    return [torch.zeros((h, n, probes.HEAD_DIM), dtype=torch.bfloat16)
            for h, n in ((BH, M), (BHk, N), (BHk, N))]


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_probe_checks_raise_off_tma_alignment(which):
    probe = probes.P2_VARIANTS["minimal 3d rect"]
    ops = dict(zip("qkv", _probe_operands()))
    probes._check(ops["q"], ops["k"], ops["v"], probe)
    ops[which] = _misaligned(ops[which].shape, torch.bfloat16, 1)
    with pytest.raises(ValueError, match=f"{which} must start 16-byte"):
        probes._check(ops["q"], ops["k"], ops["v"], probe)


def test_probe_checks_raise_on_misaligned_bulk_copied_streams():
    """The k-side and k segment words travel by cp.async.bulk: 16-byte
    aligned starts; the q-side ones are read by plain loads and may sit
    anywhere."""
    q, k, v = _probe_operands()
    ok = torch.zeros(128, dtype=torch.int32)
    off = _misaligned((128,), torch.int32, 1)
    probe = probes.P3_VARIANTS["2 k-side (1,BK)"]
    probes._check(q, k, v, probe, kside=[ok, ok])
    with pytest.raises(ValueError, match="k-side stream 1 must start"):
        probes._check(q, k, v, probe, kside=[ok, off])
    branches = probes.P3_VARIANTS["seg-reduce + 3 branches"]
    with pytest.raises(ValueError, match="kseg must start"):
        probes._check(q, k, v, branches, kseg=off)


@pytest.mark.parametrize("shape", [(2, 100, 1, 128), (2, 128, 1, 96),
                                   (3, 128, 2, 128)],
                         ids=["M", "N", "heads"])
def test_probe_checks_raise_off_the_tiles(shape):
    BH, M, BHk, N = shape
    q, k, v = _probe_operands(BH, BHk, M, N)
    with pytest.raises(ValueError, match="multiple of 128"):
        probes._check(q, k, v, probes.P2_VARIANTS["minimal 3d rect"])
