"""P4: int4 operands in the tensor cores (`csrc/probe_int4.cu`) and the plain
twins.

The TPU probe (the JAX repository's `benchmarks/prof_int4_native.py`) asks
whether the chip multiplies packed int4 operands natively: an int4 x int4
and an int8 x int4 product to int32.  On the H100 the answer is no (the
tensor cores reach the int8 rate only through wgmma, which takes no s4
operand), so both kernels unpack the nibbles to int8 in shared memory and
multiply on wgmma m64n128k32 .s8.s8, fed by TMA through a warp-specialised
ring:

  * `int4_matmul(a, b)`: both operands packed int4, both unpacked;
  * `int8_int4_matmul(a, b)`: a int8 (read by the tensor cores as TMA
    brings it), b packed int4 and unpacked, as the quantized decode and
    prefill kernels treat int4 pools;

both C (M, N) int32 = A (M, K) . B (N, K)^T, exact.  On the card M and N
are multiples of 8 and K of 32 (`M_MULTIPLE`, `N_MULTIPLE`, `K_MULTIPLE`:
a packed row of K / 2 bytes must be a whole number of TMA's 16-byte
steps), and a and b start on 16-byte boundaries (`TMA_ALIGN`);
`check_operands` raises on anything else, on any device.  The packing
(`pack_int4` / `unpack_int4`) is two's-complement nibbles along the
contraction axis, the lower k in the low nibble; it is not the int4 KV
pools' format (`ops/quant.py`: tokens paired, the low nibble biased by 8).
The twins compute in fp32, exact while |C| < 2**24 (K * 64 < 2**24 for
values in [-8, 8)).

CUDA tensors go to the kernels, CPU tensors to the twins;
`int4_matmul.launches` / `int8_int4_matmul.launches` count launches.
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path
from typing import Dict

import torch

from flash_attn_v100_tpu_torch.ops.cuda import build

M_MULTIPLE = N_MULTIPLE = 8   # the kernels' shape multiples
K_MULTIPLE = 32
TMA_ALIGN = 16        # bytes: where a and b must start
KIND_INT4, KIND_INT8 = 0, 1


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """int values in [-8, 7] (..., K), K even -> uint8 (..., K / 2): value
    2j in the low nibble of byte j, 2j + 1 in the high one."""
    if x.shape[-1] % 2:
        raise ValueError("pack_int4: the last dim must be even")
    if x.numel() and (int(x.min()) < -8 or int(x.max()) > 7):
        raise ValueError("pack_int4: values must lie in [-8, 7]")
    n = x.to(torch.int16) & 0xF
    return (n[..., 0::2] | (n[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 (..., K / 2) -> int8 (..., K), the inverse of `pack_int4`."""
    p = p.to(torch.int16)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    both = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                  2 * p.shape[-1])
    return torch.where(both >= 8, both - 16, both).to(torch.int8)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) . b (N, K)^T in fp32 (exact for these ranges) -> int32."""
    if a.shape[-1] * 64 >= 2 ** 24:
        raise ValueError("the fp32 twin is exact only while K * 64 < 2**24")
    return torch.matmul(a.to(torch.float32),
                        b.to(torch.float32).t()).to(torch.int32)


def int4_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of `int4_matmul`: unpack both, multiply."""
    int4_matmul_ref.calls += 1
    return _product(unpack_int4(a), unpack_int4(b))


int4_matmul_ref.calls = 0


def int8_int4_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of `int8_int4_matmul`: unpack b, multiply."""
    int8_int4_matmul_ref.calls += 1
    return _product(a, unpack_int4(b))


int8_int4_matmul_ref.calls = 0


def check_operands(kind: int, a: torch.Tensor, b: torch.Tensor,
                   what: str) -> int:
    """Raise unless (a, b) is what kernel `kind` takes: a uint8 (M, K / 2)
    (kind 0) or int8 (M, K) (kind 1), b uint8 (N, K / 2), on one device,
    M and N multiples of 8, K of 32, both starting 16-byte aligned (the
    TMA maps' base).  Returns K."""
    want_a = torch.uint8 if kind == KIND_INT4 else torch.int8
    if a.dtype != want_a or b.dtype != torch.uint8:
        raise TypeError(f"{what}: a {want_a}, b uint8 (packed int4), got "
                        f"{a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{what}: a {tuple(a.shape)}, b {tuple(b.shape)}")
    K = 2 * a.shape[1] if kind == KIND_INT4 else a.shape[1]
    M, N = a.shape[0], b.shape[0]
    if b.shape[1] * 2 != K:
        raise ValueError(f"{what}: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if (M % M_MULTIPLE or N % N_MULTIPLE or K % K_MULTIPLE
            or not (M and N and K)):
        raise ValueError(f"{what}: M {M}, N {N} must be positive multiples "
                         f"of {M_MULTIPLE}, K {K} of {K_MULTIPLE}")
    if b.device != a.device:
        raise ValueError(f"{what}: a and b on one device")
    for name, t in (("a", a), ("b", b)):
        if t.is_contiguous() and t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{what}: {name} must start {TMA_ALIGN}-byte "
                             "aligned (TMA)")
    return K


def _launch(kind: int, a: torch.Tensor, b: torch.Tensor,
            what: str) -> torch.Tensor:
    K = check_operands(kind, a, b, what)
    a, b = a.contiguous(), b.contiguous()
    M, N = a.shape[0], b.shape[0]
    c = torch.empty((M, N), dtype=torch.int32, device=a.device)
    rc = build.load("probe_int4").fa_int4_mma_launch(
        kind, a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(rc, what)
    return c


def int4_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K / 2), b (N, K / 2) packed int4 -> int32 (M, N) = A B^T."""
    if a.device.type == "cpu":
        return int4_matmul_ref(a, b)
    c = _launch(KIND_INT4, a, b, "int4_matmul")
    int4_matmul.launches += 1
    return c


int4_matmul.launches = 0


def int8_int4_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8, b (N, K / 2) packed int4 -> int32 (M, N) = A B^T."""
    if a.device.type == "cpu":
        return int8_int4_matmul_ref(a, b)
    c = _launch(KIND_INT8, a, b, "int8_int4_matmul")
    int8_int4_matmul.launches += 1
    return c


int8_int4_matmul.launches = 0


def work(M: int, N: int, K: int, a_bits: int) -> tuple:
    """(operations, bytes) of one product: 2 M N K; A at `a_bits` a value
    and B at 4 read once, C int32 written once."""
    return 2 * M * N * K, M * K * a_bits // 8 + N * K // 2 + 4 * M * N


_FUNC = re.compile(r"Function : \S*int4_gemm_kernelILi(\d)E")
_IGMMA = re.compile(r"\bIGMMA\.(\S+)")
_IMMA = re.compile(r"\bIMMA\.(\S+)")


def parse_sass_counts(sass: str) -> Dict[int, Dict[str, int]]:
    """{kind: counts} from `cuobjdump -sass` text of the probe_int4
    library: `igmma_s8` (integer wgmma on two int8 operands, SASS
    IGMMA...S8.S8), `igmma` (every IGMMA) and `imma` (mma.sync's IMMA)
    instructions of each kernel."""
    counts: Dict[int, Dict[str, int]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = counts.setdefault(int(m.group(1)), dict(
                igmma_s8=0, igmma=0, imma=0))
            continue
        if cur is None:
            continue
        g = _IGMMA.search(line)
        if g:
            cur["igmma"] += 1
            cur["igmma_s8"] += "S8.S8" in g.group(1)
        elif _IMMA.search(line):
            cur["imma"] += 1
    return counts


def sass_counts() -> Dict[int, Dict[str, int]]:
    """The library's per-kernel counts (`cuobjdump -sass` beside the
    build's nvcc)."""
    path = build.library_path("probe_int4")
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(path)], check=True,
                         capture_output=True, text=True, timeout=300)
    return parse_sass_counts(out.stdout)
