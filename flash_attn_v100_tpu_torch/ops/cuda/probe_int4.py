"""P4: int4 operands in the tensor cores (`csrc/probe_int4.cu`) and the plain
twins.

The TPU probe (the JAX repository's `benchmarks/prof_int4_native.py`) asks
whether the chip multiplies packed int4 operands natively: an int4 x int4
and an int8 x int4 product to int32.  Here

  * `int4_matmul(a, b)`: both operands packed int4, `mma.sync` m16n8k64
    .s4.s4 on the card;
  * `int8_int4_matmul(a, b)`: a int8, b packed int4, b's nibbles unpacked
    to int8 in shared memory and multiplied on m16n8k32 .s8.s8, as the
    quantized decode and prefill kernels treat int4 pools;

both C (M, N) int32 = A (M, K) . B (N, K)^T, exact, M, N and K multiples
of 128 on the card.  The packing (`pack_int4` / `unpack_int4`) is two's-
complement nibbles along the contraction axis, the lower k in the low
nibble; it is not the int4 KV pools' format (`ops/quant.py`: tokens
paired, the low nibble biased by 8).  The twins compute in fp32, exact
while |C| < 2**24 (K * 64 < 2**24 for values in [-8, 8)).

CUDA tensors go to the kernels, CPU tensors to the twins;
`int4_matmul.launches` / `int8_int4_matmul.launches` count launches.
"""

from __future__ import annotations

import torch

from flash_attn_v100_tpu_torch.ops.cuda import build

TILE = 128            # M, N, K multiples on the card
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


def _launch(kind: int, a: torch.Tensor, b: torch.Tensor, K: int,
            what: str) -> torch.Tensor:
    M, N = a.shape[0], b.shape[0]
    want_a = torch.uint8 if kind == KIND_INT4 else torch.int8
    if a.dtype != want_a or b.dtype != torch.uint8:
        raise TypeError(f"{what}: a {want_a}, b uint8 (packed int4), got "
                        f"{a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or b.shape[1] * 2 != K:
        raise ValueError(f"{what}: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if M % TILE or N % TILE or K % TILE or not (M and N and K):
        raise ValueError(f"{what}: M {M}, N {N}, K {K} must be positive "
                         f"multiples of {TILE}")
    if b.device != a.device:
        raise ValueError(f"{what}: a and b on one device")
    a, b = a.contiguous(), b.contiguous()
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
    c = _launch(KIND_INT4, a, b, 2 * a.shape[1], "int4_matmul")
    int4_matmul.launches += 1
    return c


int4_matmul.launches = 0


def int8_int4_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8, b (N, K / 2) packed int4 -> int32 (M, N) = A B^T."""
    if a.device.type == "cpu":
        return int8_int4_matmul_ref(a, b)
    c = _launch(KIND_INT8, a, b, a.shape[1], "int8_int4_matmul")
    int8_int4_matmul.launches += 1
    return c


int8_int4_matmul.launches = 0


def work(M: int, N: int, K: int, a_bits: int) -> tuple:
    """(operations, bytes) of one product: 2 M N K; A at `a_bits` a value
    and B at 4 read once, C int32 written once."""
    return 2 * M * N * K, M * K * a_bits // 8 + N * K // 2 + 4 * M * N
