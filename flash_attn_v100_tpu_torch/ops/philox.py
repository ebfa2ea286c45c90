"""Counter-based Philox-4x32-10 and the position-keyed dropout bits, plain
PyTorch, bit-equal to flash_attn_v100_tpu/ops/philox.py.

Keying (the contract the kernels replay, csrc/philox.cuh is the device
copy): one full Philox word per ROW and one per COLUMN of a (batch, head)
slice,
    a = philox(row, bh, 0x524F5753, 0; seed_lo, seed_hi).x
    b = philox(col, bh, 0x434F4C53, 1; seed_lo, seed_hi).x
combined per element by x = a ^ b and the one-multiply finalizer
    x ^= x >> 16;  x = x * 0x7FEB352D mod 2^32;  x ^= x >> 15
and kept where x <= keep_threshold(p).  Rows and columns are ABSOLUTE
positions, so any tiling replays the same mask.

Torch has little uint32 arithmetic on the CPU, so every word is an int64
tensor holding a value in [0, 2^32), masked with 0xFFFFFFFF after each
operation.  A full 32 x 32-bit product can exceed 2^63 and overflow signed
int64, so products are taken in 16-bit halves, as the JAX package does.
"""

from __future__ import annotations

from typing import Tuple

import torch

PHILOX_M_A = 0xD2511F53
PHILOX_M_B = 0xCD9E8D57
KEY_STEP_A = 0x9E3779B9
KEY_STEP_B = 0xBB67AE85
ROW_DOMAIN = 0x524F5753
COL_DOMAIN = 0x434F4C53
FINALIZER_MUL = 0x7FEB352D

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _u32(x, like: torch.Tensor = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    dev = None if like is None else like.device
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=dev)


def _mulhilo32(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low32, high32) of the 64-bit product of the constant `a` and the
    words `b`, from 16-bit halves."""
    a_lo, a_hi = a & _M16, a >> 16
    b_lo, b_hi = b & _M16, b >> 16
    lo_lo = a_lo * b_lo
    hi_lo = a_hi * b_lo
    lo_hi = a_lo * b_hi
    hi_hi = a_hi * b_hi
    lo = (lo_lo + ((hi_lo + lo_hi) << 16)) & _M32
    carry = (lo_lo >> 16) + (hi_lo & _M16) + (lo_hi & _M16)
    hi = (hi_hi + (hi_lo >> 16) + (lo_hi >> 16) + (carry >> 16)) & _M32
    return lo, hi


def _mullo32(a: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of the words `a` times the constant `c`."""
    c_lo, c_hi = c & _M16, (c >> 16) & _M16
    a_lo, a_hi = a & _M16, a >> 16
    return (a_lo * c_lo + ((a_hi * c_lo + a_lo * c_hi) << 16)) & _M32


def philox_4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox-4x32 with `rounds` rounds on broadcastable uint32 words (int64
    tensors or ints).  Returns the four output words."""
    ref = next((x for x in (c0, c1, c2, c3, k0, k1)
                if isinstance(x, torch.Tensor)), None)
    c0, c1, c2, c3, k0, k1 = (_u32(x, ref) for x in (c0, c1, c2, c3, k0, k1))
    for _ in range(rounds):
        lo0, hi0 = _mulhilo32(PHILOX_M_A, c0)
        lo1, hi1 = _mulhilo32(PHILOX_M_B, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + KEY_STEP_A) & _M32
        k1 = (k1 + KEY_STEP_B) & _M32
    return c0, c1, c2, c3


def split_seed(seed: int) -> Tuple[int, int]:
    """64-bit integer seed -> (lo32, hi32)."""
    seed = int(seed)
    return seed & _M32, (seed >> 32) & _M32


def keep_threshold(p_drop: float) -> int:
    """T such that keep <=> word <= T, P(keep) = 1 - p_drop."""
    t = int(round((1.0 - float(p_drop)) * 4294967295.0))
    return max(0, min(t, _M32))


def dropout_keep_bits(row_ids, col_ids, bh_id, seed_lo, seed_hi) -> torch.Tensor:
    """The random word of every (row, col) element, as int64 in [0, 2^32).
    `row_ids`/`col_ids` are absolute positions, best passed as broadcastable
    vectors ((R, 1) and (1, C)); `bh_id` is batch * num_heads + head."""
    a = philox_4x32(row_ids, bh_id, ROW_DOMAIN, 0, seed_lo, seed_hi)[0]
    b = philox_4x32(col_ids, bh_id, COL_DOMAIN, 1, seed_lo, seed_hi)[0]
    x = a ^ b
    x = x ^ (x >> 16)
    x = _mullo32(x, FINALIZER_MUL)
    return x ^ (x >> 15)


def dropout_keep_mask(row_ids, col_ids, bh_id, seed_lo, seed_hi,
                      p_drop: float) -> torch.Tensor:
    """Boolean keep mask at absolute positions."""
    bits = dropout_keep_bits(row_ids, col_ids, bh_id, seed_lo, seed_hi)
    return bits <= keep_threshold(p_drop)
