"""P1-P3: the flash-step cost probes (`csrc/probes.cu`) and their plain twin.

The TPU probes of the JAX repository's benchmark folder
(`prof_softmax_cost.py`, `prof_fwd_gap.py`, `prof_small_streams.py`) time
a minimal flash-attention forward step with one feature toggled at a time.
Here each variant is one instantiation of a templated CUDA kernel on K1's
tile shape at D 128 (two warpgroups, 128 q rows a block, 64 keys a step,
wgmma products, a two-stage cp.async ring), named by a `Probe` and its
`flags`; `flash_step` launches it and `flash_step_ref` is its plain
PyTorch version.  bf16 in, D 128.

The function (per q row, over key tiles of `bk` keys; the kernel's bk is
64, 128 for the wide variant):

    m = -1e30, l = 0, acc = 0
    per tile: s = fp32(q k^T) * scale [+ (sum of the side streams) * 0.0]
      max      m' = max(m, rowmax s); alpha = exp2(m - m'); m = m'
               (else m stays -1e30, alpha = 1)
      exp      p = exp2(s - m)            (else p = s)
      bf16exp  p = bf16(exp2(bf16(s - m)))
      sum      l = alpha l + rowsum p
      pv       acc = alpha acc + bf16(p) v   (fp32 products)
    out = bf16(acc), or with `lse`: bf16(acc * where(l == 0, 0, 1 / l))
          and lse = where(l == 0, -inf, m * 0.6931 + log l)

Without "max", "exp" gives exp2(s + 1e30) = inf and the output is NaN;
without "exp", the rescale multiplies raw scores, so the result depends
on `bk`: the twin takes it as a parameter (the TPU kernels' 1024, the
kernel's 64).  `pairs` walks a (4, T) table (qi, ki, first, last) as the
TPU prefetch grid does; `branches` reduces the q block's (`bq` rows) and
the key tile's segment words and skips a tile with no overlap (with the
kernel's P = 0, alpha = 1).  In the bf16exp variant the twin rounds the
row sum of the bf16 p to bf16 as the TPU kernel's `jnp.sum` does (l is no
output of that variant); JAX lowers exp2 of a bf16 array as
exp(x * bf16(ln 2)) with a bf16 product (`lax.exp2`), up to ~4% off
2**x, and `bf16_exp2="lax"` has the twin do the same, for the comparison
with the TPU kernel (the CUDA kernel's ex2.bf16x2 approximates 2**x).

The wrappers take CUDA tensors to the kernel and CPU tensors to the twin;
`flash_step.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from flash_attn_v100_tpu_torch.ops.cuda import build

LOG2E = 1.4426950408889634
SCALE = 0.0883883              # P1's score scale (exp2 of the raw scale)
SCALE_LOG2 = 0.0883883 * LOG2E  # P2's and P3's
NEG_INIT = -1e30
LN2_PROBE = 0.6931             # the TPU probes' LSE constant
_LN2_BF16 = float(torch.tensor(0.6931471805599453).to(torch.bfloat16))
HEAD_DIM = 128
BLOCK_Q = 128                  # q rows a block
STAGES = ("max", "exp", "bf16exp", "sum", "pv")
FULL = ("max", "exp", "sum", "pv")

_STAGE_BITS = {"max": 1, "exp": 2, "bf16exp": 4, "sum": 8, "pv": 16}
_LSE, _PAIRS, _STRIDED = 32, 64, 128
_QSIDE, _KSIDE = 8, 10
_DYNAMIC, _BRANCHES, _WIDE = 1 << 12, 1 << 13, 1 << 14


@dataclass(frozen=True)
class Probe:
    """One variant: its stages and the features it adds to the step."""
    stages: Tuple[str, ...] = FULL
    lse: bool = False
    pairs: bool = False
    strided: bool = False
    n_qside: int = 0
    n_kside: int = 0
    dynamic: bool = False
    branches: bool = False
    wide: bool = False

    @property
    def flags(self) -> int:
        f = sum(_STAGE_BITS[s] for s in self.stages)
        f |= (_LSE * self.lse | _PAIRS * self.pairs | _STRIDED * self.strided
              | _DYNAMIC * self.dynamic | _BRANCHES * self.branches
              | _WIDE * self.wide)
        return f | self.n_qside << _QSIDE | self.n_kside << _KSIDE

    @property
    def bk(self) -> int:
        """Keys a step of the kernel."""
        return 128 if self.wide else 64

    @property
    def full(self) -> bool:
        """Computes every stage (attention's function, unnormalised unless
        `lse`)."""
        return set(FULL) <= set(self.stages)


# name -> variant, as the TPU scripts name them
P1_VARIANTS: Dict[str, Probe] = {
    "qk only": Probe(stages=()),
    "qk+pv": Probe(stages=("pv",)),
    "qk+max+pv": Probe(stages=("max", "pv")),
    "qk+exp+pv": Probe(stages=("exp", "pv")),
    "qk+max+exp+pv": Probe(stages=("max", "exp", "pv")),
    "full (max+exp+sum+pv)": Probe(),
    "bf16 exp variant": Probe(stages=("max", "bf16exp", "sum", "pv")),
    # kernel2: a step over twice the keys (TPU: 2048 keys as two 1024-key
    # sub-tiles; here 128 keys, one online update)
    "2048-kv, 2 sub-tiles": Probe(wide=True),
}
P2_VARIANTS: Dict[str, Probe] = {
    "minimal 3d rect": Probe(),
    "+lse": Probe(lse=True),
    "+prefetch pairs": Probe(lse=True, pairs=True),
    "4d layout (prod-like)": Probe(lse=True, strided=True),
}
P3_VARIANTS: Dict[str, Probe] = {
    "no side streams": Probe(),
    "2 k-side (1,BK)": Probe(n_kside=2),
    "3 q-side (BQ,1)": Probe(n_qside=3),
    "3 q-side + 2 k-side": Probe(n_qside=3, n_kside=2),
    "dynamic inner grid": Probe(dynamic=True),
    "seg-reduce + 3 branches": Probe(branches=True),
}
VARIANT_FLAGS = tuple(sorted({p.flags for d in (P1_VARIANTS, P2_VARIANTS,
                                                P3_VARIANTS)
                              for p in d.values()}))


def rect_pairs(n_q_tiles: int, n_k_tiles: int) -> np.ndarray:
    """The pair table (4, T) int32 of the rectangular (non-causal) grid:
    rows qi, ki, first, last, q tiles in order, each over every key tile
    (the TPU probe's `make_prefetch` table)."""
    qi = np.repeat(np.arange(n_q_tiles, dtype=np.int32), n_k_tiles)
    ki = np.tile(np.arange(n_k_tiles, dtype=np.int32), n_q_tiles)
    return np.stack([qi, ki, (ki == 0).astype(np.int32),
                     (ki == n_k_tiles - 1).astype(np.int32)])


def work(probe: Probe, BH: int, BHk: int, M: int, N: int) -> Tuple[int, int]:
    """(flops, bytes) one call must do and move: 2 D flops a (q row, key)
    pair for each product; q and out (bf16) at BH heads, k and v at BHk,
    the LSE (fp32), the int32 side and segment streams and the pair table
    once each."""
    flops = 2 * HEAD_DIM * BH * M * N * (1 + ("pv" in probe.stages))
    n = 2 * HEAD_DIM * (2 * BH * M + 2 * BHk * N)
    if probe.lse:
        n += 4 * BH * M
    n += 4 * (probe.n_qside * M + probe.n_kside * N)
    if probe.branches:
        n += 4 * (M + N)
    if probe.pairs:
        n += 4 * 4 * (M // BLOCK_Q) * (N // probe.bk)
    return flops, n


# ------------------------------------------------------------- the kernel

_device_cache: Dict[tuple, torch.Tensor] = {}


def _cached(key, make) -> torch.Tensor:
    t = _device_cache.get(key)
    if t is None:
        t = _device_cache[key] = make()
    return t


def _check(q, k, v, probe: Probe) -> None:
    nd = 4 if probe.strided else 3
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_step: {name} must be bf16, got {t.dtype}")
        if t.dim() != nd or t.shape[-1] != HEAD_DIM or t.stride(-1) != 1:
            raise ValueError(f"flash_step: {name} must be {nd}-D with a "
                             f"contiguous last dim of {HEAD_DIM}, got "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("flash_step: q, k, v on one device")
        if not probe.strided and not t.is_contiguous():
            raise ValueError(f"flash_step: {name} must be contiguous")
        if any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"flash_step: {name}'s rows must be 16-byte "
                             "aligned")
    if k.shape != v.shape or k.shape[:-3] != q.shape[:-3]:
        raise ValueError(f"flash_step: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} against q {tuple(q.shape)}")
    M, N = q.shape[-2], k.shape[-2]
    Hq, Hk = q.shape[-3], k.shape[-3]
    if Hq % Hk or M % BLOCK_Q or N % probe.bk or M == 0 or N == 0:
        raise ValueError(f"flash_step: heads {Hq}/{Hk} must divide, M {M} "
                         f"be a multiple of {BLOCK_Q} and N {N} of "
                         f"{probe.bk}")


def _streams(given, n: int, length: int, what: str):
    given = list(given or ())
    if len(given) != n:
        raise ValueError(f"flash_step: {n} {what} streams, got {len(given)}")
    for t in given:
        if t.dtype != torch.int32 or tuple(t.shape) != (length,):
            raise ValueError(f"flash_step: {what} streams are int32 "
                             f"({length},)")
    return given


def flash_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               probe: Probe, scale: float, *,
               qside: Sequence[torch.Tensor] = (),
               kside: Sequence[torch.Tensor] = (),
               qseg: Optional[torch.Tensor] = None,
               kseg: Optional[torch.Tensor] = None):
    """One probe call: q (BH, M, 128) against k/v (BHk, N, 128) bf16, or
    (B, Hq, M, 128) / (B, Hk, N, 128) under any row-aligned strides for a
    `strided` variant.  `qside` / `kside`: the variant's int32 (M,) / (N,)
    streams; `qseg` / `kseg`: a `branches` variant's segment words.
    Returns out (q's shape, bf16), and lse ((BH, M) or (B, Hq, M) fp32)
    when `probe.lse`.  CPU tensors take the plain twin at the kernel's
    tiles."""
    M, N = q.shape[-2], k.shape[-2]
    qside = _streams(qside, probe.n_qside, M, "q-side")
    kside = _streams(kside, probe.n_kside, N, "k-side")
    if probe.branches and (qseg is None or kseg is None):
        raise ValueError("flash_step: a branches variant needs qseg, kseg")
    if q.device.type == "cpu":
        pairs = (rect_pairs(M // BLOCK_Q, N // probe.bk) if probe.pairs
                 else None)
        return flash_step_ref(q, k, v, probe, scale, bk=probe.bk,
                              bq=BLOCK_Q, qside=qside, kside=kside,
                              qseg=qseg, kseg=kseg, pairs=pairs)
    _check(q, k, v, probe)
    if probe.flags not in VARIANT_FLAGS:
        raise ValueError(f"flash_step: no kernel instantiates {probe}")
    dev = q.device
    n_kt = N // probe.bk
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = (torch.empty(q.shape[:-1], dtype=torch.float32, device=dev)
           if probe.lse else None)
    if probe.strided:
        B, Hq, Hk = q.shape[0], q.shape[1], k.shape[1]
        ls = (lse.stride(0), lse.stride(1)) if lse is not None else (0, 0)
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   *out.stride()[:3], *ls)
    else:
        B, Hq, Hk = 1, q.shape[0], k.shape[0]
        strides = (0,) * 14
    arr = (ctypes.c_longlong * 14)(*strides)
    trip = pairs = None
    n_pairs = 0
    if probe.dynamic:
        trip = _cached(("trip", dev, n_kt), lambda: torch.tensor(
            [n_kt], dtype=torch.int32, device=dev))
    if probe.pairs:
        n_pairs = (M // BLOCK_Q) * n_kt
        pairs = _cached(("pairs", dev, M // BLOCK_Q, n_kt), lambda: (
            torch.from_numpy(rect_pairs(M // BLOCK_Q, n_kt)).to(dev)
            .contiguous()))

    def ptr(t):
        return None if t is None else t.data_ptr()

    qs = [ptr(t) for t in qside] + [None] * (3 - len(qside))
    ks = [ptr(t) for t in kside] + [None] * (3 - len(kside))
    rc = build.load("probes").fa_probe_launch(
        probe.flags, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), ptr(lse), ctypes.addressof(arr), B, Hq, Hk, M, N,
        n_kt, ptr(trip), ptr(pairs), n_pairs, *qs, *ks,
        ptr(qseg) if probe.branches else None,
        ptr(kseg) if probe.branches else None, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, f"flash_step {probe}")
    flash_step.launches += 1
    flash_step.variant_launches[probe.flags] = (
        flash_step.variant_launches.get(probe.flags, 0) + 1)
    return (out, lse) if probe.lse else out


flash_step.launches = 0
flash_step.variant_launches = {}   # flags -> launches of that instantiation


def occupancy(probe: Probe) -> Dict[str, int]:
    """Registers and local bytes a thread, shared bytes and resident
    blocks a multiprocessor of the variant's kernel."""
    out = (ctypes.c_int * 4)()
    build.check(build.load("probes").fa_probe_occupancy(
        probe.flags, ctypes.addressof(out)), "fa_probe_occupancy")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3])


# ------------------------------------------------------------ the SASS

_FUNC = re.compile(r"Function : \S*probe_kernelILi(\d+)E")
_HGMMA = re.compile(r"HGMMA\.\S+\s+[^,]+,\s*(\S+)")


def parse_sass_counts(sass: str) -> Dict[int, Dict[str, int]]:
    """{flags: counts} from `cuobjdump -sass` text of the probes library:
    `hgmma_ss` (S = Q K^T: both operands in shared memory), `hgmma_rs`
    (P V: A from registers) and `ex2` (MUFU.EX2) instructions of each
    instantiation."""
    counts: Dict[int, Dict[str, int]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = counts.setdefault(int(m.group(1)), dict(
                hgmma_ss=0, hgmma_rs=0, ex2=0))
            continue
        if cur is None:
            continue
        h = _HGMMA.search(line)
        if h:
            cur["hgmma_ss" if h.group(1).startswith("gdesc")
                else "hgmma_rs"] += 1
        elif "MUFU.EX2" in line:
            cur["ex2"] += 1
    return counts


def expected_hgmma(probe: Probe) -> Tuple[int, int]:
    """(ss, rs) wgmma counts the stages claim: S's D / 16 k-steps at two
    sites (the first step, the loop) and P V's bk / 16 at two (the loop,
    the last step) when the variant has "pv"."""
    return 2 * HEAD_DIM // 16, (2 * probe.bk // 16 if "pv" in probe.stages
                                else 0)


def expected_ex2(probe: Probe) -> int:
    """The fewest MUFU.EX2 instructions the stages claim: at each of the
    softmax's two sites (the first step, the loop), times three paths for
    `branches`, a thread's bk / 2 scores through exp or bf16exp and its two
    rows' rescale through max (ptxas may add a few)."""
    per_site = (probe.bk // 2 if {"exp", "bf16exp"} & set(probe.stages)
                else 0) + (2 if "max" in probe.stages else 0)
    return 2 * (3 if probe.branches else 1) * per_site


def sass_counts() -> Dict[int, Dict[str, int]]:
    """The probes library's per-instantiation counts (`cuobjdump -sass`
    beside the build's nvcc)."""
    path = build.library_path("probes")
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(path)], check=True,
                         capture_output=True, text=True, timeout=300)
    return parse_sass_counts(out.stdout)


# ------------------------------------------------------------- the gates

OUT_ULPS = 2          # out rows: 2 bf16 ulps of the row's largest |out|
LSE_RTOL = 1e-5


def _masks(a: torch.Tensor):
    return torch.isnan(a), a == float("inf"), a == float("-inf")


def compare(out, ref, lse=None, lse_ref=None) -> Dict[str, float]:
    """Hold a probe's outputs against the twin's: the NaN / +inf / -inf
    masks equal, each row's finite entries within OUT_ULPS bf16 ulps of
    the row's largest finite |ref| (ulp(x) = 2**(floor(log2 x) - 7)), the
    LSE within LSE_RTOL relatively.  Returns max_abs_err (out), the gate of
    its row, `ratio` (the largest row error over its row gate, 0 where
    both are 0; inf for a nonzero error against a zero gate), `lse_rel`,
    `masks_equal` and `ok`."""
    o, r = out.float(), ref.float()
    masks_equal = all(torch.equal(x, y) for x, y in zip(_masks(o),
                                                        _masks(r)))
    fin = torch.isfinite(r) & torch.isfinite(o)
    zero = torch.zeros_like(r)
    err = torch.where(fin, (o - r).abs(), zero).flatten(0, -2)
    top = torch.where(fin, r.abs(), zero).flatten(0, -2).amax(-1)
    ulp = torch.where(top > 0, torch.exp2(torch.floor(torch.log2(
        torch.where(top > 0, top, torch.ones_like(top)))) - 7), top)
    gate = OUT_ULPS * ulp
    row_err = err.amax(-1)
    ratio = torch.where(row_err == 0, torch.zeros_like(row_err),
                        row_err / gate)
    worst = int(ratio.argmax())
    res = dict(max_abs_err=float(row_err.max()), gate=float(gate[worst]),
               ratio=float(ratio.max()), masks_equal=bool(masks_equal),
               lse_rel=0.0)
    ok = masks_equal and res["ratio"] <= 1.0
    if lse is not None:
        lf, lr = lse.float(), lse_ref.float()
        lfin = torch.isfinite(lr)
        ok = ok and all(torch.equal(x, y) for x, y in zip(_masks(lf),
                                                          _masks(lr)))
        rel = ((lf - lr).abs() / lr.abs().clamp_min(1e-30))[lfin]
        res["lse_rel"] = float(rel.max()) if rel.numel() else 0.0
        ok = ok and res["lse_rel"] <= LSE_RTOL
    res["ok"] = bool(ok)
    return res


# ------------------------------------------------------------- the twin

def flash_step_ref(q, k, v, probe: Probe, scale: float, *, bk: int,
                   bq: int = BLOCK_Q, qside=(), kside=(), qseg=None,
                   kseg=None, pairs=None, bf16_exp2: str = "exact"):
    """Plain PyTorch version of the variant's function (module docstring)
    over key tiles of `bk` keys: fp32 scores from the bf16 inputs, p
    rounded to bf16 before P V, fp32 accumulation.  q (BH, M, D) against
    k/v (BHk, N, D), or 4-D when `probe.strided`.  `pairs`: the (4, T)
    table of a `pairs` variant.  Runs as many q heads at a time as keep a
    score tile within 2**26 elements."""
    flash_step_ref.calls += 1
    shape4 = q.shape if probe.strided else None
    if probe.strided:
        q = q.reshape(-1, *q.shape[2:])
        k = k.reshape(-1, *k.shape[2:])
        v = v.reshape(-1, *v.shape[2:])
    BH, M, D = q.shape
    BHk, N = k.shape[:2]
    group = BH // BHk
    dev = q.device
    f32 = torch.float32
    n_tiles = N // bk
    st = set(probe.stages)
    extra_q = torch.zeros(M, dtype=f32, device=dev)
    for t in qside:
        extra_q = extra_q + t.to(dev, f32)
    extra_k = [t.to(dev, f32) for t in kside]
    if pairs is not None:
        pairs = np.asarray(pairs)
    hc = max(1, min(BH, 2 ** 26 // (M * bk)))
    out = torch.empty((BH, M, D), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((BH, M), dtype=f32, device=dev)

    for h0 in range(0, BH, hc):
        heads = torch.arange(h0, min(BH, h0 + hc), device=dev)
        qh = q[heads].to(f32)
        kh = k[heads // group].to(f32)
        vh = v[heads // group].to(f32)
        m = torch.full((len(heads), M), NEG_INIT, dtype=f32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((len(heads), M, D), dtype=f32, device=dev)

        def update(rows: slice, ki: int):
            cols = slice(ki * bk, (ki + 1) * bk)
            s = torch.matmul(qh[:, rows], kh[:, cols].transpose(1, 2)) * \
                torch.tensor(scale, dtype=f32)
            if qside or kside:
                ex = extra_q[rows, None]
                for t in extra_k:
                    ex = ex + t[None, cols]
                s = s + ex * 0.0
            run = None
            if probe.branches:
                # the block's (bq rows) and the tile's segment words
                nr = rows.stop - rows.start
                qs = qseg[rows].to(dev).view(nr // bq, bq)
                ks = kseg[cols].to(dev)
                qmin, qmax = qs.min(1).values, qs.max(1).values
                kmin, kmax = ks.min(), ks.max()
                run = ((kmin <= qmax) & (qmin <= kmax)).repeat_interleave(
                    bq)
            m_prev = m[:, rows]
            if "max" in st:
                m_next = torch.maximum(m_prev, s.amax(-1))
                alpha = torch.exp2(m_prev - m_next)
            else:
                m_next, alpha = m_prev, torch.ones_like(m_prev)
            p = torch.exp2(s - m_next[..., None]) if "exp" in st else s
            if "bf16exp" in st:
                x = (s - m_next[..., None]).to(torch.bfloat16).to(f32)
                if bf16_exp2 == "lax":
                    x = torch.exp((x * _LN2_BF16).to(torch.bfloat16).to(f32))
                else:
                    x = torch.exp2(x)
                p = x.to(torch.bfloat16).to(f32)
            if run is not None:
                m_next = torch.where(run, m_next, m_prev)
                alpha = torch.where(run, alpha, torch.ones_like(alpha))
                p = torch.where(run[:, None], p, torch.zeros_like(p))
            m[:, rows] = m_next
            if "sum" in st:
                ps = p.sum(-1)
                if "bf16exp" in st:
                    ps = ps.to(torch.bfloat16).to(f32)
                l[:, rows] = alpha * l[:, rows] + ps
            if "pv" in st:
                pv = torch.matmul(p.to(torch.bfloat16).to(f32), vh[:, cols])
                acc[:, rows] = acc[:, rows] * alpha[..., None] + pv

        def finish(rows: slice):
            a, lr = acc[:, rows], l[:, rows]
            if probe.lse:
                inv = torch.where(lr == 0, torch.zeros_like(lr), 1.0 / lr)
                out[heads, rows] = (a * inv[..., None]).to(torch.bfloat16)
                lse[heads, rows] = torch.where(
                    lr == 0, torch.full_like(lr, float("-inf")),
                    m[:, rows] * LN2_PROBE + torch.log(lr))
            else:
                out[heads, rows] = a.to(torch.bfloat16)

        if pairs is None:
            for ki in range(n_tiles):
                update(slice(0, M), ki)
            finish(slice(0, M))
        else:
            for qi, ki, first, last in pairs.T.tolist():
                rows = slice(qi * bq, (qi + 1) * bq)
                if first:
                    m[:, rows] = NEG_INIT
                    l[:, rows] = 0.0
                    acc[:, rows] = 0.0
                update(rows, ki)
                if last:
                    finish(rows)

    if shape4 is not None:
        out = out.reshape(shape4)
        lse = lse.reshape(shape4[:-1])
    return (out, lse) if probe.lse else out


flash_step_ref.calls = 0
