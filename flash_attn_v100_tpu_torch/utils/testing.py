"""Tolerance model and assert helpers.

Errors are bounded relative to the same-bit-width oracle's own error against
the fp32 oracle, not by an absolute epsilon:

    err(kernel, oracle_fp32) <= mult * err(oracle_native, oracle_fp32) + atol

with mult=2, atol=1e-5 for forward outputs and mult=3, atol=1e-4 for
gradients, plus an explicit NaN/Inf scan.
"""

from __future__ import annotations

import torch

FWD_MULT, FWD_ATOL = 2.0, 1e-5
BWD_MULT, BWD_ATOL = 3.0, 1e-4


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def max_abs_err(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float((a - b.to(a.device)).abs().max())


def assert_no_nan_inf(x, name="tensor"):
    x = torch.as_tensor(x)
    n_nan = int(torch.isnan(x).sum())
    n_inf = int(torch.isinf(x).sum())
    assert n_nan == 0 and n_inf == 0, f"{name}: NaN={n_nan}, Inf={n_inf}"


def assert_close_rel(out, out_ref_fp32, out_ref_native, mult, atol, name="out"):
    """The relative-tolerance gate; returns the measured error."""
    assert_no_nan_inf(out, name)
    err = max_abs_err(out, out_ref_fp32)
    err_ref = max_abs_err(out_ref_native, out_ref_fp32)
    bound = mult * err_ref + atol
    assert err <= bound, (
        f"{name}: err={err:.3e} > {mult}*err_ref({err_ref:.3e}) + {atol:.0e} = {bound:.3e}"
    )
    return err


def assert_fwd_close(out, out_ref_fp32, out_ref_native, name="out"):
    return assert_close_rel(out, out_ref_fp32, out_ref_native, FWD_MULT,
                            FWD_ATOL, name)


def assert_bwd_close(g, g_ref_fp32, g_ref_native, name="grad"):
    return assert_close_rel(g, g_ref_fp32, g_ref_native, BWD_MULT, BWD_ATOL,
                            name)
