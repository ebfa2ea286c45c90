"""prof_int4_rmw (flash_attn_v100_tpu_torch/benchmarks/prof_int4_rmw.py)
against the JAX package on the same numpy inputs: its one-round append
(the port's `ops/kvcache.py::_int4_rmw_paged`) and its two-round twin
write the bytes JAX's `ops/kvcache.py::_int4_rmw_paged` and the JAX
script's own `two_round` (its source, run as it stands) write, into zero
and into random pools; with the script's draw (page ids without
replacement), and with two rows on one page writing opposite nibbles of
neighbouring bytes.  The script also runs at a tiny size on the CPU."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_script_flags import JAX, function_source

from flash_attn_v100_tpu.ops import kvcache as jkc
from flash_attn_v100_tpu_torch.benchmarks import prof_int4_rmw as rmw

torch.set_num_threads(1)

Hk, L, B, PS, D = 2, 2, 4, 16, 8


def _jax_two_round():
    """The JAX script's `two_round`, defined from its source."""
    ns = dict(jnp=jnp, kc=jkc, Hk=Hk)
    exec(function_source(JAX / "prof_int4_rmw.py", "two_round"), ns)
    return ns["two_round"]


def _cases():
    P = rmw.folded_pages(B, L)
    drawn = rmw.draw(np.random.default_rng(0), Hk, B, PS, D, P)
    # two rows on page 5 writing bytes 2 (low nibble, offset 4) and 3 (high
    # nibble, offset 7), two rows on other pages at offsets 0 and 15
    rng = np.random.default_rng(1)
    vals = rng.integers(-8, 8, (B, 1, Hk, D)).astype(np.int8)
    pids = np.array([[5], [5], [9], [2]], np.int32)
    off = np.array([[4], [7], [0], [15]], np.int32)
    return {"drawn": (P, drawn), "opposite_nibbles": (P, (vals, pids, off))}


@pytest.mark.parametrize("start", ["zeros", "random"])
@pytest.mark.parametrize("case", ["drawn", "opposite_nibbles"])
def test_appends_write_jax_bytes(case, start):
    P, (vals, pids, off) = _cases()[case]
    rng = np.random.default_rng(2)
    pool = (np.zeros((Hk, P, PS // 2, D), np.int8) if start == "zeros" else
            rng.integers(-128, 128, (Hk, P, PS // 2, D)).astype(np.int8))
    j_args = (jnp.asarray(vals), jnp.asarray(pids), jnp.asarray(off))
    t_args = tuple(torch.from_numpy(a) for a in (vals, pids, off))
    want_one = np.asarray(jkc._int4_rmw_paged(jnp.asarray(pool), *j_args))
    want_two = np.asarray(_jax_two_round()(jnp.asarray(pool), *j_args))
    for fn, want in ((rmw.one_round, want_one), (rmw.two_round, want_two)):
        got = torch.from_numpy(pool.copy())
        fn(got, *t_args)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want_one, want_two)
    assert not np.array_equal(want_one, pool)       # the appends wrote


def test_draw_takes_distinct_pages():
    """Without replacement: every row its own page (the JAX script's
    `rng.integers` draw can repeat one), at the script's full size too."""
    for b, layers in ((B, L), (16, 16)):
        P = rmw.folded_pages(b, layers)
        _, pids, off = rmw.draw(np.random.default_rng(0), 8, b, 128, 128, P)
        assert len(set(pids[:, 0].tolist())) == b
        assert pids.min() >= 0 and pids.max() < P
        assert off.min() >= 0 and off.max() < 128


def test_script_runs_on_the_cpu(capsys):
    res = rmw.main(["--device", "cpu", "--kv-heads", "2", "--layers", "2",
                    "--batch", "4", "--page-size", "16", "--head-dim", "8",
                    "--chain", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "card: cpu"
    for name in ("two-round (old)", "one-round (new)"):
        (line,) = [ln for ln in lines if ln.startswith(name + ":")]
        us = float(re.search(r": ([\d.]+) us per T=1 RMW", line).group(1))
        assert us > 0 and res[name]["call_s"] > 0
    assert lines[-1] == "bit-identical OK" and res["equal"]
