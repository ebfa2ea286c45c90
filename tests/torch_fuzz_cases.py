"""What the fuzz parity tests share: the JAX repository's benchmark scripts
loaded by path, the recorders that stand in for the fuzz scripts' entry
points, oracles and gate, and one fuzz trial run through both packages.
Imports JAX: only tests import it."""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu_torch.benchmarks import fuzz_oracle as tfuzz
from flash_attn_v100_tpu_torch.benchmarks.common import normal
from flash_attn_v100_tpu_torch.utils.testing import assert_fwd_close

ROOT = Path(__file__).resolve().parents[1]
TRIALS_PER_SEED = 3
KINDS = ("dense", "varlen", "kvcache")
ENTRY = ("flash_attn_func", "flash_attn_varlen_func",
         "flash_attn_with_kvcache")
ORACLES = ("mha_reference", "mha_reference_varlen", "mha_reference_kvcache")


def load(name):
    """A script of the JAX repository's benchmarks/, by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_benchmarks_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jfuzz = load("fuzz_oracle")


def canon(x):
    """A value as comparable data: arrays of either package as (dtype,
    shape, bytes), bf16 by its bits."""
    if isinstance(x, (tuple, list)):
        return tuple(canon(y) for y in x)
    if isinstance(x, np.generic):
        return x.item()
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        a = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        dtype = str(t.dtype).replace("torch.", "")
    else:
        a = np.asarray(x)
        dtype = str(a.dtype)
        if dtype == "bfloat16":
            a = a.view(np.int16)
    return dtype, tuple(a.shape), np.ascontiguousarray(a).tobytes()


class Recorder:
    """The scripts' entry points, oracles and gate, recording each call and
    returning zeros of q's shape in q's array type."""

    def __init__(self, zeros):
        self.calls, self.zeros = [], zeros

    def patch(self, monkeypatch, mod):
        for name in ENTRY + ORACLES:
            monkeypatch.setattr(mod, name, self.fn(name))
        monkeypatch.setattr(mod, "assert_fwd_close",
                            lambda *a, **k: self.calls.append(("gate",)))

    def fn(self, name):
        def call(*args, **kw):
            self.calls.append((name, canon(args),
                               {k: canon(v) for k, v in kw.items()}))
            out = self.zeros(args[0])
            return (out, None, None) if name == "mha_reference_kvcache" \
                else out
        return call


def run_jax(n, seed):
    sys.argv = ["fuzz_oracle.py", str(n), str(seed)]
    with pytest.raises(SystemExit):
        jfuzz.main()


def record(seeds, jax_too=True):
    """Per seed: (the JAX script's calls or None, the port's calls) of
    trials 0 .. TRIALS_PER_SEED - 1, both scripts patched with recorders."""
    mp = pytest.MonkeyPatch()
    argv = sys.argv
    out = {}
    try:
        for seed in seeds:
            jrec = Recorder(lambda q: jnp.zeros(q.shape, q.dtype))
            trec = Recorder(torch.zeros_like)
            trec.patch(mp, tfuzz)
            if jax_too:
                jrec.patch(mp, jfuzz)
                run_jax(TRIALS_PER_SEED, seed)
            assert tfuzz.main(TRIALS_PER_SEED, seed, device="cpu") == 0
            out[seed] = (jrec.calls if jax_too else None, trec.calls)
    finally:
        mp.undo()
        sys.argv = argv
    return out


def _work(call):
    """M N H D of a trial's entry-point call."""
    name, args, kw = call
    q, k = args[0][1], args[1][1]
    if name == "flash_attn_varlen_func":
        return q[0] * k[0] * q[1] * q[2]
    return q[1] * k[1] * q[2] * q[3]


def smallest_trial(calls, kind):
    """(seed, trial) of the smallest `kind` trial among recorded calls
    ({seed: calls}), by M N H D."""
    ids = []
    for seed, seed_calls in calls.items():
        for i in range(TRIALS_PER_SEED):
            call = seed_calls[4 * i]
            if call[0] == ENTRY[KINDS.index(kind)]:
                ids.append((_work(call), seed, i))
    return min(ids)[1:]


def _gates(monkeypatch, mod, store):
    """mod's gate, keeping its (out, fp32 oracle, bf16 oracle) in store."""
    real = mod.assert_fwd_close

    def gate(out, ref32, refnat, name="out"):
        store.append(tuple(
            torch.as_tensor(np.array(x.float() if isinstance(x, torch.Tensor)
                                     else jnp.asarray(x, jnp.float32)))
            for x in (out, ref32, refnat)))
        return real(out, ref32, refnat, name)
    monkeypatch.setattr(mod, "assert_fwd_close", gate)


def check_trial_across_packages(monkeypatch, seed, i, kind):
    """Trial i of `seed` through the JAX script (its loop body: the rng,
    mk, the kind's draw) and the port's, each gated as the scripts gate
    it; then each package's output against the other's oracles."""
    jout, tout = [], []
    _gates(monkeypatch, jfuzz, jout)
    _gates(monkeypatch, tfuzz, tout)

    r = np.random.default_rng(seed * 100003 + i)
    assert KINDS[int(r.integers(0, 3))] == kind
    {"dense": jfuzz.trial_dense, "varlen": jfuzz.trial_varlen,
     "kvcache": jfuzz.trial_kvcache}[kind](
        r, lambda *s: jnp.asarray(r.standard_normal(s), jnp.bfloat16))

    r = np.random.default_rng(seed * 100003 + i)
    r.integers(0, 3)

    cpu = torch.device("cpu")
    tfuzz.TRIALS[kind](r, lambda *s: normal(r, s, cpu), cpu)

    (jo, j32, jnat), = jout
    (to, t32, tnat), = tout
    assert_fwd_close(to, j32, jnat, f"port vs the JAX oracle, {kind}")
    assert_fwd_close(jo, t32, tnat, f"JAX vs the port's oracle, {kind}")
