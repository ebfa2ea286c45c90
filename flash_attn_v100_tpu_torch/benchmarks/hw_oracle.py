"""The hardware oracle suite on the card: the port's counterpart of the
JAX repository's `run.sh --tpu` stage.  Runs, in order, the dense sweep
(bf16, then fp32 through the fp32 kernel bodies: one shape with --quick),
the varlen sweep, the decode sweep, the decode fast-path cases and the
randomized fuzz (12 trials with --quick, else 40), each gated against the
fp32 oracle by the reference's tolerance model, and exits non-zero if any
case failed.

    python -m flash_attn_v100_tpu_torch.benchmarks.hw_oracle [--quick]
"""

from __future__ import annotations

import argparse
import sys
import time

from flash_attn_v100_tpu_torch.benchmarks import (
    fuzz_oracle, sweep_decode, sweep_dense, sweep_varlen,
    verify_decode_fastpath)
from flash_attn_v100_tpu_torch.benchmarks.common import run_device

FUZZ_TRIALS = {True: 12, False: 40}


def main(quick: bool = False, device: str = "cuda") -> dict:
    """Run the suite; returns {stage: failed cases}."""
    run_device(device)
    stages = (
        ("sweep_dense", lambda: sweep_dense.main(quick, device=device)),
        ("sweep_dense fp32",
         lambda: sweep_dense.main(quick, dtype="fp32", device=device)),
        ("sweep_varlen", lambda: sweep_varlen.main(quick, device=device)),
        ("sweep_decode", lambda: sweep_decode.main(quick, device=device)),
        ("verify_decode_fastpath",
         lambda: verify_decode_fastpath.main(device=device)),
        ("fuzz_oracle",
         lambda: fuzz_oracle.main(FUZZ_TRIALS[quick], 0, device=device)),
    )
    fails = {}
    for name, run in stages:
        t0 = time.time()
        print(f"== hw_oracle: {name} ==", flush=True)
        fails[name] = run()
        print(f"== hw_oracle: {name}: {fails[name]} failed "
              f"({time.time() - t0:.1f} s) ==", flush=True)
    total = sum(fails.values())
    print(f"hw_oracle: {'ALL PASS' if total == 0 else f'{total} FAILURES'} "
          f"{fails}", flush=True)
    return fails


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    sys.exit(1 if sum(main(ap.parse_args().quick).values()) else 0)
