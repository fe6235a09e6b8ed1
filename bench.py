"""Benchmark entry point: delegates to psvo_tpu.benchmark (prints ONE JSON line).

Needs a GPU: on any other platform it prints a JSON error line and exits 1.

    python bench.py                  # primary row (FHN FIVO K=1024 B=32 T=100)
    python bench.py --preset NAME    # one preset's row
    python bench.py --all            # every row; also writes BENCH_ALL.json
    python bench.py --to-target      # seconds to a fixed test ELBO
    python bench.py --trace DIR      # kernels per step and idle share
"""

import argparse
import sys

from psvo_tpu import benchmark

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="fhn_fivo_k1024_bench")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument(
        "--all",
        action="store_true",
        help="measure every BASELINE config; write BENCH_ALL.json",
    )
    ap.add_argument(
        "--to-target",
        action="store_true",
        help="train the primary preset to a fixed test ELBO; report seconds",
    )
    ap.add_argument("--target-elbo", type=float, default=-15.0)
    ap.add_argument(
        "--trace",
        metavar="DIR",
        help="trace one steady train-step call of --preset into DIR; "
        "print kernels per step and the device idle share",
    )
    a = ap.parse_args()

    if a.trace:
        sys.exit(benchmark.main_trace(a.preset, a.trace))
    if a.to_target:
        sys.exit(benchmark.main_to_target(a.preset, target_elbo=a.target_elbo))
    if a.all:
        sys.exit(benchmark.main_all(a.steps))
    sys.exit(benchmark.main(a.preset, a.steps))
