"""Benchmark entry point of the PyTorch/CUDA port, one run of one cell:

    python3 -m bench_torch.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs a CUDA card and never falls back to
the CPU. The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit); the compared numbers are also the last lines
of standard error.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
#: the package under test, which the checkout holds beside the benchmark
PROGRAM = "image_transformation_tpu_torch"
#: build and kernel caches at fixed paths inside the checkout, so that only
#: a checkout's first run builds
CACHES = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
          "TRITON_CACHE_DIR": ".bench_cache/triton"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(CHECKOUT / rel)

    import torch

    from . import harness

    cell = harness.load_cell(args.workload)
    if not (CHECKOUT / PROGRAM).is_dir():
        print(f"bench_torch: no {PROGRAM} in {CHECKOUT}: the program under test is missing",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA card; this benchmark runs only on one", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench_torch: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    if "jax" in sys.modules:
        print("bench_torch: jax was imported", file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
