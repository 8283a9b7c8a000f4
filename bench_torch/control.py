"""Read the control of a cell on the card: the plain reference at the mix's
lower precision (``control`` in the mix file) in the program's place, over
the sampled outputs of a short window at the cell's own load.

    python3 -m bench_torch.control --workload <cell> --seeds <n,n,...> --seconds <s>

One JSON line per seed with each number compared and its limit; the
benchmark's own runs never run it. Every line must read ``correct: false``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .run import CACHES, CHECKOUT


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(CHECKOUT / rel)
    import torch

    from . import harness

    if not torch.cuda.is_available():
        print("bench_torch.control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, pending=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda", precision=cell.mix["control"])
        print(json.dumps({"workload": cell.name, "seed": seed, "control": cell.mix["control"],
                          "correct": r["correct"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
