"""The benchmark of banzai_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload l9-silesia --seed 7 --seconds 40 --trace 0

Looks for the cards the cell asks for (and exits 2 with no result
without them), builds the cell's pool from the seed, warms up, drives
``banzai_tpu_torch.compress`` in a closed loop for ``--seconds``, checks
the window's streams against the plain reference, and prints one JSON
line: the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics.  The numbers that decided ``correct`` close the line (key
``checks``) and standard error.  Exits 3 with no result if JAX or the
JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark import harness, spec

    cell = spec.cell(spec.load(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {n} visible",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=T0)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded in this process: {', '.join(banned)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['rule']} {c['limit']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
