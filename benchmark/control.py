"""The control of ``correct``: it has to come out as not correct.

The plain reference takes the program's place in the window, with one
guarantee of the configuration broken the way a later change might be
tempted to break it: the entropy plan tries only 2 and 3 refined tables
and leaves banzai's plan out (the plan is the port's largest device
stage).  The stream still decodes, but it is no longer the one the
configuration guarantees, so ``stream_mismatch_jobs`` must read above
its limit.  The reference encodes the control's jobs in a pool of
processes; the window, the sample and the check are a run's own.

    python3 benchmark/control.py --workload l9-silesia --seeds 1,2,3 --seconds 40
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CONTROL_PLAN = ((2, 3), False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark import check, harness, spec
    from benchmark.reference.encoder import compress_many

    cell = spec.cell(spec.load(), args.workload)
    level = int(cell.config["level"])
    for seed in (int(s) for s in args.seeds.split(",")):
        import multiprocessing

        pool = multiprocessing.get_context("spawn").Pool(check.workers())
        try:
            def encode(data, stats=None, device=None):
                return compress_many([data], level, pool, plan=CONTROL_PLAN)[0]

            result = harness.run_cell(cell, seed, args.seconds, False, t0=time.perf_counter(),
                                      devices="cpu", encode=encode, warm=False)
        finally:
            pool.close()
            pool.join()
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "plan (2, 3) tables, no banzai",
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
