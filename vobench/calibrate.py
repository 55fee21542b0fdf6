#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from.

    python3 vobench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control 1,2,3] [--units 2]

For each seed, in one process: the cell's set-up, ``--units`` timed
units of its traffic, and the check's numbers (the program against the
reference); for each seed of ``--control``, the same numbers with the
control, the reference in float32 with TF32 products, in the program's
place.  Prints one JSON line per seed.  The lower reading of a number is the
largest the program gives over the seeds, the upper the smallest the
control gives; each limit lies between them (PERF.md gives both).
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--units", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import invcompcamtrack_torch  # noqa: F401  (sets TF32 off)
    from vobench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.read_json(ROOT / "BENCHMARK.json"), args.workload)
    control = {int(s) for s in args.control.split(",") if s}
    sync = torch.cuda.synchronize
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        ctx = SimpleNamespace(seed=seed, device=torch.device("cuda"), params=cell.params,
                              config=cell.config, limits=cell.limits, sync=sync,
                              quiet=harness.Trace(False, sync), phases={})
        st = cell.kind.setup(ctx)
        records = [cell.kind.unit(st, i, ctx.quiet) for i in range(args.units)]
        cell.kind.release(st)
        out = {"seed": seed, "program": {k: v["value"] for k, v in
                                         cell.kind.check(st, records).items()}}
        if seed in control:
            out["control"] = cell.kind.control(st, records)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del st, records
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
