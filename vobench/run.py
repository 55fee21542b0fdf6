#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port, ``invcompcamtrack_torch``.

    python3 vobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card of the machine it starts
on: makes the cell's inputs from the seed, warms up every shape the cell
uses (set-up), drives the program in a closed loop for ``--seconds``,
then holds a sample of what the window produced against the plain
reference under ``vobench/reference/`` and prints one JSON line.  With
``--trace 0`` the line has the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from spans around the calls
into each layer and from a torch.profiler run over a few units.

Exits non-zero, with no result, where there is no CUDA card (or fewer
than the cell asks for), where the program is missing, or where the
process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # build and kernel caches at fixed places inside the checkout; one
    # host thread for the CPU's own kernels (the host launches the card's)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "vobench_cache" / sub)
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))
    from vobench import drive, harness

    try:
        cell = harness.Cell(harness.read_json(ROOT / "BENCHMARK.json"), args.workload)
        import torch

        torch.set_num_threads(1)
        if not torch.cuda.is_available():
            raise harness.BenchError("no CUDA device: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell.chips:
            raise harness.BenchError(f"{cell.name} needs {cell.chips} cards, "
                                     f"{torch.cuda.device_count()} visible")
        try:
            import invcompcamtrack_torch  # noqa: F401  (sets TF32 off)
        except ImportError as exc:
            raise harness.BenchError(f"the program is missing: {exc}") from exc
        line, checks = drive.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                      "cuda", T_START)
        found = harness.forbidden_modules()
        if found:
            raise harness.BenchError("the process loaded " + ", ".join(found))
    except harness.BenchError as exc:
        print(f"vobench: {exc}", file=sys.stderr)
        return 2
    print(line, flush=True)
    for text in checks:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
