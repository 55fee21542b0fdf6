"""Tiny versions of the benchmark's cells for the CPU tests: the cells of
``BENCHMARK.json`` with their files, at sizes the CPU runs in seconds."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from vobench import drive, harness  # noqa: E402

TINY = {
    "reloc": ({"camera": {"wh": [160, 120], "fc": [125.0, 150.0], "cc": [81.5, 58.0]},
               "tracker": {"lv_f": 2}},
              {"queries": 2, "samples": 64, "outliers": 20, "check_answers": 2}),
    "pointtrack": ({"camera": {"wh": [160, 120], "fc": [125.0, 150.0], "cc": [81.5, 58.0]},
                    "pointtrack": {"levels": 3, "corners": 100}},
                   {"frames": 6}),
}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(name: str) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json, cut to a CPU size."""
    cell = harness.Cell(bench(), name)
    config, params = TINY[cell.spec["kind"]]
    for key, value in config.items():
        if isinstance(value, dict):
            cell.config[key] = dict(cell.config[key], **value)
        else:
            cell.config[key] = value
    cell.params = dict(cell.params, **params)
    return cell


def run(cell, seed: int = 2**31 + 11, seconds: float = 0.5, trace: bool = False):
    """One run on the CPU -> (the result as a dict, the check lines)."""
    line, checks = drive.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter())
    print(line)
    return json.loads(line), checks
