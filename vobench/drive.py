"""One run of one cell: set-up, the closed-loop window, the reading of
the trace, the check against the reference, the result line.

``run_cell`` takes any device: the benchmark passes the card, the tests
under ``vobench/tests`` pass the CPU at a tiny size."""

from __future__ import annotations

import math
import sys
import time
from types import SimpleNamespace

from vobench import harness


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device: str,
             t_start: float):
    """-> (the result line, the 'name value (limit L)' lines)."""
    import torch

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    trace = harness.Trace(trace_on, sync)
    ctx = SimpleNamespace(seed=int(seed), device=torch.device(device), params=cell.params,
                          config=cell.config, limits=cell.limits, sync=sync,
                          quiet=harness.Trace(False, sync))
    kind = cell.kind

    t0 = time.perf_counter()
    if on_card:
        from invcompcamtrack_torch.ops import _build

        _build.load()
    ctx.phases = {"start": t0 - t_start, "kernels": time.perf_counter() - t0}
    st = kind.setup(ctx)
    sync()
    setup_s = time.perf_counter() - t_start
    print("vobench: set-up %.2f s: " % setup_s + ", ".join(
        f"{k} {v:.2f} s" for k, v in ctx.phases.items()), file=sys.stderr)

    # ---- the window: units back to back until --seconds have passed;
    # it closes when the last unit started before then has finished
    records = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    p = cell.params
    tries = 0

    def next_unit():
        rec = kind.unit(st, len(records), trace)
        records.append(rec)
        return rec

    while time.perf_counter() < deadline:
        if (trace_on and on_card and trace.profile is None and tries < 3
                and len(records) >= p["profile_after"] + tries * p["profile_units"]):
            tries += 1
            harness.profile_units(trace, next_unit, p["profile_units"], torch)
        else:
            next_unit()
    window_s = records[-1]["t1"] - t0

    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0}
    run = SimpleNamespace(records=records, window_s=window_s, trace=trace, params=p,
                          config=cell.config)
    breakdown = None
    if trace_on:
        metrics = {}
        for name, reader in cell.readers().items():
            value = reader.read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        if trace.profile:
            dev_info["busy_s"] = trace.profile["busy_s"]
            dev_info["window_s"] = trace.profile["window_s"]
            breakdown = {"device_ops": [[n, s] for n, s in trace.profile["top_ops"]],
                         "idle_gaps": trace.profile["idle_gaps"]}
    else:
        metrics = {name: {"value": value, "unit": unit}
                   for name, (value, unit) in kind.end_to_end(run).items()
                   if name in {m["name"] for m in cell.end_to_end}}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    # ---- the check: program state freed, then the reference
    kind.release(st)
    if on_card:
        torch.cuda.empty_cache()
    checks = kind.check(st, records)
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in checks.values())
    line = harness.result(correct, len(records), 0, metrics, dev_info, checks, breakdown)
    return line, harness.check_lines(checks)
