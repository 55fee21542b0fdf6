"""What every cell shares: finding a cell's files by name, the device
check, the closed-loop window, spans and the profiled sub-window of a
traced run, the per-layer readers, and the result line.

A cell is ``workloads/<cell>.json``: its configuration's name, its
traffic mix, the kind of traffic (``traffic/<kind>.py``) with its
parameters, and the limits of its correctness check.  A configuration is
``configs/<config>.json``.  A per-layer metric is ``metrics/<metric>.py``
with ``LAYER``, ``UNIT``, ``MOVES`` and ``read(trace)``, which returns a
number or None.  ``BENCHMARK.json`` names them all; nothing here lists
them.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "invcompcamtrack_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result: no card, a missing file, a
    forbidden module."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"missing {path}")
    return json.loads(path.read_text())


class Cell:
    """One entry of ``workloads`` with its files, found by name."""

    def __init__(self, bench: dict, name: str, root: Path = HERE):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entries[name]
        self.name = name
        self.spec = read_json(root / "workloads" / f"{name}.json")
        for key in ("config", "traffic"):
            if self.spec[key] != self.entry[key]:
                raise BenchError(f"workloads/{name}.json: {key} {self.spec[key]!r} is not "
                                 f"BENCHMARK.json's {self.entry[key]!r}")
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = read_json(root.parent / configs[self.entry["config"]]["file"])
        self.kind = load_module(root / "traffic" / f"{self.spec['kind']}.py",
                                f"vobench_traffic_{self.spec['kind']}")
        self.params = self.spec["params"]
        self.limits = self.spec["limits"]
        self.chips = int(self.entry["chips"])

        def ours(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if ours(m)]
        self.per_layer = [m for m in bench["per_layer"] if ours(m)]

    def readers(self, root: Path = HERE) -> dict:
        out = {}
        for m in self.per_layer:
            mod = load_module(root / "metrics" / f"{m['name']}.py",
                              "vobench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
            for key, want in (("UNIT", m["unit"]), ("MOVES", m["moves"]), ("LAYER", m["layer"])):
                if getattr(mod, key) != want:
                    raise BenchError(f"metrics/{m['name']}.py: {key} {getattr(mod, key)!r} "
                                     f"is not BENCHMARK.json's {want!r}")
            out[m["name"]] = mod
        return out


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ------------------------------------------------------------ tracing


class Trace:
    """Spans from the harness's own calls into the program, and the
    profile of a few units.

    Off (``--trace 0``), ``span`` only marks a stage for the profiler and
    costs nothing else.  On, each span ends with a device synchronise and
    its host duration is kept; the units that ``profile`` covers are left
    out of the spans' statistics (the profiler slows the host)."""

    def __init__(self, on: bool, sync):
        self.on = on
        self.sync = sync
        self.spans: dict = {}
        self.profile: dict | None = None
        self._profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function("vobench:" + name):
            yield
            self.sync()
        if not self._profiling:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)


PAD_SPINS = 256


def profile_units(trace: Trace, run_unit, n_units: int, torch) -> None:
    """Run ``n_units`` units under one torch.profiler run of the
    device's activity alone (recording the host's ops too would slow the
    host-paced units about twofold).  Throw-away spin kernels stand
    before and after the units: the profiler can lose the events at the
    ends of a profile, and the last spin before the units and the first
    after them bound the profiled window on the device's clock.  The
    profile's summary goes to ``trace.profile`` (None if it recorded no
    device op)."""
    from torch.profiler import ProfilerActivity, profile

    trace._profiling = True
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            torch.cuda._sleep(1)            # the window opens as this ends
            for _ in range(n_units):
                run_unit()
            torch.cuda.synchronize()
            for _ in range(PAD_SPINS):      # the first closes it
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
    finally:
        trace._profiling = False
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    # (the profiler mirrors each vobench:* span onto the device's
    # timeline: those are no device work)
    device = [(e.start_ns(), e.end_ns(), e.name()) for e in events
              if e.device_type() == cuda and not e.name().startswith("vobench:")]
    print(f"vobench: the profile recorded {len(events)} events, {len(device)} on the device",
          file=sys.stderr)
    trace.profile = summarise(device, n_units)


def _union(intervals):
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def summarise(device, n_units: int) -> dict | None:
    """device: (start ns, end ns, name) of every device event, spins
    included -> the ops between the spins, their union and the gaps
    between them over the window, in seconds (None if the window or its
    ops are missing)."""
    spins = sorted((a, b) for a, b, n in device if "spin_kernel" in n)
    ops = sorted((a, b, n) for a, b, n in device if "spin_kernel" not in n)
    if not ops:
        return None
    last = max(b for _, b, _ in ops)
    before = [s for s in spins if s[1] <= ops[0][0]]
    after = [s for s in spins if s[0] >= last]
    if not before or not after:
        return None
    w0, w1 = before[-1][1], after[0][0]
    by_name: dict = {}
    for a, b, n in ops:
        c, t = by_name.get(n, (0, 0))
        by_name[n] = (c + 1, t + (b - a))
    gaps, end = [], w0
    for a, b, n in ops:
        if a > end:
            gaps.append((a - end, "before " + n[:180]))
        end = max(end, b)
    if w1 > end:
        gaps.append((w1 - end, "the units' end"))
    gaps.sort(key=lambda g: -g[0])
    return {
        "ops": len(ops), "units": n_units,
        "window_s": (w1 - w0) * 1e-9, "busy_s": _union([(a, b) for a, b, _ in ops]) * 1e-9,
        "by_name": {n: (c, t * 1e-9) for n, (c, t) in by_name.items()},
        "top_ops": sorted(((n[:200], t * 1e-9) for n, (_, t) in by_name.items()),
                          key=lambda kv: -kv[1])[:10],
        # each gap named by the device op that ended it: what the host
        # was launching
        "idle_gaps": [[n, g * 1e-9] for g, n in gaps[:10]],
    }


def kernel_launches(trace: Trace, part: str) -> list:
    """(count, seconds) of the profiled device ops whose name holds
    ``part`` (a kernel of the program's ``csrc/``), or None."""
    prof = trace.profile
    if not prof:
        return None
    hits = [v for n, v in prof["by_name"].items() if part in n]
    if not hits:
        return None
    return sum(c for c, _ in hits), sum(t for _, t in hits)


# --------------------------------------------------------- statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = (len(xs) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def keep_worst(worst: dict, readings: dict) -> None:
    """Fold one answer's readings into the worst so far (a reading that
    is not a number counts as inf)."""
    for name, v in readings.items():
        v = v if v == v else float("inf")
        worst[name] = max(worst.get(name, float("-inf")), v)


# -------------------------------------------------------------- result


def check_lines(checks: dict) -> list:
    """'name value (limit L)' for every number compared."""
    return [f"{name} {v['value']!r} (limit {v['limit']!r})" for name, v in checks.items()]


def result(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
           checks: dict, breakdown: dict | None = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # (a reading that is not finite, as from a broken answer, is null)
    out["checks"] = {n: {"value": v["value"] if math.isfinite(v["value"]) else None,
                         "limit": v["limit"]} for n, v in checks.items()}
    return json.dumps(out, allow_nan=False)
