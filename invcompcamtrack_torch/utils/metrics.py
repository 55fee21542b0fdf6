"""Structured metrics / observability (the port's own copy of
``invcompcamtrack_tpu/utils/metrics.py``, a module that imports no JAX;
a test holds the two equal).

The reference's observability is printf-driven: a ``verbosity`` int
(0 silent, 1 timing, 2 per-iteration step-norm prints
``Sc%02i,It%02i: %g``; reference: utilities.h:59, odometer.cpp:416-417)
and hand-recorded timing tables in comments.  This module is a
structured JSONL metrics recorder for host loops (the VO engine's
example logs per-frame rows: live landmarks, step time).
"""

from __future__ import annotations

import json
import time
from typing import Optional


class MetricsLogger:
    """Append-only structured metrics with optional JSONL persistence."""

    def __init__(self, path: Optional[str] = None):
        self.rows = []
        self._path = path
        self._fh = open(path, "a") if path else None
        self._t0 = time.perf_counter()

    def record(self, **fields):
        row = {"t": round(time.perf_counter() - self._t0, 6), **fields}
        self.rows.append(row)
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        return row

    def summary(self, key: str):
        vals = [r[key] for r in self.rows if key in r]
        if not vals:
            return None
        import numpy as np

        a = np.asarray(vals, float)
        return {"mean": float(a.mean()), "min": float(a.min()),
                "max": float(a.max()), "n": len(vals)}

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
