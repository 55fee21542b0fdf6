"""The median wall time of one query's verification (``track_nposes``
and ``select_best``: ``solver/chain``, ``solver/icgn`` and their kernels),
from the harness's span around them."""

from statistics import median

LAYER = "solver/chain, solver/icgn"
UNIT = "ms"
MOVES = "hypotheses_per_s"


def read(run):
    spans = run.trace.spans.get("verify")
    return 1e3 * median(spans) if spans else None
