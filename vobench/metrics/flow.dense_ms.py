"""The median wall time of one pair's dense LK flow, both directions
(``match/dense_flow``: its box sums and K8), from the harness's span."""

from statistics import median

LAYER = "match/dense_flow"
UNIT = "ms"
MOVES = "flow_pairs_per_s"


def read(run):
    spans = run.trace.spans.get("dense")
    return 1e3 * median(spans) if spans else None
