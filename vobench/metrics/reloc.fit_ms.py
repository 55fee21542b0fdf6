"""The median wall time of the RANSAC fit of one query (``sfm/ransac``,
``sfm/pnp``), from the harness's span around ``fit_camera_ransac``."""

from statistics import median

LAYER = "sfm/ransac, sfm/pnp"
UNIT = "ms"
MOVES = "hypotheses_per_s"


def read(run):
    spans = run.trace.spans.get("fit")
    return 1e3 * median(spans) if spans else None
