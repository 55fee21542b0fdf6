"""Device operations launched per query (upload, fit, verification),
counted in the profiled queries: the host loop's launch count."""

LAYER = "solver/icgn host loop"
UNIT = "ops/query"
MOVES = "hypotheses_per_s"


def read(run):
    prof = run.trace.profile
    return prof["ops"] / prof["units"] if prof else None
