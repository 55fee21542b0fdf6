"""The card's idle share over the profiled units: 1 - the union of the
device operations' intervals over the profiled window."""

LAYER = "the card"
UNIT = "%"
MOVES = "hypotheses_per_s"


def read(run):
    prof = run.trace.profile
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"]) if prof else None
