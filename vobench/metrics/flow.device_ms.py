"""The card's busy time per frame pair: the union of the device
operations' intervals over the profiled pairs, over their number."""

LAYER = "the card"
UNIT = "ms/pair"
MOVES = "flow_pairs_per_s"


def read(run):
    prof = run.trace.profile
    return 1e3 * prof["busy_s"] / prof["units"] if prof else None
