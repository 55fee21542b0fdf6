"""K2's share of its roofline in the profiled queries: the least time of
its launches (``roofline.k2`` at S x N points) over their device time.
Two chains of (lv_f + 1) scales x maxiter GN iterations a query."""

from vobench import roofline
from vobench.harness import kernel_launches

LAYER = "kernels: ops/icgn_iter, csrc/icgn_iter.cu"
UNIT = "%"
MOVES = "hypotheses_per_s"


def read(run):
    hit = kernel_launches(run.trace, "resample_kernel")
    if not hit:
        return None
    count, seconds = hit
    tr = run.config["tracker"]
    per_query = 2 * (tr["lv_f"] + 1) * tr["maxiter"]
    if count != per_query * run.trace.profile["units"]:
        return None
    M = run.params["samples"] * run.params["points"]
    return roofline.share_pct(count * roofline.k2(M, tr["psz"]), seconds)
