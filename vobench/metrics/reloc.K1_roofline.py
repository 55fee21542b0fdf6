"""K1's share of its roofline in the profiled queries: the least time of
its launches (``roofline.k1`` at S x N points on each scale's padded
plane) over their device time.  Two chains of lv_f + 1 scales a query."""

from vobench import roofline
from vobench.harness import kernel_launches

LAYER = "kernels: ops/patch_gather, csrc/patch_gather.cu"
UNIT = "%"
MOVES = "hypotheses_per_s"


def read(run):
    hit = kernel_launches(run.trace, "gather_ref_grad_windows_kernel")
    if not hit:
        return None
    count, seconds = hit
    tr = run.config["tracker"]
    units = run.trace.profile["units"]
    if count != 2 * (tr["lv_f"] + 1) * units:
        return None
    M = run.params["samples"] * run.params["points"]
    wh = run.config["camera"]["wh"]
    least = sum(roofline.k1(M, *roofline.level_dims(wh, s, tr["psz"]), tr["psz"])
                for s in range(tr["lv_f"] + 1))
    return roofline.share_pct(2 * units * least, seconds)
