"""The port's dense flow path (``ops/warp.py`` K8's plain version,
``match/dense_flow.py``, ``match/flow_eval.py``, ``match/flow_bench.py``,
``utils/viz.py``) against the JAX package on the same seeded inputs, on
the CPU (so the K8 wrapper takes its plain version).

Tolerances, from measurements on these very inputs:
- ``warp_image_plain`` vs the JAX XLA twin ``warp_image``: the same float
  operations in the same order: exact, for every flow tried (smooth, a
  10 px step, flow that leaves the image on every side, integer flow,
  infinite and NaN flow).
- vs the TPU kernel ``warp_image_pallas`` run in Pallas interpret mode,
  on a flow within that kernel's +-3 px slack around each tile's mean:
  the kernel forms its weights from the residual flow (flow - tile
  mean), the twin from x + flow, whose last bit is 1.5e-5 px at x ~ 128;
  times the image's slope (up to ~30 grey levels per px here) that is
  the measured gap, 2.6e-4 on an image in [0, 255]; WARP_SLACK_ATOL =
  1e-3.
- ``dense_flow_lk`` vs JAX: three levels of box sums (``F.conv2d`` vs
  XLA's convolution: other summation orders), divisions by a guarded
  determinant and the 2x upsampling, iterated.  Measured port-vs-JAX
  gap: max 0.6e-5 to 1.3e-5 px, median 5e-7 to 7e-7 px; JAX's own
  float32-vs-float64 gap on the same calls: max 0.8e-5 to 1.0e-5 px,
  median 6e-7 px.  FLOW_ATOL = 5e-5 px on every pixel, FLOW_MEDIAN_ATOL =
  2e-6 px.
- ``evaluate_pair``: per-point errors of the same flow and of the two
  refinements differ by up to 4.1e-5 px, the binned means by up to
  2.9e-6 px (measured): RAW_ATOL = 2e-4 px, EPE_ATOL = 2e-5 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy.ndimage import gaussian_filter

from invcompcamtrack_tpu.image.pyramid import build_pyramid as jbuild
from invcompcamtrack_tpu.match import dense_flow as jflow
from invcompcamtrack_tpu.match import flow_bench as jbench
from invcompcamtrack_tpu.match.flow_eval import flow_epe_binned as jepe
from invcompcamtrack_tpu.ops.warp_pallas import warp_image_pallas
from invcompcamtrack_tpu.utils import viz as jviz
from invcompcamtrack_tpu.vo import synthetic
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.match import dense_flow, flow_bench
from invcompcamtrack_torch.match.flow_eval import flow_epe_binned
from invcompcamtrack_torch.ops import warp
from invcompcamtrack_torch.utils import viz
from tests.oracles import geometry_np as geo
from tests.torch_helpers import t32

WARP_SLACK_ATOL = 1e-3
FLOW_ATOL = 5e-5
FLOW_MEDIAN_ATOL = 2e-6
EPE_ATOL = 2e-5
RAW_ATOL = 2e-4


def _smooth_image(rng, H, W):
    return (gaussian_filter(rng.normal(size=(H, W)), 2.0) * 400 + 128
            ).clip(0, 255).astype(np.float32)


def _flows(H, W):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    smooth = np.stack([1.3 * np.sin(yy / 17.0) + 0.7 * np.cos(xx / 43.0) + 4.0,
                       1.1 * np.cos(yy / 13.0) - 0.9 * np.sin(xx / 39.0) + 6.0], -1)
    step = smooth.copy()
    step[:, W // 2:, 0] += 10.0          # a 10 px step inside an (8, 128) tile
    leaves = smooth.copy()
    leaves[:6] -= 40.0
    leaves[-6:] += 55.0
    leaves[:, :5, 0] -= 300.0
    leaves[:, -5:, 0] += 1e6
    integer = np.zeros((H, W, 2), np.float32)
    integer[..., 0], integer[..., 1] = 3.0, -2.0
    nonfinite = smooth.copy()
    nonfinite[3, 4, 0] = np.inf
    nonfinite[5, 6, 1] = -np.inf
    nonfinite[7, 8, 0] = np.nan
    return dict(smooth=smooth, step=step, leaves=leaves, integer=integer,
                nonfinite=nonfinite)


@pytest.mark.parametrize("shape", [(96, 128), (45, 80)], ids=["96x128", "45x80"])
@pytest.mark.parametrize("kind", ["smooth", "step", "leaves", "integer", "nonfinite"])
def test_warp_plain_equals_the_jax_twin(rng, shape, kind):
    H, W = shape
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    flow = _flows(H, W)[kind].astype(np.float32)
    want = np.asarray(jflow.warp_image(jnp.asarray(img), jnp.asarray(flow)))
    got = warp.warp_image_plain(t32(img), t32(flow)).numpy()
    np.testing.assert_array_equal(got, want)     # NaN equals NaN here
    if kind == "nonfinite":
        assert np.isnan(got[7, 8]) and np.isnan(got).sum() == 1
    # the wrapper takes the plain version on a CPU tensor, and counts nothing
    n0 = warp.launches["warp_image"]
    np.testing.assert_array_equal(warp.warp_image(t32(img), t32(flow)).numpy(), got)
    assert warp.launches["warp_image"] == n0
    assert dense_flow.warp_image is warp.warp_image_plain


def test_warp_plain_matches_the_tpu_kernel_within_its_slack(rng):
    """The Pallas kernel in interpret mode, on a flow that stays within
    3 px of every tile's mean and inside the image at the top and left."""
    H, W = 96, 128
    img = _smooth_image(rng, H, W)
    flow = _flows(H, W)["smooth"]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(warp_image_pallas(jnp.asarray(img), jnp.asarray(flow)))
    got = warp.warp_image_plain(t32(img), t32(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_SLACK_ATOL)


def test_warp_follows_the_xla_twin_not_the_tpu_kernels_slack_clamp(rng):
    """The deliberate deviation: across a 10 px flow step inside one
    (8, 128) tile the TPU kernel clamps the residual to +-3 px; the port
    equals the exact XLA twin there, and the Pallas kernel does not."""
    H, W = 96, 128
    img = _smooth_image(rng, H, W)
    flow = _flows(H, W)["step"]
    twin = np.asarray(jflow.warp_image(jnp.asarray(img), jnp.asarray(flow)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(warp_image_pallas(jnp.asarray(img), jnp.asarray(flow)))
    got = warp.warp_image_plain(t32(img), t32(flow)).numpy()
    np.testing.assert_array_equal(got, twin)
    gap = np.abs(pallas - twin)
    assert gap.max() > 20.0                        # grey levels of 255
    assert (gap > 1.0).mean() > 0.2                # a large part of the image


def _pyramids(img0, img1, levels, pad):
    return ((jbuild(jnp.asarray(img0, jnp.float32), levels, pad),
             jbuild(jnp.asarray(img1, jnp.float32), levels, pad)),
            (build_pyramid(t32(img0), levels, pad), build_pyramid(t32(img1), levels, pad)))


@pytest.mark.parametrize("global_init", [True, False])
@pytest.mark.parametrize("shape", [(96, 128), (90, 126)], ids=["96x128", "90x126-odd-levels"])
def test_dense_flow_lk_matches_jax(rng, shape, global_init):
    """(90, 126) has levels of 45x63 and 22x31: the upsampling is not an
    exact 2x there."""
    H, W = shape
    base = gaussian_filter(rng.normal(size=(H + 8, W + 16)), 2.0) * 100 + 128
    img0 = base[3:3 + H, 8:8 + W]
    img1 = base[2:2 + H, 5:5 + W]           # I1(x) = I0(x - (3, 1))
    (jp0, jp1), (tp0, tp1) = _pyramids(img0, img1, 3, 8)
    want = np.asarray(jflow.dense_flow_lk(jp0, jp1, 8, iters=4, global_init=global_init))
    got = dense_flow.dense_flow_lk(tp0, tp1, 8, iters=4, global_init=global_init)
    assert got.shape == (H, W, 2) and got.dtype == torch.float32
    gap = np.abs(got.numpy() - want)
    assert gap.max() <= FLOW_ATOL and np.median(gap) <= FLOW_MEDIAN_ATOL
    inner = got.numpy()[16:-16, 16:-16]
    assert abs(np.median(inner[..., 0]) - 3.0) < 0.3
    assert abs(np.median(inner[..., 1]) - 1.0) < 0.3


def test_global_shift_matches_jax(rng):
    img = gaussian_filter(rng.normal(size=(96, 128)).astype(np.float32), 2.0)
    dy, dx = 7, -11
    i0 = img[20:84, 30:110]
    i1 = img[20 + dy:84 + dy, 30 + dx:110 + dx]
    flat = np.full((16, 24), 5.0, np.float32)      # every lag ties: the first wins
    two = np.zeros((16, 24), np.float32)
    two[4, 5] = two[9, 13] = 1.0                   # two equal peaks
    for a, b in ((i0, i1), (i1, i0), (i0, i0), (flat, flat), (two, two)):
        want = np.asarray(jflow.global_shift(jnp.asarray(a), jnp.asarray(b)))
        got = dense_flow.global_shift(t32(a), t32(b))
        assert got.dtype == torch.float32 and got.shape == (2,)
        np.testing.assert_array_equal(got.numpy(), want)
    got = dense_flow.global_shift(t32(i0), t32(i1)).numpy()
    assert abs(got[0] + dx) <= 1 and abs(got[1] + dy) <= 1


def test_flow_epe_binned_matches_jax(rng):
    gt = (rng.normal(size=(40, 50, 2)) * 25).astype(np.float32)
    est = gt + rng.normal(size=gt.shape).astype(np.float32)
    valid = rng.uniform(size=(40, 50)) < 0.7
    for v in (None, valid):
        want = jepe(jnp.asarray(gt), jnp.asarray(est), None if v is None else jnp.asarray(v))
        got = flow_epe_binned(t32(gt), t32(est), None if v is None else torch.tensor(v))
        assert set(got) == {"all", "s<10", "s10-40", "s>=40"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    empty = flow_epe_binned(t32(gt), t32(est), torch.zeros(40, 50, dtype=torch.bool))
    assert float(empty["all"]) == 0.0


def test_evaluate_pair_matches_jax(rng):
    """One 160x120 pair through all three estimators at the benchmark's
    patch side 32 (K5's plain version at psz 32)."""
    wh = (160, 120)
    scene = synthetic.make_scene(rng, wh=wh, fc=(0.9 * wh[0], 0.95 * wh[0]),
                                 freq_range=(0.3, 4.0))
    G0 = geo.se3_exp(np.zeros(6))
    G1 = geo.se3_exp(np.r_[0.12, 0.05, 0.015, 0.0006, 0.0009, 0.00045])
    img0, img1 = synthetic.render(scene, G0), synthetic.render(scene, G1)
    want = jbench.evaluate_pair(scene, G0, G1, img0, img1)
    got = flow_bench.evaluate_pair(scene, G0, G1, img0, img1, device="cpu")
    np.testing.assert_array_equal(flow_bench.plane_gt_flow(scene, G0, G1),
                                  jbench.plane_gt_flow(scene, G0, G1))
    np.testing.assert_array_equal(flow_bench._grid_points(wh, 32, 16),
                                  jbench._grid_points(wh, 32, 16))
    assert got["gt_mag_mean"] == pytest.approx(want["gt_mag_mean"], rel=1e-6)
    for method in ("lk", "ncc", "mosse"):
        for k, v in want[method].items():
            assert abs(got[method][k] - v) <= EPE_ATOL, (method, k, got[method][k], v)
        np.testing.assert_allclose(got["_raw"][method][1], want["_raw"][method][1],
                                   rtol=0, atol=RAW_ATOL)
    assert np.isfinite(got["lk"]["all"]) and got["lk"]["all"] < 1.0


def test_run_benchmark_needs_no_oracle_and_defaults_to_the_card():
    """``run_benchmark`` takes its poses from the port's own ``se3_exp``;
    without a card and without ``device`` it raises instead of running on
    the CPU."""
    agg, rows = flow_bench.run_benchmark(np.random.default_rng(3), wh=(96, 72),
                                         n_pairs=1, device="cpu")
    assert set(agg) == {"lk", "ncc", "mosse"} and len(rows) == 1
    assert all(np.isfinite(v) for m in agg.values() for v in m.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            flow_bench.run_benchmark(np.random.default_rng(3), wh=(96, 72), n_pairs=1)


def test_viz_copy_equals_the_original(rng):
    np.testing.assert_array_equal(viz.make_colorwheel(), jviz.make_colorwheel())
    u = rng.normal(size=(30, 40)) * 6
    v = rng.normal(size=(30, 40)) * 6
    u[0, 0] = v[0, 0] = 0.0
    for kw in ({}, {"logscale": False}):
        np.testing.assert_array_equal(viz.viz_flow(u, v, **kw), jviz.viz_flow(u, v, **kw))
