"""``ops/lk_step.py`` on the CPU: one dense LK iteration's plain version,
which ``match/dense_flow.py`` iterates on a CPU tensor, against a frozen
copy of the eager loop it replaced, bit for bit; the wrapper takes the
plain version on a CPU tensor and launches nothing.  The kernel is held
to the plain version on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 3d); the kernel's summation order is held to the
plain version's here.

The witness below is ``match/dense_flow.py::_lk_refine`` as it was
before ``lk_step``: the structure tensor once per level, then per
iteration the warp, two box sums, the closed-form solve and
``flow - where(good, upd, 0)``.  The plain version recomputes the
structure tensor from I0 in every iteration and subtracts in place; both
are the same float operations on the same floats, so no tolerance.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter

from invcompcamtrack_torch.image.pyramid import build_pyramid, central_gradients
from invcompcamtrack_torch.match import dense_flow
from invcompcamtrack_torch.ops import lk_step, warp
from tests.torch_helpers import t32

MIN_DET = 1e-4


def _witness_box(x, radius):
    k = 2 * radius + 1
    kernel = torch.ones((1, 1, k, k), dtype=x.dtype, device=x.device)
    return F.conv2d(x[None, None], kernel, padding=radius)[0, 0]


def _witness_lk_refine(I0, I1, flow, iters, radius, min_det):
    Ix, Iy = central_gradients(I0)
    Ix = Ix * 0.5
    Iy = Iy * 0.5
    a11 = _witness_box(Ix * Ix, radius)
    a12 = _witness_box(Ix * Iy, radius)
    a22 = _witness_box(Iy * Iy, radius)
    det = a11 * a22 - a12 * a12
    good = det > min_det
    det_safe = torch.where(good, det, torch.ones_like(det))
    for _ in range(iters):
        It = warp.warp_image(I1, flow) - I0
        b1 = _witness_box(Ix * It, radius)
        b2 = _witness_box(Iy * It, radius)
        du = (a22 * b1 - a12 * b2) / det_safe
        dv = (a11 * b2 - a12 * b1) / det_safe
        upd = torch.stack([du, dv], dim=-1)
        flow = flow - torch.where(good[..., None], upd, torch.zeros_like(upd))
    return flow


def _images(rng, H, W):
    """tests/test_torch_flow.py's pair: I1(x) = I0(x - (3, 1))."""
    base = gaussian_filter(rng.normal(size=(H + 8, W + 16)), 2.0) * 100 + 128
    return base[3:3 + H, 8:8 + W], base[2:2 + H, 5:5 + W]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _flow(kind, H, W):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    flow = np.stack([1.3 * np.sin(yy / 17.0) + 0.7 * np.cos(xx / 43.0) + 2.5,
                     1.1 * np.cos(yy / 13.0) - 0.9 * np.sin(xx / 39.0) + 0.5], -1)
    if kind == "leaves":                 # off the image on every side
        flow[:6] -= 40.0
        flow[-6:] += 55.0
        flow[:, :5, 0] -= 300.0
        flow[:, -5:, 0] += 1e6
    elif kind == "nonfinite":
        flow[30, 40, 0] = np.nan
        flow[5, 6, 1] = -np.inf
        flow[7, 8] = -0.0
    return t32(flow)


@pytest.mark.parametrize("global_init", [True, False])
@pytest.mark.parametrize("shape", [(96, 128), (90, 126)], ids=["96x128", "90x126-odd-levels"])
def test_dense_flow_lk_on_cpu_is_the_eager_loop_bit_for_bit(rng, shape, global_init,
                                                            monkeypatch):
    H, W = shape
    img0, img1 = _images(rng, H, W)
    p0, p1 = build_pyramid(t32(img0), 3, 8), build_pyramid(t32(img1), 3, 8)
    n_lk, n_k8 = lk_step.launches["lk_step"], warp.launches["warp_image"]
    got = dense_flow.dense_flow_lk(p0, p1, 8, iters=4, global_init=global_init)
    assert lk_step.launches["lk_step"] == n_lk and warp.launches["warp_image"] == n_k8
    monkeypatch.setattr(dense_flow, "_lk_refine", _witness_lk_refine)
    want = dense_flow.dense_flow_lk(p0, p1, 8, iters=4, global_init=global_init)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", ["smooth", "leaves", "nonfinite"])
@pytest.mark.parametrize("radius", [4, 2])
def test_iterating_lk_step_plain_is_the_eager_loop_bit_for_bit(rng, radius, kind):
    """Four iterations on level 0 of the 96x128 pair, through the plain
    version and through the wrapper on a CPU tensor (no launch), each
    updating its flow in place."""
    img0, img1 = _images(rng, 96, 128)
    I0, I1 = t32(img0), t32(img1)
    flow0 = _flow(kind, 96, 128)
    want = _witness_lk_refine(I0, I1, flow0.clone(), 4, radius, MIN_DET)
    n_lk = lk_step.launches["lk_step"]
    for step in (lk_step.lk_step_plain, lk_step.lk_step):
        flow = flow0.clone()
        for _ in range(4):
            out = step(I0, warp.warp_image(I1, flow), flow, radius, MIN_DET)
            assert out is flow
        assert torch.equal(_bits(flow), _bits(want))
    assert lk_step.launches["lk_step"] == n_lk
    if kind == "nonfinite":
        assert bool(want.isnan().any()) and bool(torch.isfinite(want[60:, 80:]).all())


@pytest.mark.parametrize("kind", ["leaves", "nonfinite"])
def test_lk_step_plain_keeps_every_flow_on_a_flat_image_bit_for_bit(kind):
    """A flat image has no gradient: every determinant is 0, every pixel
    fails the guard and keeps its flow, NaN, infinite and -0.0 included."""
    I0 = torch.full((45, 63), 7.0)
    flow = _flow(kind, 45, 63)
    out = lk_step.lk_step_plain(I0, I0 + 1.0, flow.clone(), 4, MIN_DET)
    assert torch.equal(_bits(out), _bits(flow))



def _lk_step_in_kernel_order(I0, I1w, flow, radius, min_det):
    """csrc/lk_step.cu's float operations in its order, one tensor op at a
    time: each window sum starts at 0 and adds the window's products one
    at a time, row by row, left to right."""
    H, W = I0.shape
    Ix, Iy = central_gradients(I0)
    Ix, Iy, It = (F.pad(t, (radius,) * 4) for t in (Ix * 0.5, Iy * 0.5, I1w - I0))

    def box(p):
        acc = torch.zeros((H, W))
        for i in range(2 * radius + 1):
            for j in range(2 * radius + 1):
                acc = acc + p[i:i + H, j:j + W]
        return acc

    a11, a12, a22, b1, b2 = (box(p) for p in (Ix * Ix, Ix * Iy, Iy * Iy, Ix * It, Iy * It))
    det = a11 * a22 - a12 * a12
    upd = torch.stack([(a22 * b1 - a12 * b2) / det, (a11 * b2 - a12 * b1) / det], -1)
    return torch.where((det > min_det)[..., None], flow - upd, flow)


@pytest.mark.parametrize("kind", ["smooth", "leaves", "nonfinite"])
@pytest.mark.parametrize("radius", [4, 2, 8])
@pytest.mark.parametrize("shape", [(96, 128), (45, 63)])
def test_the_kernels_summation_order_is_the_plain_versions(rng, shape, radius, kind):
    """The kernel equals the plain version on the CPU bit for bit (the card
    tests and chip_smoke.py phase 3d hold it so) because the plain
    version's box convolution sums each window in the kernel's order.
    Here that order, one tensor op at a time, against the plain version:
    bit for bit, NaN included."""
    H, W = shape
    img0, img1 = _images(rng, H, W)
    I0, I1 = t32(img0), t32(img1)
    flow = _flow(kind, H, W)
    I1w = warp.warp_image(I1, flow)
    want = lk_step.lk_step_plain(I0, I1w, flow.clone(), radius, MIN_DET)
    got = _lk_step_in_kernel_order(I0, I1w, flow, radius, MIN_DET)
    assert torch.equal(_bits(got), _bits(want)) and not torch.equal(_bits(got), _bits(flow))
