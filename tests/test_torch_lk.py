"""The port's sparse LK tracker and descriptors (``match/lk.py``,
``match/descriptors.py``) and K5's plain version at the patch sides their
callers use, against the JAX package on the same seeded inputs, on the
CPU.

Tolerances, from measurements on these very inputs:
- K5's plain version vs the JAX XLA twin ``extract_patches`` at psz 18
  and 32: the same float operations in the same order: exact.  With the
  patch mean removed, the mean of 324 or 1024 floats of up to 255 is
  summed in another order: measured 1.3e-4 and 1.04e-3; MEAN_ATOL =
  5e-4 and 4e-3.
- ``track_points_lk`` / ``lk_forward_backward``: per level a 2x2 solve
  from 64-pixel sums (other summation orders) and 8 masked updates,
  three levels.  Measured port-vs-JAX gap over the valid points: max
  1.9e-6 px with and without the window cache, 3.8e-6 px with
  ``init_xy``, 7.6e-6 px at psz 6; JAX's own float32-vs-float64 gap on
  the first two calls: max 5.3e-6 px.  LK_ATOL = 5e-5 px; the validity
  masks are equal.
- ``sift_like_descriptors``: unit vectors of 128 entries <= 0.2;
  ``atan2`` and the soft bins round differently: measured 7.5e-8;
  DESC_ATOL = 1e-6.  ``ratio_match``: indices and masks equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from invcompcamtrack_tpu.image import patch as jpatch
from invcompcamtrack_tpu.image.pyramid import build_pyramid as jbuild
from invcompcamtrack_tpu.match import descriptors as jdesc
from invcompcamtrack_tpu.match import lk as jlk
from invcompcamtrack_torch.image.patch import extract_patches
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.match import descriptors, lk
from invcompcamtrack_torch.ops import patch_gather
from tests.torch_helpers import t32

LK_ATOL = 5e-5
DESC_ATOL = 1e-6
MEAN_ATOL = {18: 5e-4, 32: 4e-3}
H, W, L = 96, 128, 3


@pytest.fixture(scope="module")
def pair():
    """Two 128x96 crops of one smooth texture, the second moved by
    (+2.6, -1.4) px, and 48 points (two outside, one non-finite)."""
    rng = np.random.default_rng(5)
    big = gaussian_filter(rng.normal(size=(2 * H + 40, 2 * W + 40)), 4.0) * 600 + 128
    ys, xs = np.mgrid[0:H, 0:W]

    def crop(dx, dy):                      # bilinear crop of the 2x texture
        y, x = 2 * (ys + dy) + 20, 2 * (xs + dx) + 20
        y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
        fy, fx = y - y0, x - x0
        return ((1 - fy) * (1 - fx) * big[y0, x0] + (1 - fy) * fx * big[y0, x0 + 1]
                + fy * (1 - fx) * big[y0 + 1, x0] + fy * fx * big[y0 + 1, x0 + 1]
                ).astype(np.float32)

    img_a, img_b = crop(0.0, 0.0), crop(-2.6, 1.4)
    xy = np.r_[rng.uniform([12, 12], [W - 12, H - 12], size=(45, 2)),
               [[-4.0, 20.0], [W + 3.0, 50.0], [np.nan, 30.0]]].astype(np.float32)
    return img_a, img_b, xy


def _pyrs(pair, psz):
    img_a, img_b, _ = pair
    return ([jbuild(jnp.asarray(im), L, psz) for im in (img_a, img_b)],
            [build_pyramid(t32(im), L, psz) for im in (img_a, img_b)])


@pytest.mark.parametrize("psz", [18, 32])
def test_k5_plain_equals_the_xla_twin_at_the_new_callers_patch_sides(pair, psz):
    img_a, _, xy = pair
    centers = np.r_[xy[:45], [[0.0, 0.0], [W, H], [0.2, H], [W, 3.5]]].astype(np.float32)
    jl = jbuild(jnp.asarray(img_a), 1, psz)[0]
    tl = build_pyramid(t32(img_a), 1, psz)[0]
    for pn in (False, True):
        want = np.asarray(jpatch.extract_patches(jl.img, jnp.asarray(centers), psz, psz,
                                                 patch_norm=pn, use_pallas=False))
        got = patch_gather.gather_patches_plain(tl.img, t32(centers), psz, psz, pn)
        assert got.shape == (len(centers), psz, psz)
        if pn:   # the mean of psz*psz floats is summed in another order
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MEAN_ATOL[psz])
        else:
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            extract_patches(tl.img, t32(centers), psz, psz, pn).numpy(), got.numpy())


@pytest.mark.parametrize("kw", [
    dict(), dict(window_cache=False), dict(init=True), dict(psz=6, max_iters=5),
], ids=["cache", "nocache", "init_xy", "psz6"])
def test_track_points_lk_matches_jax(pair, kw):
    _, _, xy = pair
    kw = dict(kw)
    init = xy + np.float32([2.0, -1.0]) if kw.pop("init", False) else None
    psz = kw.get("psz", 8)
    jp, tp = _pyrs(pair, psz)
    want, ok_j = jlk.track_points_lk(jp[0], jp[1], jnp.asarray(xy),
                                     init_xy=None if init is None else jnp.asarray(init),
                                     **kw)
    got, ok = lk.track_points_lk(tp[0], tp[1], t32(xy),
                                 init_xy=None if init is None else t32(init), **kw)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    assert ok_j[:45].sum() >= 40 and not ok_j[45:].any()
    np.testing.assert_allclose(got.numpy()[ok_j], np.asarray(want)[ok_j], rtol=0,
                               atol=LK_ATOL)
    step = (got.numpy() - xy)[ok_j]
    np.testing.assert_allclose(np.median(step, axis=0), [2.6, -1.4], atol=0.1)


@pytest.mark.parametrize("with_init", [False, True], ids=["plain", "init_xy"])
def test_lk_forward_backward_matches_jax(pair, with_init):
    _, _, xy = pair
    jp, tp = _pyrs(pair, 8)
    init = xy + np.float32([2.0, -1.0]) if with_init else None
    want, ok_j = jlk.lk_forward_backward(
        jp[0], jp[1], jnp.asarray(xy), init_xy=None if init is None else jnp.asarray(init))
    got, ok = lk.lk_forward_backward(tp[0], tp[1], t32(xy),
                                     init_xy=None if init is None else t32(init))
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    assert ok_j.sum() >= 35
    np.testing.assert_allclose(got.numpy()[ok_j], np.asarray(want)[ok_j], rtol=0,
                               atol=LK_ATOL)


def test_descriptors_and_ratio_match_match_jax(pair):
    img_a, img_b, xy = pair
    pad = 12
    centers_a = xy[:45]
    centers_b = centers_a + np.float32([2.6, -1.4])
    descs = {}
    for name, im, c in (("a", img_a, centers_a), ("b", img_b, centers_b)):
        jl = jbuild(jnp.asarray(im), 1, pad)[0]
        tl = build_pyramid(t32(im), 1, pad)[0]
        want = np.asarray(jdesc.sift_like_descriptors(jl.img, jnp.asarray(c), pad))
        got = descriptors.sift_like_descriptors(tl.img, t32(c), pad)
        assert got.shape == (45, 128) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DESC_ATOL)
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)
        descs[name] = (got, want)
    for ratio in (0.8, 0.95):
        idx_j, ok_j = jdesc.ratio_match(jnp.asarray(descs["b"][1]),
                                        jnp.asarray(descs["a"][1]), ratio)
        idx, ok = descriptors.ratio_match(descs["b"][0], descs["a"][0], ratio)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    # the same scene points, moved: most queries find their own model point
    assert int(ok.sum()) >= 20
    assert (idx.numpy()[ok.numpy()] == np.arange(45)[ok.numpy()]).mean() > 0.9
