"""The port's image/ and ops/window_sample.py against the JAX package's
XLA path on the same float32 inputs.

Tolerances: the pyramid, the patch taps and the window gathers perform
the same float32 operations in the same order in both packages, so
they are compared exactly.  A patch mean is a sum of 64 values taken in
another order: 2e-5 absolute on intensities of order 255 (about 1 ulp
of the sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from invcompcamtrack_tpu.image import patch as jpatch
from invcompcamtrack_tpu.image.pyramid import build_pyramid as jbuild
from invcompcamtrack_tpu.ops import window_sample as jws
from invcompcamtrack_torch import convert
from invcompcamtrack_torch.image import patch
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.ops import window_sample as ws
from tests.torch_helpers import make_pair, t32

PSZ, PAD, WIN = 8, 8, 16


@pytest.fixture(scope="module")
def level():
    """Level 1 of both packages' pyramids of one 160x120 image, plus
    centers: interior, on the frustum border (u = 0, u = swo, v = 0,
    v = sho) and just outside it."""
    rng = np.random.default_rng(1)
    _, _, img, _, _ = make_pair(rng, 4, wh=(160, 120))
    pyr_j = jbuild(jnp.asarray(img), 3, PAD)
    pyr = build_pyramid(t32(img), 3, PAD)
    h, w = 60, 80
    centers = np.r_[np.c_[rng.uniform(1, w - 1, 24), rng.uniform(1, h - 1, 24)],
                    [[0, 0], [w, h], [0.2, h], [w, 0.7], [w, 30.5], [40.3, h],
                     [0, 30.25], [41.5, 0], [-3.2, 10.0], [w + 2.5, h + 1.5]]]
    return pyr_j[1], pyr[1], centers.astype(np.float32)


@pytest.mark.parametrize("wh,atol", [((320, 240), 0.0), ((128, 96), 6.2e-5)])
def test_build_pyramid_matches_jax(wh, atol):
    """XLA sums the 2x2 mean in a width-dependent order: bit-exact at
    320x240; at 128x96 within 1 ulp per level, 4 ulp of intensities
    below 256 on the gradients."""
    _, _, img, _, _ = make_pair(np.random.default_rng(2), 4, wh=wh)
    pyr_j = jbuild(jnp.asarray(img), 4, PAD)
    pyr = build_pyramid(t32(img), 4, PAD)
    conv = convert.pyramid_from_numpy(
        [tuple(np.asarray(a) for a in lvl) for lvl in pyr_j], "cpu")
    for lj, lt, lc in zip(pyr_j, pyr, conv):
        for a, b, c in zip(lj, lt, lc):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=atol)
            np.testing.assert_array_equal(c.numpy(), np.asarray(a))
    np.testing.assert_array_equal(pyr[0].img.numpy(), np.asarray(pyr_j[0].img))


@pytest.mark.parametrize("patch_norm", [False, True])
def test_extract_patches_match_jax(level, patch_norm):
    lj, lt, centers = level
    got = patch.extract_patches_grad(lt.img, lt.dx, lt.dy, t32(centers), PSZ, PAD,
                                     patch_norm)
    want = jpatch.extract_patches_grad(lj.img, lj.dx, lj.dy, jnp.asarray(centers),
                                       PSZ, PAD, patch_norm)
    atol = 2e-5 if patch_norm else 0.0
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0, atol=atol)
    single = patch.extract_patches(lt.img, t32(centers).reshape(2, -1, 2), PSZ,
                                   PAD, patch_norm)
    assert single.shape == (2, len(centers) // 2, PSZ, PSZ)
    np.testing.assert_allclose(
        single.numpy(),
        np.asarray(jpatch.extract_patches(lj.img, jnp.asarray(centers).reshape(2, -1, 2),
                                          PSZ, PAD, patch_norm)),
        rtol=0, atol=atol)


def test_window_origin_gather_and_resample_match_jax(level):
    lj, lt, centers = level
    origins_j = jws.window_origin(jnp.asarray(centers), PSZ, WIN, PAD)
    origins = ws.window_origin(t32(centers), PSZ, WIN, PAD)
    np.testing.assert_array_equal(origins.numpy(), np.asarray(origins_j))
    # border and outside centers put windows past the plane: both move
    # them back inside (dynamic_slice rule)
    qwin = ws.gather_windows_any(lt.img, origins, WIN)
    np.testing.assert_array_equal(
        qwin.numpy(), np.asarray(jws.gather_windows_any(lj.img, origins_j, WIN)))
    # iterates within and beyond the window slack
    moved = centers + np.random.default_rng(3).uniform(-5, 5, centers.shape)
    moved = moved.astype(np.float32)
    for pn in (False, True):
        got = ws.sample_from_windows(qwin, origins, t32(moved), PSZ, PAD, pn)
        want = jws.sample_from_windows(jnp.asarray(qwin.numpy()), origins_j,
                                       jnp.asarray(moved), PSZ, PAD, pn)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-5 if pn else 0.0)
