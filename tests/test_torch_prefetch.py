"""K9's plain version (``ops/patch_prefetch.py``) and the tracker's
``gather_prefetch=True`` route against the JAX package, on the CPU.

The TPU kernel's body does not run on the CPU backend, so the JAX side is
run as ``tests/test_patch_prefetch.py`` runs it: the package's own plan
(row-shifted plane stacks, packed index words) and post-pass (taps,
in-window gradients, masks), with the kernel body between them emulated
in numpy (decode the word, slice the named block, roll, crop).

Tolerances, from measurements on these very inputs:
- patches and gradients vs the emulated JAX path: the same taps summed
  in the same order: measured 0.0, and 1.5e-5 (1 ulp of an image in
  [0, 255]) on the mean-removed patch, whose mean is summed in another
  order; PATCH_ATOL = 1e-4.  Query windows: copies, exact, for every centre whose window
  lies inside the padded plane.
- At the frustum border (a centre with v = sho or u = swo) the window
  ends one row or column past the plane: the JAX plan clips the origin
  over an edge-padded plane, the port moves the window back inside (the
  rule of K1 in the port and of the XLA twin).  The patches agree there;
  the windows differ by a one-pixel shift, asserted below.
- ``track_pose`` with ``gather_prefetch=True``: equal to
  ``gather_prefetch=False`` bit for bit; vs the JAX tracker the
  tracker's own tolerance, 2e-5 (``tests/test_torch_icgn.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.config import ICGNParams
from invcompcamtrack_tpu.core.camera import CameraPyramid as JCam
from invcompcamtrack_tpu.image.pyramid import build_pyramid as jbuild
from invcompcamtrack_tpu.ops import patch_prefetch as jpf
from invcompcamtrack_tpu.ops.window_sample import window_origin as jorigin
from invcompcamtrack_tpu.solver import icgn as jicgn
from invcompcamtrack_torch import convert
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.ops import patch_gather, patch_prefetch
from invcompcamtrack_torch.ops import window_sample as ws
from invcompcamtrack_torch.solver import icgn
from tests.torch_helpers import make_pair, t32

PSZ, PAD, WIN = 8, 8, 16
PATCH_ATOL = 1e-4
POSE_ATOL = 2e-5


def _emulate_kernel(stack, words, wr, rows, cols):
    """Numpy twin of the TPU kernel's body: block fetch via the packed
    index word (the bit decode of its BlockSpec index maps) + lane roll."""
    out = np.empty((words.shape[0], rows, cols), np.float32)
    for i, w in enumerate(words):
        s, q, cb, roll = w & 31, (w >> 5) & 1023, (w >> 15) & 31, (w >> 20) & 127
        blk = stack[s, wr * q:wr * (q + 1), 128 * cb:128 * (cb + 1)]
        out[i] = np.roll(blk, -roll, axis=1)[:rows, :cols]
    return out


def _jax_prefetch(ref_img, query_img, centers, origins, patch_norm):
    H, W = ref_img.shape
    rplane, qplane, idx, row0, col0, w, M, _, wr = jpf._plan(
        jnp.asarray(ref_img, jnp.float32), jnp.asarray(query_img, jnp.float32),
        jnp.asarray(centers, jnp.float32), jnp.asarray(origins, jnp.int32), PSZ, PAD, WIN)
    idx = np.asarray(idx)
    raw_r = _emulate_kernel(np.asarray(rplane), idx[0::2][:M], wr, wr, jpf._RAWC)
    raw_q = _emulate_kernel(np.asarray(qplane), idx[1::2][:M], wr, WIN, WIN)
    out = jpf._postpass(jnp.asarray(raw_r), jnp.asarray(raw_q), row0, col0, w,
                        jnp.asarray(centers, jnp.float32), jnp.asarray(origins, jnp.int32),
                        PSZ, PAD, WIN, H, W, patch_norm)
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def levels():
    rng = np.random.default_rng(11)
    h, w = 64, 96
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    qimg = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    return dict(h=h, w=w, jref=jbuild(jnp.asarray(img), 1, PAD)[0],
                jqry=jbuild(jnp.asarray(qimg), 1, PAD)[0],
                ref=build_pyramid(t32(img), 1, PAD)[0],
                qry=build_pyramid(t32(qimg), 1, PAD)[0], rng=rng)


@pytest.mark.parametrize("patch_norm", [False, True])
def test_k9_plain_matches_the_jax_plan_and_postpass(levels, patch_norm):
    h, w, rng = levels["h"], levels["w"], np.random.default_rng(12)
    centers = np.stack([rng.uniform(2.0, w - 3.0, 40), rng.uniform(2.0, h - 3.0, 40)],
                       axis=-1).astype(np.float32)
    entry = centers + rng.uniform(-2, 2, centers.shape).astype(np.float32)
    origins = np.asarray(jorigin(jnp.asarray(entry), PSZ, WIN, PAD))
    np.testing.assert_array_equal(ws.window_origin(t32(entry), PSZ, WIN, PAD).numpy(), origins)
    want = _jax_prefetch(np.asarray(levels["jref"].img), np.asarray(levels["jqry"].img),
                         centers, origins, patch_norm)
    n0 = dict(patch_prefetch.launches)
    got = patch_prefetch.gather_ref_grad_windows_prefetch(
        levels["ref"], levels["qry"].img, t32(centers), torch.tensor(origins), PSZ, PAD,
        WIN, patch_norm=patch_norm)
    assert patch_prefetch.launches == n0            # a CPU tensor launches nothing
    for g, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), w_, rtol=0, atol=PATCH_ATOL)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    # K9's plain version is K1's: the same outputs by definition
    k1 = patch_gather.gather_ref_grad_windows_plain(
        levels["ref"], levels["qry"].img, t32(centers), torch.tensor(origins), PSZ, PAD,
        WIN, patch_norm=patch_norm)
    for g, w_ in zip(got, k1):
        assert torch.equal(g, w_)


def test_k9_border_rule_is_k1s_not_the_tpu_plans(levels):
    h, w = levels["h"], levels["w"]
    centers = np.array([[0.2, 0.4], [w - 1.2, h - 1.1], [0.0, h - 1.0], [w - 1.0, 0.0],
                        [float(w), float(h)], [0.2, float(h)], [float(w), 20.5]], np.float32)
    origins = np.asarray(jorigin(jnp.asarray(centers), PSZ, WIN, PAD))
    want = _jax_prefetch(np.asarray(levels["jref"].img), np.asarray(levels["jref"].img),
                         centers, origins, False)
    got = patch_prefetch.gather_ref_grad_windows_prefetch(
        levels["ref"], levels["ref"].img, t32(centers), torch.tensor(origins), PSZ, PAD, WIN)
    for g, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), w_, rtol=0, atol=PATCH_ATOL)
    qwin = got[3].numpy()
    inside = slice(0, 4)                     # windows that fit the padded plane
    np.testing.assert_array_equal(qwin[inside], want[3][inside])
    Hp, Wp = levels["ref"].img.shape
    past = (origins[:, 0] + WIN > Hp) | (origins[:, 1] + WIN > Wp)
    assert past.tolist() == [False] * 4 + [True] * 3
    plane = levels["ref"].img.numpy()
    for i in np.flatnonzero(past):           # the port moves the window back inside
        r0 = min(origins[i, 0], Hp - WIN)
        c0 = min(origins[i, 1], Wp - WIN)
        np.testing.assert_array_equal(qwin[i], plane[r0:r0 + WIN, c0:c0 + WIN])
        assert np.abs(qwin[i] - want[3][i]).max() > 1.0   # the TPU plan's clip differs


def test_supported_is_the_production_shape():
    assert patch_prefetch.supported(8, 16)
    assert not patch_prefetch.supported(4, 12)
    assert not patch_prefetch.supported(8, 12)
    assert not patch_prefetch.supported(8, 16, torch.bfloat16)
    assert patch_prefetch.gather_ref_grad_windows_prefetch_plain \
        is patch_gather.gather_ref_grad_windows_plain


@pytest.mark.parametrize("donorm,dopatchnorm", [(True, False), (False, True)])
def test_track_pose_with_gather_prefetch_equals_without_and_matches_jax(donorm, dopatchnorm):
    rng = np.random.default_rng(0)
    sc, p_gt, img_ref, img_new, X = make_pair(rng, 32)
    cfg = ICGNParams(lv_f=1, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01,
                     donorm=donorm, dopatchnorm=dopatchnorm)
    jcam = JCam.create(sc.fc, sc.cc, sc.wh, 2, 8)
    p_j = np.asarray(jicgn.track_pose(jbuild(jnp.asarray(img_ref), 2, 8),
                                      jbuild(jnp.asarray(img_new), 2, 8), jnp.asarray(X),
                                      jnp.zeros(6, jnp.float32), jcam, cfg))
    cam = convert.camera_from_numpy(jcam, "cpu")
    tr, tn = build_pyramid(t32(img_ref), 2, 8), build_pyramid(t32(img_new), 2, 8)
    base = icgn.track_pose(tr, tn, t32(X), torch.zeros(6), cam, cfg)
    pre = icgn.track_pose(tr, tn, t32(X), torch.zeros(6), cam,
                          dataclasses.replace(cfg, gather_prefetch=True))
    assert torch.equal(pre, base)
    np.testing.assert_allclose(pre.numpy(), p_j, rtol=0, atol=POSE_ATOL)
    # an unsupported shape takes the tracker's other paths, as in the JAX
    # package: psz 4 with the flag on equals psz 4 with it off
    cfg4 = dataclasses.replace(cfg, psz=4)
    cam4 = convert.camera_from_numpy(JCam.create(sc.fc, sc.cc, sc.wh, 2, 4), "cpu")
    tr4, tn4 = build_pyramid(t32(img_ref), 2, 4), build_pyramid(t32(img_new), 2, 4)
    assert torch.equal(
        icgn.track_pose(tr4, tn4, t32(X), torch.zeros(6), cam4,
                        dataclasses.replace(cfg4, gather_prefetch=True)),
        icgn.track_pose(tr4, tn4, t32(X), torch.zeros(6), cam4, cfg4))
