"""The tracker's non-fused paths and the odometry verifier
(``solver/icgn.py``, ``solver/chain.py``) against the JAX package on the
CPU, where every kernel wrapper takes its plain version.

Three 192x160 frames of one textured plane (the tests/test_cli.py
scene), 40 points, levels 2 -> 0, at most 6 iterations.

Tolerances, from measurements on these very inputs (float32 on both
sides; the JAX tracker's own float32-vs-float64 gap beside each).  A
scene this small determines the pose only to about 1e-4 in float32, so
the JAX tracker's own gap is large; the port repeats the JAX package's
operations nearly in its order and stays far closer to it.
- Poses of ``track_pose`` with psz 4 (window cache on, and off with
  dopatchnorm) and psz 8 with ``window_cache=False``: port-vs-JAX
  0.4e-6 to 7e-6, JAX
  float32-vs-float64 1e-6 to 8e-5: POSE_ATOL 2e-5, as in
  tests/test_torch_icgn.py.  Hessians: 6e-6 of the largest entry (JAX's
  own gap 5e-5 to 8e-5): rtol 2e-5 of the largest entry.
- ``track_nposes``: poses port-vs-JAX 1.6e-6 to 5.9e-6 (JAX's own gap
  2e-6 to 1.4e-4): POSE_ATOL.  Correlations 3e-7 to 1.3e-6 (JAX's own
  5e-7 to 5.6e-4): atol 1e-5; the -1 entries must coincide.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.config import ICGNParams
from invcompcamtrack_tpu.core.camera import CameraPyramid as JCam
from invcompcamtrack_tpu.image.pyramid import build_pyramid as jbuild
from invcompcamtrack_tpu.solver import chain as jchain
from invcompcamtrack_tpu.solver import icgn as jicgn
from invcompcamtrack_tpu.vo import synthetic
from invcompcamtrack_torch import convert
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core import pose as pose_ops
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.image.taps import bilinear_base, clamp_to_fit
from invcompcamtrack_torch.ops import ncc3
from invcompcamtrack_torch.solver import chain, icgn
from tests.oracles import geometry_np as geo
from tests.torch_helpers import t32

POSE_ATOL = 2e-5
N = 40
LEVELS = 3


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, wh=(192, 160), fc=(180.0, 184.0))
    poses = [np.zeros(6)]
    for _ in range(2):
        poses.append(poses[-1] + np.r_[rng.normal(size=3) * 0.01,
                                       rng.normal(size=3) * 0.004])
    imgs = [synthetic.render(scene, geo.se3_exp(p)).astype(np.float32) for p in poses]
    X = synthetic.sample_plane_points(scene, rng, N, margin=20).astype(np.float32)
    return dict(scene=scene, poses=np.stack(poses), imgs=imgs, X=X)


@pytest.mark.parametrize("kw", [
    dict(psz=4),
    dict(psz=8, window_cache=False),
    dict(psz=4, window_cache=False, dopatchnorm=True, donorm=False),
], ids=["psz4", "psz8-nocache", "psz4-nocache-patchnorm-nonorm"])
def test_track_pose_non_fused_paths_match_jax(frames, kw):
    cfg = ICGNParams(lv_f=2, lv_l=0, maxiter=6, normdp_ratio=0.01, **kw)
    sc, imgs, X = frames["scene"], frames["imgs"], frames["X"]
    Xb = np.stack([X, X[::-1]])
    mask = np.ones((2, N), bool)
    mask[1, ::3] = False
    p0 = np.zeros((2, 6), np.float32)
    p0[1] = [0.005, -0.005, 0.002, 0.001, -0.001, 0.0]
    jcam = JCam.create(sc.fc, sc.cc, sc.wh, LEVELS, cfg.psz)
    p_j, aux_j = jicgn.track_pose(
        jbuild(jnp.asarray(imgs[1]), LEVELS, cfg.psz),
        jbuild(jnp.asarray(imgs[2]), LEVELS, cfg.psz),
        jnp.asarray(Xb), jnp.asarray(p0), jcam, cfg, point_mask=jnp.asarray(mask),
        return_aux=True)
    p, aux = icgn.track_pose(
        build_pyramid(t32(imgs[1]), LEVELS, cfg.psz),
        build_pyramid(t32(imgs[2]), LEVELS, cfg.psz),
        t32(Xb), t32(p0), convert.camera_from_numpy(jcam, "cpu"), cfg,
        point_mask=torch.as_tensor(mask), return_aux=True)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(aux.iters.numpy(), np.asarray(aux_j.iters))
    np.testing.assert_array_equal(aux.valid_ref.numpy(), np.asarray(aux_j.valid_ref))
    H_j = np.asarray(aux_j.hessian)
    scale = np.abs(H_j).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(aux.hessian.numpy() - H_j) <= 2e-5 * scale)
    # and it moves toward the truth: frame 1 seen from frame 2
    assert bool(torch.isfinite(p).all())


@pytest.fixture(scope="module")
def nposes_case(frames):
    """Four hypotheses for the middle frame: the truth, a nearby pose, a
    catastrophically wrong one (on a plane a mildly wrong pose is
    homography-consistent and still verifies) and one that sends points
    off the frame; partial inlier masks."""
    p1 = frames["poses"][1]
    hyp = np.stack([p1, p1 + np.r_[0.002, -0.001, 0.001, 0.0005, 0.0, 0.0005],
                    p1 + np.r_[0.6, -0.5, 0.3, 0.25, -0.2, 0.15],
                    p1 + np.r_[0.0, 0.0, 0.0, 1.2, 0.0, 0.0]]).astype(np.float32)
    masks = np.ones((4, N), bool)
    masks[1, ::4] = False
    masks[2, 5:9] = False
    masks[3, 1::2] = False
    cfg = ICGNParams(lv_f=2, lv_l=0, psz=8, maxiter=6, normdp_ratio=0.01)
    sc = frames["scene"]
    jcam = JCam.create(sc.fc, sc.cc, sc.wh, LEVELS, 8)
    want = jchain.track_nposes(
        [jbuild(jnp.asarray(im), LEVELS, 8) for im in frames["imgs"]],
        jnp.asarray(hyp), jnp.asarray(frames["X"]), jnp.asarray(masks), jcam, cfg,
        fb_frames=(1, 1))
    pyrs, poses, pt3d, m = convert.nposes_from_numpy(
        hyp, frames["X"], masks, frames["imgs"], num_levels=LEVELS, padding=8,
        device="cpu")
    cam = convert.camera_from_numpy(jcam, "cpu")
    before = dict(ncc3.launches)
    got = chain.track_nposes(pyrs, poses, pt3d, m, cam, cfg, fb_frames=(1, 1))
    assert ncc3.launches == before      # CPU tensors: K4's plain version
    return dict(want=want, got=got, masks=masks, cfg=cfg, cam=cam, jcam=jcam,
                inputs=(pyrs, poses, pt3d, m))


def test_track_nposes_matches_jax(nposes_case):
    got, want, masks = (nposes_case[k] for k in ("got", "want", "masks"))
    assert got.pose_tracks.shape == (4, 3, 6) and got.correlations.shape == (4, N)
    np.testing.assert_allclose(got.pose_tracks.numpy(), np.asarray(want.pose_tracks),
                               rtol=0, atol=POSE_ATOL)
    corr, corr_j = got.correlations.numpy(), np.asarray(want.correlations)
    np.testing.assert_array_equal(corr == -1.0, corr_j == -1.0)
    assert np.all(corr[~masks] == -1.0)
    # hypothesis 3 projects inliers off the frame: -1 beyond the mask
    assert (corr[3] == -1.0).sum() > (~masks[3]).sum()
    np.testing.assert_allclose(corr, corr_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.mean_corr.numpy(), np.asarray(want.mean_corr),
                               rtol=0, atol=1e-5)
    assert got.mean_corr[0] > 0.8 and got.mean_corr[1] > 0.8
    assert got.mean_corr[2] < got.mean_corr[0] and got.mean_corr[3] < got.mean_corr[0]


def test_select_best_matches_jax(nposes_case):
    got, want = nposes_case["got"], nposes_case["want"]
    for valid in ([True] * 4, [False, True, True, True], [False, False, True, True]):
        best, score = chain.select_best(got, torch.tensor(valid))
        best_j, score_j = jchain.select_best(want, jnp.asarray(valid))
        assert int(best) == int(best_j)
        np.testing.assert_allclose(float(score), float(score_j), rtol=0, atol=1e-5)


def test_track_nposes_does_not_depend_on_the_border_rule(nposes_case):
    """The kernels' border rule (a support that would leave the plane is
    moved back inside it) never acts on a point that counts: a score
    enters the result only where the reprojection is strictly inside the
    frame, and there the support, at most psz/2 + 1 <= pad pixels past
    the frame, lies inside the padded plane as it is.  Every other entry
    is -1 or has weight 0."""
    pyrs, poses, pt3d, m = nposes_case["inputs"]
    cfg, cam, got = nposes_case["cfg"], nposes_case["cam"], nposes_case["got"]
    lvl, pad = cfg.lv_l, cfg.psz
    Hp, Wp = pyrs[0][lvl].img.shape
    Xb = pt3d.expand((poses.shape[0],) + tuple(pt3d.shape))
    Xn, mean, varval = pose_ops.normalize_points(Xb, mask=m)
    fx, fy, cx, cy, swo, sho = cam.level(lvl)
    n_inside = 0
    for k in range(3):
        pn = pose_ops.normalize_pose(got.pose_tracks[:, k], mean, varval)
        uv = pose_ops.project_points(lie.se3_exp(pn), Xn, fx, fy, cx, cy)
        inside = chain._strict_inside(uv, swo, sho)
        row0, col0, _ = bilinear_base(uv[inside], cfg.psz, pad)
        assert bool(torch.all(clamp_to_fit(row0, cfg.psz + 1, Hp) == row0))
        assert bool(torch.all(clamp_to_fit(col0, cfg.psz + 1, Wp) == col0))
        n_inside += int(inside.sum())
        if k == 1:
            assert bool(torch.all(got.correlations[~(m & inside)] == -1.0))
            assert bool(torch.all(got.correlations[m & inside] >= 0.0))
    # the case does hold points outside the frame, and the frame's edge
    # rows are reachable: a center just inside the corner keeps its support
    assert n_inside < 3 * m.numel()
    edge = torch.tensor([[1e-4, 1e-4], [float(swo) - 1e-4, float(sho) - 1e-4]])
    row0, col0, _ = bilinear_base(edge, cfg.psz, pad)
    assert bool(torch.all(clamp_to_fit(row0, cfg.psz + 1, Hp) == row0))
    assert bool(torch.all(clamp_to_fit(col0, cfg.psz + 1, Wp) == col0))


def test_chain_cfg_paths(frames, nposes_case):
    """The verifier with psz 4 (K6/K7 tracker path, K4 at psz 4) runs and
    ranks the hypotheses alike; gather_prefetch changes nothing there."""
    pyrs4, poses, pt3d, m = convert.nposes_from_numpy(
        nposes_case["inputs"][1].numpy(), frames["X"], nposes_case["masks"],
        frames["imgs"], num_levels=LEVELS, padding=4, device="cpu")
    sc = frames["scene"]
    cam4 = convert.camera_from_numpy(JCam.create(sc.fc, sc.cc, sc.wh, LEVELS, 4), "cpu")
    cfg4 = dataclasses.replace(nposes_case["cfg"], psz=4)
    res = chain.track_nposes(pyrs4, poses, pt3d, m, cam4, cfg4, fb_frames=(1, 1))
    assert bool(torch.isfinite(res.pose_tracks).all())
    assert int(chain.select_best(res, torch.ones(4, dtype=torch.bool))[0]) in (0, 1)
    # gather_prefetch asks for K9, which serves psz 8 only: at psz 4 the
    # flag changes nothing (the JAX tracker's own branch)
    pre = chain.track_nposes(pyrs4, poses, pt3d, m, cam4,
                             dataclasses.replace(cfg4, gather_prefetch=True))
    assert torch.equal(pre.pose_tracks, res.pose_tracks)
    assert torch.equal(pre.correlations, res.correlations)
