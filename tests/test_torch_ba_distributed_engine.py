"""The engine's routes to the port's multi-device bundle adjustment
(``VOConfig.ba_mesh``, ``VOConfig.ba_temporal_mesh``) against the JAX
package's, mirroring tests/test_vo_engine.py's sharded-BA cases.  The
port's engines run in one world of 2 gloo ranks shared by the module's
cases.  Helpers and tolerances as in tests/test_torch_ba_distributed.py;
the temporal route is held to the JAX package's float64 run (see
there).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from invcompcamtrack_tpu.vo import synthetic
from tests import torch_dist_helpers as dh
from tests.oracles import geometry_np as geo
from tests.test_torch_ba_distributed import _gap, _mesh, _replicated, _tol, worlds
from tests.test_vo_engine import _camera_path
import tests.torch_helpers  # noqa: F401  (one torch thread per process)


# the engine cases: tests/test_vo_engine.py::_small_setup's sequence
ENGINE_TRACKER = dict(lv_f=2, lv_l=0, psz=8, maxiter=6)
ENGINE_CFG = dict(max_landmarks=128, window=4, keyframe_stride=2, corners_per_kf=128,
                  min_parallax_px=0.5)


def _engine_inputs(n_frames, **cfg):
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, wh=(192, 144), fc=(170.0, 172.0), freq_range=(2.0, 20.0))
    poses_gt = _camera_path(rng, n_frames)
    imgs = [synthetic.render(scene, geo.se3_exp(p)).astype(np.float32) for p in poses_gt]
    seeds = synthetic.sample_plane_points(scene, rng, 100, margin=20).astype(np.float32)
    return dict(imgs=imgs, poses_gt=poses_gt, seeds=seeds, fc=scene.fc, cc=scene.cc,
                wh=scene.wh, cfg_kw=dict(ENGINE_CFG, **cfg), tracker_kw=ENGINE_TRACKER)


def _engine_cases():
    return {"e_landmark": _engine_inputs(10, ba_mode="full"),
            "e_temporal": _engine_inputs(14, ba_mode="full"),
            "e_hybrid": _engine_inputs(12, ba_mode="hybrid")}


@pytest.fixture(scope="module")
def engines():
    return _engine_cases()


@pytest.fixture(scope="module")
def world(engines, tmp_path_factory):
    return worlds(lambda n: {
        "e_landmark": ("job_engine", dict(engines["e_landmark"], mesh_axis="model")),
        "e_temporal": ("job_engine", dict(engines["e_temporal"], temporal_axis="seq")),
        "e_hybrid": ("job_engine", dict(engines["e_hybrid"], temporal_axis="seq"))},
        tmp_path_factory)


def _jax_engine(case, dtype=jnp.float32, **mesh_kw):
    """The JAX package's engine on an engine case's frames: its poses
    (T - 2, 6)."""
    from invcompcamtrack_tpu.config import ICGNParams as JParams
    from invcompcamtrack_tpu.core.camera import CameraPyramid as JCam
    from invcompcamtrack_tpu.vo.engine import VisualOdometry as JVO
    from invcompcamtrack_tpu.vo.engine import VOConfig as JConfig

    jtr = JParams(**ENGINE_TRACKER)
    fc, cc, wh = case["fc"], case["cc"], case["wh"]
    jcam = JCam.create(fc, cc, wh, jtr.num_levels, jtr.psz)
    vo = JVO(jcam, fc, cc, JConfig(tracker=jtr, **case["cfg_kw"], **mesh_kw), dtype=dtype)
    vo.bootstrap(case["imgs"][0], case["imgs"][1], case["poses_gt"][0], case["poses_gt"][1],
                 case["seeds"])
    return np.stack([vo.process_frame(im) for im in case["imgs"][2:]])


def test_vo_engine_landmark_sharded_ba_parity(engines, world):
    """VOConfig.ba_mesh with ba_mode="full": every keyframe's joint BA,
    the solve that all-reduces the pose blocks, landmark-sharded over 2
    ranks, writes the poses.  It equals the port's one-device engine
    within GAP_FACTOR x the JAX package's own ba_mesh-vs-one-device gap
    on these frames (both measured here: 1.5e-6 and 2.7e-6), and the JAX
    package's ba_mesh engine within the port-vs-JAX engine limit
    tests/test_torch_engine.py sets on this sequence (POSE_TOL, 1.5e-4;
    measured 8.1e-5)."""
    from tests.test_torch_engine import POSE_TOL

    case = engines["e_landmark"]
    poses, lms, valid = _replicated(world(2), "e_landmark")
    p1, l1, v1 = dh.run_engine(**case)
    j_single = _jax_engine(case)
    j_mesh = _jax_engine(case, ba_mesh=_mesh(2, "model"))
    np.testing.assert_allclose(poses, p1, rtol=0, atol=_tol(_gap(j_mesh, j_single)))
    np.testing.assert_allclose(poses, j_mesh, rtol=0, atol=POSE_TOL)
    assert int(valid.sum()) > 50


# The temporal joint phase inverts each landmark's 3x3 block by cofactors
# with no eigen floor, so a landmark seen twice under a small angle takes
# a long step along its ray, and rounding decides which.  The JAX
# package's float32 run rounds many of those steps away; its float64 run
# takes them, as the port's float32 run does.  So the temporal route is
# held to the JAX package's float64 run, which
# test_temporal_engine_gap_of_the_jax_package measures on these 14 frames
# (2 devices, 2 ranks): JAX float64 parts from JAX's float32 one-device
# engine by 0.0471 and ends 0.0478 from the truth, the port by 0.0468 and
# 0.0475, within 2.5e-4 of JAX float64 and 0.040 of JAX float32, which
# parts from its one-device engine by 0.0071.  The limits are about 1.5 x
# JAX float64's figures.
TEMPORAL_ENGINE_GAP = 0.07
TEMPORAL_ENGINE_GT_ERR = 0.07
# The port's temporal engine (2 ranks) against the JAX package's float64
# one (2 devices) on the same frames: measured 2.5e-4; the limit is 4 x.
PORT_VS_JAX64_TEMPORAL_ENGINE = 1e-3


def test_vo_engine_temporal_sharded_ba_parity(engines, world):
    """VOConfig.ba_temporal_mesh: the joint phase keyframe-sharded over 2
    ranks stays finite, within TEMPORAL_ENGINE_GAP of the one-device
    engine and as accurate against the truth as the JAX package's
    float64 run."""
    case = engines["e_temporal"]
    poses, lms, valid = _replicated(world(2), "e_temporal")
    p_single, _, _ = dh.run_engine(**case)
    assert np.all(np.isfinite(poses))
    np.testing.assert_allclose(poses, p_single, atol=TEMPORAL_ENGINE_GAP)
    gt = np.stack([geo.se3_log(geo.se3_exp(p)) for p in case["poses_gt"][2:]])
    assert np.abs(poses - gt).max() < TEMPORAL_ENGINE_GT_ERR
    assert int(valid.sum()) > 50


def test_vo_engine_temporal_hybrid_polish(engines, world):
    """ba_temporal_mesh with the hybrid default: the joint phase is the
    motion-only pose polish through the temporal solver; the engine stays
    finite and accurate (JAX's limit, 0.05)."""
    case = engines["e_hybrid"]
    poses, _, _ = _replicated(world(2), "e_hybrid")
    assert np.all(np.isfinite(poses))
    gt = np.stack([geo.se3_log(geo.se3_exp(p)) for p in case["poses_gt"][2:]])
    assert np.abs(poses - gt).max() < 0.05


@pytest.mark.slow
def test_temporal_engine_gap_of_the_jax_package(tmp_path):
    """Measures what TEMPORAL_ENGINE_GAP and TEMPORAL_ENGINE_GT_ERR rest
    on, on the parity test's sequence: the JAX package's temporal engine
    (2 devices) in float32 and float64 against its one-device engine in
    float32 and the truth; and holds the port's temporal engine (2 ranks)
    to JAX's float64 one within PORT_VS_JAX64_TEMPORAL_ENGINE (about 3
    minutes of compilation)."""
    case = _engine_inputs(14, ba_mode="full")
    out = {"single": _jax_engine(case),
           "temporal32": _jax_engine(case, ba_temporal_mesh=_mesh(2, "seq")),
           "temporal64": _jax_engine(case, jnp.float64, ba_temporal_mesh=_mesh(2, "seq"))}
    port = dh.run_world(2, [("job_engine", dict(case, temporal_axis="seq"))], tmp_path)
    out["port"] = port[0][0][0]
    gt = np.stack([geo.se3_log(geo.se3_exp(p)) for p in case["poses_gt"][2:]])
    for name in ("temporal32", "temporal64", "port"):
        print(f"{name}: vs JAX float32 one-device {_gap(out['single'], out[name]):.4g}, "
              f"vs truth {float(np.abs(out[name] - gt).max()):.4g}")
    print(f"port vs JAX float64 temporal {_gap(out['port'], out['temporal64']):.4g}, vs "
          f"JAX float32 temporal {_gap(out['port'], out['temporal32']):.4g}")
    gap = _gap(out["single"], out["temporal64"])
    gt_err = float(np.abs(out["temporal64"] - gt).max())
    assert 1.4 * gap <= TEMPORAL_ENGINE_GAP and 1.4 * gt_err <= TEMPORAL_ENGINE_GT_ERR
    assert _gap(out["port"], out["temporal64"]) <= PORT_VS_JAX64_TEMPORAL_ENGINE
