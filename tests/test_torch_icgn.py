"""The port's tracker (``solver/icgn.py``) end to end against the JAX
package's ``track_pose`` / ``track_pose_batch`` and the float64 numpy
oracle, on the tests/test_icgn.py scenes (320x240, psz 8), on the CPU
(so every kernel wrapper takes its plain version).

Tolerances, from measurements on these very inputs:
- Poses: the port runs the moment path of the fused TPU path; the JAX
  package on the CPU runs its steepest-descent path.  Both are exact
  rewrites of one another, summed in other orders.  The JAX tracker's
  own float32-vs-float64 gap on these calls was measured at 0.9e-6 to
  8.6e-6 (largest with donorm and dopatchnorm); the port-vs-JAX-float32
  gap at 0.5e-6 to 2.1e-6.  POSE_ATOL = 2e-5 is about twice the JAX
  float32 error itself.
- Hessians: measured port-vs-JAX gap 1.3e-6 of the largest entry, JAX's
  own float32-vs-float64 gap up to 4e-5: rtol 1e-5 of the largest entry.
- |dp| at exit is at noise level (1e-6 to 1e-4): atol 1e-5.
- iters and valid_ref are integers and must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.config import ICGNParams
from invcompcamtrack_tpu.core.camera import CameraPyramid as JCam
from invcompcamtrack_tpu.image.pyramid import build_pyramid as jbuild
from invcompcamtrack_tpu.solver import icgn as jicgn
from invcompcamtrack_torch import convert
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.solver import icgn
from tests.oracles import icgn_np
from tests.torch_helpers import make_pair, t32

POSE_ATOL = 2e-5
PORT_VS_JAX_F64 = 1e-12
N = 32


@pytest.fixture(scope="module")
def scene():
    """Three problems on one pair: the plain point set, a reversed set
    with a quarter masked out and a shifted start pose, and a set whose
    last points fall outside the image or behind the camera."""
    rng = np.random.default_rng(0)
    sc, p_gt, img_ref, img_new, X = make_pair(rng, N)
    Xb = np.stack([X, X[::-1], X.copy()])
    u = np.array([-25.0, -12.0, 345.0, 360.0])
    v = np.array([100.0, 30.0, 200.0, 260.0])
    Xb[2, -4:] = np.c_[(u - sc.cc[0]) / sc.fc[0] * 8, (v - sc.cc[1]) / sc.fc[1] * 8,
                       np.full(4, 8.0)]
    Xb[2, -6:-4] = Xb[2, :2] * np.array([1.0, 1.0, -0.25])   # behind the camera
    mask = np.ones((3, N), bool)
    mask[1, ::4] = False
    p0 = np.zeros((3, 6), np.float32)
    p0[1] = [0.01, -0.01, 0.005, 0.002, -0.001, 0.0]
    return dict(sc=sc, p_gt=p_gt, img_ref=img_ref, img_new=img_new, X=X,
                Xb=Xb.astype(np.float32), mask=mask, p0=p0)


def _jax_inputs(s, levels):
    cam = JCam.create(s["sc"].fc, s["sc"].cc, s["sc"].wh, levels, 8)
    return (jbuild(jnp.asarray(s["img_ref"]), levels, 8),
            jbuild(jnp.asarray(s["img_new"]), levels, 8), cam)


def _port_inputs(s, levels, cam_jax):
    return (build_pyramid(t32(s["img_ref"]), levels, 8),
            build_pyramid(t32(s["img_new"]), levels, 8),
            convert.camera_from_numpy(cam_jax, "cpu"))


@pytest.mark.parametrize("donorm,dopatchnorm",
                         [(True, False), (False, False), (True, True), (False, True)])
def test_track_pose_matches_jax(scene, donorm, dopatchnorm):
    cfg = ICGNParams(lv_f=1, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01,
                     donorm=donorm, dopatchnorm=dopatchnorm)
    jr, jn, jcam = _jax_inputs(scene, 2)
    p_j, aux_j = jicgn.track_pose(jr, jn, jnp.asarray(scene["Xb"]),
                                  jnp.asarray(scene["p0"]), jcam, cfg,
                                  point_mask=jnp.asarray(scene["mask"]),
                                  return_aux=True)
    tr, tn, cam = _port_inputs(scene, 2, jcam)
    p, aux = icgn.track_pose(tr, tn, t32(scene["Xb"]), t32(scene["p0"]), cam, cfg,
                             point_mask=torch.as_tensor(scene["mask"]),
                             return_aux=True)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(aux.iters.numpy(), np.asarray(aux_j.iters))
    np.testing.assert_array_equal(aux.valid_ref.numpy(), np.asarray(aux_j.valid_ref))
    assert aux.valid_ref.tolist() == [[32, 24, 26]] * 2   # mask + out-of-frustum
    np.testing.assert_allclose(aux.normdp.numpy(), np.asarray(aux_j.normdp),
                               rtol=0, atol=1e-5)
    H_j = np.asarray(aux_j.hessian)
    scale = np.abs(H_j).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(aux.hessian.numpy() - H_j) <= 1e-5 * scale)


@pytest.mark.parametrize("dopatchnorm", [False, True])
def test_track_pose_in_float64_matches_jax_in_float64(scene, dopatchnorm):
    """A float64 tracker stays in float64 as JAX's does: K1 and K2 are
    float32, so both take the non-fused path there (the fused one once
    put float32 rounding into the port's float64 engine, and a 1e-12
    change of its input moved its first tracked pose by 4e-9, JAX's by
    1e-11).  Measured on a CPU: 3.9e-15 (1.7e-8 through the fused path)."""
    cfg = ICGNParams(lv_f=1, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01,
                     dopatchnorm=dopatchnorm)
    cam_j = JCam.create(scene["sc"].fc, scene["sc"].cc, scene["sc"].wh, 2, 8)
    f64 = {k: np.asarray(scene[k], np.float64) for k in ("img_ref", "img_new", "Xb", "p0")}
    p_j = np.asarray(jicgn.track_pose(
        jbuild(jnp.asarray(f64["img_ref"]), 2, 8), jbuild(jnp.asarray(f64["img_new"]), 2, 8),
        jnp.asarray(f64["Xb"]), jnp.asarray(f64["p0"]), cam_j, cfg,
        point_mask=jnp.asarray(scene["mask"])))
    t64 = {k: torch.from_numpy(v) for k, v in f64.items()}
    p = icgn.track_pose(build_pyramid(t64["img_ref"], 2, 8), build_pyramid(t64["img_new"], 2, 8),
                        t64["Xb"], t64["p0"], convert.camera_from_numpy(cam_j, "cpu"), cfg,
                        point_mask=torch.as_tensor(scene["mask"]))
    assert p.dtype == torch.float64 and p_j.dtype == np.float64
    assert not icgn.fused_supported(8, cfg.window_size, torch.float64)
    np.testing.assert_allclose(p.numpy(), p_j, rtol=0, atol=PORT_VS_JAX_F64)


def test_track_pose_batch_matches_jax(scene):
    """The slice's entry point, B=3 problems on one pair."""
    cfg = ICGNParams(lv_f=1, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01)
    jr, jn, jcam = _jax_inputs(scene, 2)
    p_j = np.asarray(jicgn.track_pose_batch(jr, jn, jnp.asarray(scene["Xb"]),
                                            jnp.asarray(scene["p0"]), jcam, cfg,
                                            point_mask=jnp.asarray(scene["mask"])))
    tr, tn, cam = _port_inputs(scene, 2, jcam)
    p = icgn.track_pose_batch(tr, tn, t32(scene["Xb"]), t32(scene["p0"]), cam, cfg,
                              point_mask=torch.as_tensor(scene["mask"]))
    np.testing.assert_allclose(p.numpy(), p_j, rtol=0, atol=POSE_ATOL)
    # and it solves the problem: every camera center moves well toward
    # the truth (32 points, two levels: a coarse but real alignment)
    def center_err(q):
        c_gt = lie.camera_center(lie.se3_exp(t32(scene["p_gt"])))
        return (lie.camera_center(lie.se3_exp(q)) - c_gt).norm(dim=-1)

    assert bool(torch.all(center_err(p) < 0.5 * center_err(t32(scene["p0"]))))


@pytest.mark.parametrize("donorm,dopatchnorm", [(True, False), (False, True)])
def test_track_pose_matches_numpy_oracle(scene, donorm, dopatchnorm):
    """Against the loop-based float64 oracle: the port in float32 is
    within the JAX tracker's own float32-vs-float64 gap (POSE_ATOL)."""
    cfg = ICGNParams(lv_f=1, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01,
                     donorm=donorm, dopatchnorm=dopatchnorm)
    sc = scene["sc"]
    p_ora = icgn_np.track_pose(
        icgn_np.build_pyramid(scene["img_ref"].astype(np.float64), 2, 8),
        icgn_np.build_pyramid(scene["img_new"].astype(np.float64), 2, 8),
        scene["X"].astype(np.float64), np.zeros(6), sc.fc, sc.cc, sc.wh, cfg)
    cam = convert.camera_from_numpy(JCam.create(sc.fc, sc.cc, sc.wh, 2, 8), "cpu")
    p = icgn.track_pose(build_pyramid(t32(scene["img_ref"]), 2, 8),
                        build_pyramid(t32(scene["img_new"]), 2, 8),
                        t32(scene["X"]), torch.zeros(6), cam, cfg)
    np.testing.assert_allclose(p.numpy(), p_ora, rtol=0, atol=POSE_ATOL)


def test_unported_paths_raise_and_tpu_only_flags_change_nothing(scene):
    sc = scene["sc"]
    cam = convert.camera_from_numpy(JCam.create(sc.fc, sc.cc, sc.wh, 2, 8), "cpu")
    tr = build_pyramid(t32(scene["img_ref"]), 2, 8)
    tn = build_pyramid(t32(scene["img_new"]), 2, 8)
    X, p0 = t32(scene["X"]), torch.zeros(6)
    cfg = ICGNParams(lv_f=1, lv_l=0, maxiter=4)
    # no path is left unported: K9's flag runs and gives K1's poses bit for
    # bit (tests/test_torch_prefetch.py holds it against the JAX tracker;
    # tests/test_torch_chain.py the non-fused paths)
    ref = icgn.track_pose(tr, tn, X, p0, cam, cfg)
    pre = icgn.track_pose(tr, tn, X, p0, cam, dataclasses.replace(cfg, gather_prefetch=True))
    torch.testing.assert_close(pre, ref, rtol=0, atol=0)
    exact = icgn.track_pose(tr, tn, X, p0, cam, dataclasses.replace(cfg, window_cache=False))
    assert bool(torch.isfinite(exact).all())
    split = icgn.track_pose(tr, tn, X, p0, cam, dataclasses.replace(cfg, gather_split=True))
    torch.testing.assert_close(split, ref, rtol=0, atol=0)


def test_bf16_storage_and_verbose_iterations(scene, capsys):
    """bf16_gather stores the per-iteration planes in bfloat16 (the
    Hessian stays float32): the pose moves by far less than the
    tracker's accuracy.  verbosity 2 prints one line per iteration run."""
    sc = scene["sc"]
    cam = convert.camera_from_numpy(JCam.create(sc.fc, sc.cc, sc.wh, 2, 8), "cpu")
    tr = build_pyramid(t32(scene["img_ref"]), 2, 8)
    tn = build_pyramid(t32(scene["img_new"]), 2, 8)
    cfg = ICGNParams(lv_f=1, lv_l=0, maxiter=10)
    ref, aux = icgn.track_pose(tr, tn, t32(scene["X"]), torch.zeros(6), cam, cfg,
                               return_aux=True)
    low = icgn.track_pose(tr, tn, t32(scene["X"]), torch.zeros(6), cam,
                          dataclasses.replace(cfg, bf16_gather=True, verbosity=2))
    assert float((low - ref).abs().max()) < 1e-3
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Sc")]
    assert len(lines) >= int(aux.iters.sum()) - 2


def test_track_pose_float32_sensitivity_on_a_plane():
    """Not a fault of the port, logged in ROADMAP Queue 3: with ``donorm``
    the tracker solves in normalised coordinates, and on a plane of points
    at one depth (the engine's 320x240 scene, the keyframe of frame 1
    tracked into frame 2, 200 points) its float32 result sits 9.3e-5 from
    its float64 result in JAX and 1.2e-4 in the port on the CPU, on the
    other side: the two float32 runs part by 2.1e-4 (the card's run of the
    port sits within 4e-7 of JAX f32).  Without ``donorm`` they agree to
    1.0e-6.  Held: the port within 2 x JAX f32's own gap of the float64
    result."""
    rng = np.random.default_rng(0)
    from invcompcamtrack_torch.core.camera import CameraPyramid
    from invcompcamtrack_torch.vo import synthetic as tsyn

    sc = tsyn.make_scene(rng, wh=(320, 240), fc=(300.0, 302.0), freq_range=(0.8, 8.0))
    poses = [np.zeros(6)]
    for _ in range(1, 3):
        poses.append(poses[-1] + np.r_[0.015, 0.006, -0.02, rng.normal(size=3) * 0.001])
    imgs = [tsyn.render(sc, lie.se3_exp(torch.tensor(p, dtype=torch.float64)).numpy())
            .astype(np.float32) for p in poses]
    X = tsyn.sample_plane_points(sc, rng, 200, margin=24).astype(np.float32)
    p1 = np.asarray(poses[1], np.float32)
    out = {}
    for donorm in (True, False):
        kw = dict(lv_f=3, lv_l=0, psz=8, maxiter=8, donorm=donorm)
        cam = CameraPyramid.create(sc.fc, sc.cc, sc.wh, 4, 8, device="cpu")
        got = icgn.track_pose(build_pyramid(t32(imgs[1]), 4, 8), build_pyramid(t32(imgs[2]), 4, 8),
                              t32(X), t32(p1), cam, ICGNParams(**kw)).numpy()
        jres = {}
        for dt in (jnp.float32, jnp.float64) if donorm else (jnp.float32,):
            jcam = JCam.create(sc.fc, sc.cc, sc.wh, 4, 8)
            jcam = JCam(*[jnp.asarray(f, dt) for f in jcam[:6]], jcam.padding)
            jres[dt] = np.asarray(jicgn.track_pose(
                jbuild(jnp.asarray(imgs[1], dt), 4, 8), jbuild(jnp.asarray(imgs[2], dt), 4, 8),
                jnp.asarray(X, dt), jnp.asarray(p1, dt), jcam, ICGNParams(**kw)), np.float64)
        out[donorm] = {k: np.abs(a - b).max() for k, (a, b) in (
            ("port_jax32", (got, jres[jnp.float32])),
            *((("port_jax64", (got, jres[jnp.float64])),
               ("jax32_jax64", (jres[jnp.float32], jres[jnp.float64]))) if donorm else ()))}
    assert out[True]["port_jax64"] <= 2 * out[True]["jax32_jax64"], out
    assert out[False]["port_jax32"] <= POSE_ATOL, out
