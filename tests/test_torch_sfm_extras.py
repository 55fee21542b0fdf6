"""The rest of ``sfm/`` and ``ba/pose_graph.py`` and ``vo/rig.py``
(stereo, covariance, trajectory refinement, pose graph, rig) against the
JAX package on the CPU.

Seeded numpy inputs go to both packages as explicit float32.  Each
tolerance comes from the JAX package's own float32-vs-float64 gap of the
same call, measured in the test: the port's float32 result must sit
within twice that gap (plus a floor of a few float32 ulps) of the JAX
float64 answer, as close as the JAX package's own float32 result sits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.ba import pose_graph as jpg
from invcompcamtrack_tpu.sfm import covariance as jcov
from invcompcamtrack_tpu.sfm import stereo as jstereo
from invcompcamtrack_tpu.sfm import trajectory as jtraj
from invcompcamtrack_tpu.vo import rig as jrig
from invcompcamtrack_torch import convert
from invcompcamtrack_torch.ba import pose_graph
from invcompcamtrack_torch.core import pose as pose_ops
from invcompcamtrack_torch.sfm import covariance, stereo, trajectory
from invcompcamtrack_torch.vo import rig
from tests.oracles import geometry_np as geo
from tests.torch_helpers import t32


def assert_as_close_as_jax(got, want32, want64, floor=1e-6, what=""):
    """The port's float32 result within twice the JAX package's own
    float32-vs-float64 gap (plus ``floor``) of the JAX float64 answer."""
    got, want32, want64 = (np.asarray(a, np.float64) for a in (got, want32, want64))
    gap = float(np.abs(want32 - want64).max())
    err = float(np.abs(got - want64).max())
    assert err <= 2 * gap + floor, f"{what}: port {err} from float64, JAX float32 {gap}"


def test_stereo_matches_jax():
    rng = np.random.default_rng(0)
    uv = rng.uniform(0, 320, size=(40, 2)).astype(np.float32)
    disp = rng.uniform(-2.0, 30.0, size=40).astype(np.float32)
    disp[:3] = [0.0, -1.0, 1e-3]
    args = (400.0, 410.0, 320.0, 240.0, 0.5)
    got = stereo.disparity_to_points(torch.from_numpy(uv), torch.from_numpy(disp), *args).numpy()
    want = np.asarray(jstereo.disparity_to_points(jnp.asarray(uv), jnp.asarray(disp), *args))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-7)

    l0 = rng.uniform(50, 200, (30, 2)).astype(np.float32)
    r0 = l0 - np.float32([20, 0]) + rng.normal(size=(30, 2)).astype(np.float32)
    l1 = l0 + np.float32([3, 1]) + rng.normal(size=(30, 2)).astype(np.float32)
    r1 = r0 + np.float32([3, 1]) + rng.normal(size=(30, 2)).astype(np.float32)
    r1[0, 0] = np.nan
    ts = [torch.from_numpy(a) for a in (l0, r0, l1, r1)]
    got = stereo.stereo_flow_consistency(*ts).numpy()
    want = np.asarray(jstereo.stereo_flow_consistency(*(jnp.asarray(a) for a in (l0, r0, l1, r1))))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_covariance_matches_jax():
    rng = np.random.default_rng(1)
    n = 12
    R = np.stack([geo.se3_exp(np.r_[np.zeros(3), rng.normal(size=3) * 0.1])[:, :3]
                  for _ in range(n)])
    tw = rng.normal(size=(n, 3)) * 0.3 + [0, 0, -5.0]
    P = pose_ops.projection_matrix((400.0, 410.0), (320.0, 240.0), torch.from_numpy(R),
                                   torch.from_numpy(tw)).numpy()
    X = rng.normal(size=(n, 3)) * 0.5 + [0, 0, 3.0]
    A = rng.normal(size=(n, 3, 3)) * 0.01
    cov3 = A @ np.swapaxes(A, -1, -2) + np.eye(3) * 1e-4

    def jax_cov2(dt):
        return jcov.project_cov_3d_to_2d(jnp.asarray(cov3, dt), jnp.asarray(X, dt),
                                         jnp.asarray(P, dt))

    cov2 = covariance.project_cov_3d_to_2d(t32(cov3), t32(X), t32(P))
    assert_as_close_as_jax(cov2.numpy(), jax_cov2(jnp.float32), jax_cov2(jnp.float64),
                           floor=1e-9, what="project_cov_3d_to_2d")

    c2 = cov2.numpy()
    w, h, ang = (a.numpy() for a in covariance.cov_ellipse(cov2, n_std=2.0))
    for k, (a, b) in enumerate(zip((w, h), jcov.cov_ellipse(jnp.asarray(c2), n_std=2.0))):
        b64 = jcov.cov_ellipse(jnp.asarray(c2, jnp.float64), n_std=2.0)[k]
        assert_as_close_as_jax(a, b, b64, floor=1e-5, what="cov_ellipse width/height")
    ang_j = np.asarray(jcov.cov_ellipse(jnp.asarray(c2, jnp.float64), n_std=2.0)[2])
    # the axis direction, not the eigenvector's arbitrary sign: mod 180
    d = np.abs((ang - ang_j + 90.0) % 180.0 - 90.0)
    assert d.max() < 1e-2, d
    assert np.all(w >= h) and np.all(h > 0)

    radii, axes = covariance.cov_ellipsoid_axes(t32(cov3), n_std=3.0)
    r32, a32 = jcov.cov_ellipsoid_axes(jnp.asarray(cov3, jnp.float32), n_std=3.0)
    r64, a64 = jcov.cov_ellipsoid_axes(jnp.asarray(cov3), n_std=3.0)
    assert_as_close_as_jax(radii.numpy(), r32, r64, floor=1e-7, what="ellipsoid radii")
    # columns up to sign
    a64 = np.asarray(a64)
    sgn = np.sign(np.sum(axes.numpy() * a64, axis=-2, keepdims=True))
    a32 = np.asarray(a32) * np.sign(np.sum(np.asarray(a32) * a64, axis=-2, keepdims=True))
    assert_as_close_as_jax(axes.numpy() * sgn, a32, a64, floor=1e-6, what="ellipsoid axes")


def _traj_rig(rng, T=6, C=3, n_pts=3):
    """tests/test_trajectory.py's rig: T steps x C cameras looking at
    moving points near z = 10; n_pts noisy trajectories."""
    fc, cc = np.array([400.0, 410.0]), np.array([320.0, 240.0])
    R = np.zeros((T, C, 3, 3))
    tw = np.zeros((T, C, 3))
    for t in range(T):
        for j in range(C):
            R[t, j] = geo.se3_exp(np.r_[np.zeros(3), rng.normal(size=3) * 0.05])[:, :3]
            tw[t, j] = np.array([2.0 * j - 2.0, 0.1 * t, 0.0]) + rng.normal(size=3) * 0.05
    ts = np.linspace(-1, 1, T)[:, None]
    X_gt = np.stack([np.array([0.5, -0.3, 10.0]) + rng.normal(size=3) * 0.3
                     + ts * np.array([1.0, 0.6, 0.4]) + ts ** 2 * np.array([-0.4, 0.3, 0.2])
                     for _ in range(n_pts)])
    Xc = np.einsum("tcij,ptcj->ptci", R, X_gt[:, :, None, :] - tw[None])
    obs = Xc[..., :2] / Xc[..., 2:3] * fc + cc + rng.normal(size=Xc.shape[:-1] + (2,)) * 0.5
    X0 = X_gt + rng.normal(size=X_gt.shape) * 0.1
    mask = np.ones(obs.shape[:-1], bool)
    mask[0, 1, 2] = False
    return fc, cc, R, tw, obs, X0, mask


def test_bending_stiffness_matches_jax():
    for T in (4, 6):
        np.testing.assert_allclose(trajectory.bending_stiffness(T, device="cpu").numpy(),
                                   np.asarray(jtraj.bending_stiffness(T, jnp.float64)),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sp_weight", [None, 2.0], ids=["decoupled", "smoothed"])
def test_refine_point_trajectory_matches_jax(sp_weight):
    fc, cc, R, tw, obs, X0, mask = _traj_rig(np.random.default_rng(2))

    def jax_run(dt):
        return _jtraj(
            jnp.asarray(R, dt), jnp.asarray(tw, dt), jnp.asarray(obs, dt), jnp.asarray(X0, dt),
            jnp.asarray(fc, dt), jnp.asarray(cc, dt), sp_weight=sp_weight,
            obs_mask=jnp.asarray(mask), num_iters=10)

    got = trajectory.refine_point_trajectory(
        t32(R), t32(tw), t32(obs), t32(X0), t32(fc), t32(cc), sp_weight=sp_weight,
        obs_mask=torch.from_numpy(mask), num_iters=10)
    assert got.shape == X0.shape and got.dtype == torch.float32
    assert_as_close_as_jax(got.numpy(), jax_run(jnp.float32), jax_run(jnp.float64),
                           floor=1e-5, what=f"refine_point_trajectory sp_weight={sp_weight}")
    assert np.abs(got.numpy() - X0).max() > 1e-3   # it moved


_jrel = jax.jit(jpg.relative_pose)
_jres = jax.jit(jpg.graph_residuals)
_jtraj = jax.jit(jtraj.refine_point_trajectory, static_argnames=("sp_weight", "num_iters"))
_jrig = {name: jax.jit(getattr(jrig, name)) for name in (
    "rig_camera_poses", "rig_projection_matrices", "triangulate_rig_tracks", "refine_rig_pose")}


def _loop_graph(rng, K=8):
    """tests/test_pose_graph.py's loop-closure graph: odometry edges with
    drift and one weighted closure to the anchor."""
    gt = np.stack([np.r_[0.3 * k, 0.0, 0.0, 0, 0, 0.02 * k] for k in range(K)])
    init = gt.copy()
    init[1:] += np.cumsum(rng.normal(size=(K, 6)) * 0.02, axis=0)[1:]
    ei = np.r_[np.arange(K - 1), K - 1]
    ej = np.r_[np.arange(1, K), 0]
    meas = np.array(_jrel(jnp.asarray(gt[ei]), jnp.asarray(gt[ej])))
    meas[:-1] += rng.normal(size=(K - 1, 6)) * 1e-3
    w = np.r_[np.ones(K - 1), 10.0]
    return init, ei, ej, meas, w, gt


def test_pose_graph_matches_jax():
    init, ei, ej, meas, w, gt = _loop_graph(np.random.default_rng(3))
    K = len(init)

    def jgraph(dt):
        return jpg.PoseGraph(poses=jnp.asarray(init, dt), edges_i=jnp.asarray(ei, jnp.int32),
                             edges_j=jnp.asarray(ej, jnp.int32),
                             edges_meas=jnp.asarray(meas, dt), edges_weight=jnp.asarray(w, dt),
                             fixed_mask=jnp.asarray(np.arange(K) == 0))

    g = convert.pose_graph_from_numpy(jgraph(jnp.float32), device="cpu")
    assert g.poses.dtype == torch.float32 and g.edges_i.dtype == torch.int64
    rel = pose_graph.relative_pose(g.poses[:-1], g.poses[1:])
    assert_as_close_as_jax(rel.numpy(), _jrel(jnp.asarray(init[:-1], jnp.float32),
                                              jnp.asarray(init[1:], jnp.float32)),
                           _jrel(jnp.asarray(init[:-1]), jnp.asarray(init[1:])),
                           what="relative_pose")
    assert_as_close_as_jax(pose_graph.graph_residuals(g).numpy(), _jres(jgraph(jnp.float32)),
                           _jres(jgraph(jnp.float64)), what="graph_residuals")
    poses, (err, err0) = pose_graph.optimize_pose_graph(g, num_iters=15)
    optimize = jax.jit(jpg.optimize_pose_graph, static_argnames=("num_iters",))
    out32 = optimize(jgraph(jnp.float32), num_iters=15)
    out64 = optimize(jgraph(jnp.float64), num_iters=15)
    assert_as_close_as_jax(poses.numpy(), out32[0], out64[0], floor=1e-5,
                           what="optimize_pose_graph")
    assert_as_close_as_jax(np.r_[float(err), float(err0)], np.r_[out32[1]], np.r_[out64[1]],
                           floor=1e-7, what="optimize_pose_graph errors")
    assert float(err) < 1e-2 * float(err0)
    np.testing.assert_array_equal(poses[0].numpy(), init[0].astype(np.float32))


def test_rig_matches_jax():
    """tests/test_sfm_extras.py's rig: 4 cameras, 3 rig poses, 40 tracks."""
    rng = np.random.default_rng(4)
    fc, cc = (300.0, 305.0), (160.0, 120.0)
    C, T, L = 4, 3, 40
    extr = np.stack([geo.se3_exp(np.r_[rng.normal(size=3) * 0.3, rng.normal(size=3) * 0.1])
                     for _ in range(C)])
    rig_gt = np.stack([np.r_[0.2 * t, 0.01 * t, 0.0, rng.normal(size=3) * 0.01]
                       for t in range(T)])
    X_gt = rng.normal(size=(L, 3)) * 2 + [0, 0, 10]
    obs = np.zeros((L, T, C, 2))
    mask = np.ones((L, T, C), bool)
    for t in range(T):
        G_cams = np.asarray(jrig.rig_camera_poses(jnp.asarray(rig_gt[t]), jnp.asarray(extr)))
        for c in range(C):
            uv, Xc = geo.project(G_cams[c], X_gt, *fc, *cc)
            obs[:, t, c] = uv
            mask[:, t, c] = ((Xc[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < 320)
                             & (uv[:, 1] > 0) & (uv[:, 1] < 240))
    obs = np.where(mask[..., None], obs + rng.normal(size=obs.shape) * 0.1, 0.0)

    def j(a, dt):
        return jnp.asarray(a, dt)

    def jcall(name, dt, *args):
        return _jrig[name](*(j(a, dt) if a.dtype != bool else jnp.asarray(a) for a in args))

    Gc = rig.rig_camera_poses(t32(rig_gt[1]), t32(extr))
    assert_as_close_as_jax(Gc.numpy(), *(jcall("rig_camera_poses", dt, rig_gt[1], extr)
                                         for dt in (jnp.float32, jnp.float64)),
                           what="rig_camera_poses")
    P = rig.rig_projection_matrices(t32(rig_gt[1]), t32(extr), fc, cc)
    assert_as_close_as_jax(P.numpy(), *(jcall("rig_projection_matrices", dt, rig_gt[1], extr,
                                              np.asarray(fc), np.asarray(cc))
                                        for dt in (jnp.float32, jnp.float64)),
                           floor=1e-4, what="rig_projection_matrices")

    def jtri(dt):
        return jcall("triangulate_rig_tracks", dt, rig_gt, extr, obs, mask, np.asarray(fc),
                     np.asarray(cc))

    X, cov = rig.triangulate_rig_tracks(t32(rig_gt), t32(extr), t32(obs),
                                        torch.from_numpy(mask), fc, cc)
    (X32, cov32), (X64, cov64) = jtri(jnp.float32), jtri(jnp.float64)
    assert_as_close_as_jax(X.numpy(), X32, X64, floor=1e-5, what="triangulate_rig_tracks X")
    assert_as_close_as_jax(cov.numpy(), cov32, cov64, floor=1e-7, what="triangulate_rig_tracks cov")

    p0 = rig_gt[1] + np.r_[0.05, -0.04, 0.03, 0.01, -0.01, 0.01]

    def jref(dt):
        return jcall("refine_rig_pose", dt, p0, extr, X_gt, obs[:, 1], mask[:, 1],
                     np.asarray(fc), np.asarray(cc))

    p_ref, msq = rig.refine_rig_pose(t32(p0), t32(extr), t32(X_gt), t32(obs[:, 1]),
                                     torch.from_numpy(mask[:, 1]), fc, cc)
    (p32, m32), (p64, m64) = jref(jnp.float32), jref(jnp.float64)
    assert_as_close_as_jax(p_ref.numpy(), p32, p64, floor=1e-6, what="refine_rig_pose")
    assert_as_close_as_jax(np.r_[float(msq)], np.r_[m32], np.r_[m64], floor=1e-6,
                           what="refine_rig_pose msq")
    assert np.abs(p_ref.numpy() - rig_gt[1]).max() < 5e-3
