"""The RANSAC pose path (``sfm/pnp.py``, ``sfm/ransac.py``, the helpers
of ``core/`` they import, and RANSAC -> ``track_nposes`` ->
``select_best``) against the JAX package on the CPU.

Inputs are seeded numpy arrays handed to both packages as explicit
float32.  Each tolerance comes from the JAX package's own float32-vs-
float64 gap of the same call, measured in the test: two float32 runs each
sit within that gap of the float64 answer, so the port is held to twice
it: elementwise helpers against the JAX float64 answer, the solvers and
the fit (whose hypotheses and decisions the JAX float32 run makes)
against the JAX float32 run; plus a floor of a few float32 ulps where
the gap is 0.

The JAX ``fit_camera_ransac`` draws its samples with ``jax.random``
inside; the tests rebuild those indices with its three lines and hand
them to the port, which takes its samples from the caller.
"""

import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.config import ICGNParams as JParams
from invcompcamtrack_tpu.core import camera as jcamera
from invcompcamtrack_tpu.core import lie as jlie
from invcompcamtrack_tpu.core import pose as jpose
from invcompcamtrack_tpu.core.camera import CameraPyramid as JCam
from invcompcamtrack_tpu.image.pyramid import build_pyramid as jbuild
from invcompcamtrack_tpu.sfm import pnp as jpnp
from invcompcamtrack_tpu.sfm import ransac as jransac
from invcompcamtrack_tpu.solver import chain as jchain
from invcompcamtrack_tpu.vo import synthetic
from invcompcamtrack_torch import ICGNParams
from invcompcamtrack_torch.core import camera, lie, pose
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.sfm import pnp, ransac
from invcompcamtrack_torch.solver import chain
from tests.oracles import geometry_np as geo
from tests.torch_helpers import t32

REPO = Path(__file__).resolve().parents[1]
# the chain's pose tolerance of tests/test_torch_chain.py
POSE_ATOL = 2e-5
# the JAX references run jitted: one compilation per program and dtype
# where their eager ops would compile one by one
_jfit = jax.jit(jransac.fit_camera_ransac,
                static_argnames=("n_samples", "sample_size", "inl_thresh", "min_inliers"))
_jpnp = {name: jax.jit(getattr(jpnp, name)) for name in
         ("pnp_dlt", "pnp_planar", "pnp_auto", "planarity")}


def assert_as_close_as_jax(got, want32, want64, floor=1e-6, what=""):
    """The port's float32 result within twice the JAX package's own
    float32-vs-float64 gap (plus ``floor``) of the JAX float64 answer."""
    got, want32, want64 = (np.asarray(a, np.float64) for a in (got, want32, want64))
    gap = float(np.abs(want32 - want64).max())
    err = float(np.abs(got - want64).max())
    assert err <= 2 * gap + floor, f"{what}: port {err} from float64, JAX float32 {gap}"


KC = {0: [], 1: [-0.2], 2: [-0.2, 0.05], 4: [-0.2, 0.05, 1e-3, -2e-3],
      5: [-0.2, 0.05, 1e-3, -2e-3, 0.01]}


@pytest.mark.parametrize("nk", sorted(KC))
def test_distortion_matches_jax(nk):
    rng = np.random.default_rng(nk)
    pn = (rng.normal(size=(50, 2)) * 0.4).astype(np.float32)
    kc = np.asarray(KC[nk], np.float32)
    for name in ("distort", "undistort"):
        jf = getattr(jcamera, name)
        got = getattr(camera, name)(torch.from_numpy(pn), torch.from_numpy(kc)).numpy()
        assert_as_close_as_jax(got, jf(jnp.asarray(pn), jnp.asarray(kc)),
                               jf(jnp.asarray(pn, jnp.float64), jnp.asarray(kc, jnp.float64)),
                               what=name)


def test_so3_and_reproject_match_jax():
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(20, 3)) * 0.5).astype(np.float32)
    w[0] = 0.0
    w[1] = [1e-6, -2e-6, 0.0]
    R = lie.so3_exp(torch.from_numpy(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(jlie.so3_exp(jnp.asarray(w))), atol=1e-6)
    np.testing.assert_allclose(lie.so3_log(R).numpy(),
                               np.asarray(jlie.so3_log(jnp.asarray(R.numpy()))), atol=1e-5)
    G = lie.se3_exp(t32(rng.normal(size=(4, 6)) * 0.3))
    np.testing.assert_array_equal(lie.se3_matrix(G).numpy(),
                                  np.asarray(jlie.se3_matrix(jnp.asarray(G.numpy()))))
    X = (rng.normal(size=(30, 3)) * 2 + [0, 0, 8]).astype(np.float32)
    t = np.float32([0.1, -0.2, 0.3])
    fc, cc = np.float32([500.0, 510.0]), np.float32([320.0, 240.0])
    Rn = R[2].numpy()
    for kc in (None, np.asarray(KC[5], np.float32)):
        for camcenter in (False, True):
            def jf(dt):
                return jpose.reproject(jnp.asarray(X, dt), jnp.asarray(Rn, dt), jnp.asarray(t, dt),
                                       jnp.asarray(fc, dt), jnp.asarray(cc, dt),
                                       None if kc is None else jnp.asarray(kc, dt), camcenter)
            got = pose.reproject(torch.from_numpy(X), torch.from_numpy(Rn), torch.from_numpy(t),
                                 fc, cc, None if kc is None else torch.from_numpy(kc),
                                 camcenter).numpy()
            assert_as_close_as_jax(got, jf(jnp.float32), jf(jnp.float64), floor=1e-4,
                                   what=f"reproject kc={kc is not None} camcenter={camcenter}")


def _pnp_problems(planar: bool, n_prob=16, n=12, seed=0):
    rng = np.random.default_rng(seed)
    Xs, xns = [], []
    for _ in range(n_prob):
        G = geo.se3_exp(np.r_[rng.normal(size=3) * 0.3, rng.normal(size=3) * 0.2])
        if planar:
            nrm = rng.normal(size=3)
            nrm /= np.linalg.norm(nrm)
            e1 = np.cross(nrm, [1.0, 0, 0])
            e1 /= np.linalg.norm(e1)
            e2 = np.cross(nrm, e1)
            q = rng.normal(size=(n, 2)) * 2
            X = np.array([0, 0, 8.0]) + q[:, 0:1] * e1 + q[:, 1:2] * e2
        else:
            X = rng.normal(size=(n, 3)) * 2 + [0, 0, 8]
        Xc = X @ G[:, :3].T + G[:, 3]
        Xs.append(X)
        xns.append(Xc[:, :2] / Xc[:, 2:3] + rng.normal(size=(n, 2)) * 1e-3)
    w = (rng.uniform(size=(n_prob, n)) < 0.8).astype(np.float64)
    w[:, :8] = 1.0
    return np.stack(Xs), np.stack(xns), w


@pytest.mark.parametrize("planar", [False, True], ids=["general", "planar"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_pnp_solvers_match_jax(planar, weighted):
    """The solver that pnp_auto selects (pnp_dlt on general samples,
    pnp_planar on planar ones), planarity and pnp_auto, 16 problems of 12
    points; the dropped solver's output is not held (on planar samples
    pnp_dlt's null space is degenerate)."""
    X, xn, w = _pnp_problems(planar)
    X32, xn32, w32 = (a.astype(np.float32) for a in (X, xn, w))
    kw32 = dict(weights=jnp.asarray(w32)) if weighted else {}
    kw64 = dict(weights=jnp.asarray(w)) if weighted else {}
    kwt = dict(weights=torch.from_numpy(w32)) if weighted else {}
    args32, args64 = (jnp.asarray(X32), jnp.asarray(xn32)), (jnp.asarray(X), jnp.asarray(xn))
    Xt, xnt = torch.from_numpy(X32), torch.from_numpy(xn32)

    # planarity: the route
    pj = np.asarray(_jpnp["planarity"](args32[0], **kw32))
    pt = pnp.planarity(Xt, **kwt).numpy()
    assert np.all((pj < 1e-3) == planar) and np.all((pt < 1e-3) == planar)
    tol = 2 * float(np.abs(pj - np.asarray(_jpnp["planarity"](args64[0], **kw64))).max()) + 1e-7
    np.testing.assert_allclose(pt, pj, atol=tol, rtol=0)

    solver = "pnp_planar" if planar else "pnp_dlt"
    for name in (solver, "pnp_auto"):
        jf = _jpnp[name]
        Gj, bad_j = jf(*args32, **kw32)
        Gj64, _ = jf(*args64, **kw64)
        gap = float(np.abs(np.asarray(Gj) - np.asarray(Gj64)).max())
        Gt, bad_t = getattr(pnp, name)(Xt, xnt, **kwt)
        assert not bad_t.any() and not np.asarray(bad_j).any()
        assert torch.isfinite(Gt).all()
        np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), atol=2 * gap + 1e-6, rtol=0,
                                   err_msg=f"{name} (JAX's own f32-vs-f64 gap {gap})")


def test_collinearity_degenerate_matches_jax():
    """The JAX test's two cases, and a random batch of 6-point samples in
    which some triples are collinear on purpose (repeated points, points
    on a line), elementwise against the JAX loop over the triples."""
    X = np.array([[0, 0, 1.0], [0, 0, 2.0], [0, 0, 3.0], [1, 2, 3.0],
                  [4, 5, 6.0], [7, 1, 2.0]], np.float32)
    x = np.random.default_rng(0).normal(size=(6, 2)).astype(np.float32)
    X_ok = np.random.default_rng(1).normal(size=(6, 3)).astype(np.float32)
    for X3, want in ((X, True), (X_ok, False)):
        assert bool(pnp.collinearity_degenerate(torch.from_numpy(x), torch.from_numpy(X3))) == want
    rng = np.random.default_rng(2)
    p2 = rng.integers(-3, 4, size=(64, 6, 2)).astype(np.float32)
    p3 = rng.normal(size=(64, 6, 3)).astype(np.float32)
    p3[::4, 1] = p3[::4, 0] * 2.0            # collinear with the origin in 3-D
    p2[1::5, 2] = p2[1::5, 0]                # a repeated 2-D point
    p2[2::7, 3] = 2 * p2[2::7, 1] - p2[2::7, 0]   # three 2-D points on a line
    got = pnp.collinearity_degenerate(torch.from_numpy(p2), torch.from_numpy(p3)).numpy()
    want = np.asarray(jpnp.collinearity_degenerate(jnp.asarray(p2), jnp.asarray(p3)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    assert len(list(itertools.combinations(range(6), 3))) == pnp._triples(6, "cpu").shape[0]


@pytest.mark.parametrize("with_kc", [False, True], ids=["pinhole", "distorted"])
def test_reprojection_errors_match_jax(with_kc):
    rng = np.random.default_rng(3)
    G = lie.se3_exp(t32(rng.normal(size=(8, 6)) * 0.2)).numpy()
    X = (rng.normal(size=(40, 3)) * 2 + [0, 0, 8]).astype(np.float32)
    uv = (rng.uniform(0, 640, size=(40, 2))).astype(np.float32)
    fc, cc = np.float32([500.0, 510.0]), np.float32([320.0, 240.0])
    kc = np.asarray(KC[5], np.float32) if with_kc else None

    def jf(dt):
        return jransac.reprojection_errors(
            jnp.asarray(G, dt), jnp.asarray(X, dt), jnp.asarray(uv, dt), jnp.asarray(fc, dt),
            jnp.asarray(cc, dt), None if kc is None else jnp.asarray(kc, dt))

    got = ransac.reprojection_errors(torch.from_numpy(G), torch.from_numpy(X),
                                     torch.from_numpy(uv), fc, cc,
                                     None if kc is None else torch.from_numpy(kc)).numpy()
    assert_as_close_as_jax(got, jf(jnp.float32), jf(jnp.float64), floor=1e-4,
                           what="reprojection_errors")


def _jax_indices(key, n, n_samples, sample_size=6):
    """The samples that the JAX fit_camera_ransac draws (its three lines)."""
    keys = jax.random.split(key, n_samples)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(sample_size,), replace=False))(keys))


def _ransac_scene(planar, N=120, n_out=24, seed=0):
    """The tests/test_ransac.py scenes (general: 3-D points about z 10;
    planar: the z = 8 plane) with 20 % outliers."""
    rng = np.random.default_rng(seed)
    if planar:
        fc, cc = np.float32([300.0, 305.0]), np.float32([160.0, 120.0])
        p_gt = np.r_[rng.normal(size=3) * 0.1, rng.normal(size=3) * 0.05]
        q = rng.normal(size=(N, 2)) * 2
        X = np.array([0, 0, 8.0]) + np.c_[q, np.zeros(N)]
        noise = 0.2
    else:
        fc, cc = np.float32([500.0, 510.0]), np.float32([320.0, 240.0])
        p_gt = np.r_[rng.normal(size=3) * 0.3, rng.normal(size=3) * 0.15]
        X = rng.normal(size=(N, 3)) * 2 + [0, 0, 10]
        noise = 0.3
    uv, _ = geo.project(geo.se3_exp(p_gt), X, fc[0], fc[1], cc[0], cc[1])
    uv += rng.normal(size=uv.shape) * noise
    uv[:n_out] += rng.uniform(30, 120, size=(n_out, 2))
    return uv.astype(np.float32), X.astype(np.float32), fc, cc, p_gt


@pytest.mark.parametrize("planar", [False, True], ids=["general", "planar"])
def test_fit_camera_ransac_given_jax_samples(planar):
    """N = 120, S = 64, the JAX indices: the same valid hypotheses and
    inlier counts (up to points within the tolerance of the threshold),
    each valid hypothesis' G within twice the JAX call's own worst
    float32-vs-float64 gap; the planar scene routes to pnp_planar in
    both."""
    uv, X, fc, cc, _ = _ransac_scene(planar)
    thresh, S = 3.0, 64
    key = jax.random.PRNGKey(int(planar))
    idx = _jax_indices(key, len(uv), S)
    rj = _jfit(key, jnp.asarray(uv), jnp.asarray(X), jnp.asarray(fc), jnp.asarray(cc),
               n_samples=S, inl_thresh=thresh)
    rj64 = _jfit(key, jnp.asarray(uv, jnp.float64), jnp.asarray(X, jnp.float64),
                 jnp.asarray(fc, jnp.float64), jnp.asarray(cc, jnp.float64), n_samples=S,
                 inl_thresh=thresh)
    rt = ransac.fit_camera_ransac(torch.from_numpy(idx), torch.from_numpy(uv),
                                  torch.from_numpy(X), fc, cc, inl_thresh=thresh)
    assert np.asarray(rj.G).dtype == np.float32
    route_j = np.asarray(jpnp.planarity(jnp.asarray(X)[idx])) < 1e-3
    route_t = (pnp.planarity(torch.from_numpy(X)[torch.from_numpy(idx)]) < 1e-3).numpy()
    np.testing.assert_array_equal(route_j, route_t)
    assert route_t.all() == planar and route_t.any() == planar

    vj, vt = np.asarray(rj.valid), rt.valid.numpy()
    assert vj.sum() >= 2
    np.testing.assert_array_equal(vt, vj)
    # the JAX solver's own float32 noise on this call's inputs: its
    # f32-vs-f64 gap over the minimal-sample solves of every sample and
    # over the final hypotheses (the valid ones share a few refits, too
    # few to set a tolerance alone)
    pn = (uv - cc) / fc
    stage1 = [np.asarray(_jpnp["pnp_auto"](jnp.asarray(X, dt)[idx], jnp.asarray(pn, dt)[idx])[0],
                         np.float64) for dt in (jnp.float32, jnp.float64)]
    gap = np.r_[np.abs(stage1[0] - stage1[1]).reshape(S, -1).max(1),
                np.abs(np.asarray(rj.G) - np.asarray(rj64.G)).reshape(S, -1).max(1)[vj]]
    got = np.abs(rt.G.numpy() - np.asarray(rj.G)).reshape(S, -1).max(1)[vj]
    assert got.max() <= 2 * gap.max() + 1e-6, (got.max(), gap.max())
    # inlier flags: the same, except at points whose errors lie within the
    # hypotheses' reprojection tolerance of the threshold
    err_j = np.asarray(jransac.reprojection_errors(rj.G, jnp.asarray(X), jnp.asarray(uv),
                                                   fc, cc))
    err_t = ransac.reprojection_errors(rt.G, torch.from_numpy(X), torch.from_numpy(uv),
                                       fc, cc).numpy()
    near = np.abs(err_j - thresh) <= np.abs(err_j - err_t) + 1e-4
    ij, it = np.asarray(rj.inliers)[vj], rt.inliers.numpy()[vj]
    assert np.all((ij == it) | near[vj])
    cnt_ok = np.asarray(rj.num_inliers)[vj] - rt.num_inliers.numpy()[vj]
    assert np.all(np.abs(cnt_ok) <= near[vj].sum(1))
    assert np.isfinite(rt.G.numpy()[vt]).all() and np.isfinite(rt.poses.numpy()[vt]).all()


def test_ransac_chain_selects_the_jax_winner():
    """RANSAC -> track_nposes -> select_best at 256x192, S = 16, N = 60
    (20 % outliers), the JAX indices: the same winner as the JAX chain;
    its verified poses within the chain's tolerance, its fitted pose
    within twice the JAX fit's float32-vs-float64 gap."""
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, wh=(256, 192), fc=(240.0, 245.0))
    poses = [np.zeros(6)]
    for _ in range(2):
        poses.append(poses[-1] + np.r_[rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.005])
    imgs = [synthetic.render(scene, geo.se3_exp(p)).astype(np.float32) for p in poses]
    N, S, n_out = 60, 16, 12
    X = synthetic.sample_plane_points(scene, rng, N, margin=30)
    uv, _ = geo.project(geo.se3_exp(poses[1]), X, *scene.fc, *scene.cc)
    uv += rng.normal(size=uv.shape) * 0.3
    uv[:n_out] += rng.uniform(30, 120, size=(n_out, 2)) * rng.choice([-1, 1], size=(n_out, 2))
    uv, X = uv.astype(np.float32), X.astype(np.float32)
    fc, cc = np.float32(scene.fc), np.float32(scene.cc)
    thresh = float(np.hypot(*scene.wh)) / 100.0
    key = jax.random.PRNGKey(3)
    idx = _jax_indices(key, N, S)

    cfg_j = JParams(lv_f=2, lv_l=0, psz=8, maxiter=6, normdp_ratio=0.01)
    levels = cfg_j.num_levels
    rj = _jfit(key, jnp.asarray(uv), jnp.asarray(X), jnp.asarray(fc), jnp.asarray(cc),
               n_samples=S, inl_thresh=thresh)
    rj64 = _jfit(key, jnp.asarray(uv, jnp.float64), jnp.asarray(X, jnp.float64),
                 jnp.asarray(fc, jnp.float64), jnp.asarray(cc, jnp.float64), n_samples=S,
                 inl_thresh=thresh)
    jcam = JCam.create(scene.fc, scene.cc, scene.wh, levels, cfg_j.psz)
    jpyrs = [jbuild(jnp.asarray(im), levels, cfg_j.psz) for im in imgs]
    res_j = jax.jit(lambda *a: jchain.track_nposes(*a, jcam, cfg_j, fb_frames=(1, 1)))(
        jpyrs, rj.poses, jnp.asarray(X), rj.inliers)
    best_j, _ = jchain.select_best(res_j, rj.valid)

    cfg = ICGNParams(lv_f=2, lv_l=0, psz=8, maxiter=6, normdp_ratio=0.01)
    rt = ransac.fit_camera_ransac(torch.from_numpy(idx), torch.from_numpy(uv),
                                  torch.from_numpy(X), fc, cc, inl_thresh=thresh)
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, levels, cfg.psz, device="cpu")
    pyrs = [build_pyramid(torch.from_numpy(im), levels, cfg.psz) for im in imgs]
    res_t = chain.track_nposes(pyrs, rt.poses, torch.from_numpy(X), rt.inliers, cam, cfg,
                               fb_frames=(1, 1))
    best_t, _ = chain.select_best(res_t, rt.valid)

    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    assert int(np.asarray(rj.valid).sum()) >= 2
    b = int(best_j)
    assert int(best_t) == b
    fit_gap = float(np.abs(np.asarray(rj.G[b]) - np.asarray(rj64.G[b])).max())
    np.testing.assert_allclose(rt.G[b].numpy(), np.asarray(rj.G[b]), atol=2 * fit_gap + 1e-6)
    for frame in (0, 2):
        np.testing.assert_allclose(res_t.pose_tracks[b, frame].numpy(),
                                   np.asarray(res_j.pose_tracks[b, frame]), atol=POSE_ATOL)


def _phase8_inputs():
    """chip_smoke.py path 8's correspondences and the port's indices."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from invcompcamtrack_torch.sfm.epipolar import sample_indices

    scene, p_gt, X = cs.problem_geometry()[:3]
    pt2d, pt3d, thresh = cs.ransac_problem(scene, p_gt, X)
    idx = sample_indices(cs.N, cs.B, k=cs.RANSAC_SAMPLE,
                         generator=torch.Generator().manual_seed(cs.SEED)).numpy()
    return cs, scene, p_gt, pt2d, pt3d, thresh, idx


def _jax_fit_given(idx, scene, pt2d, pt3d, thresh, min_inliers, dt):
    """The JAX fit_camera_ransac's body (jitted) on the given indices, in
    dtype dt -> numpy (G, inliers, valid, refit decisions)."""
    @jax.jit
    def body(fc, cc, p2, p3):
        pn = (p2 - cc) / fc
        degen = jpnp.collinearity_degenerate(p2[idx], p3[idx])
        G, bad = jpnp.pnp_auto(p3[idx], pn[idx])
        inl = jransac.reprojection_errors(G, p3, p2, fc, cc) <= thresh
        S = idx.shape[0]
        G2, bad2 = jpnp.pnp_auto(jnp.broadcast_to(p3, (S,) + p3.shape),
                                 jnp.broadcast_to(pn, (S,) + pn.shape),
                                 weights=inl.astype(p2.dtype))
        err2 = jransac.reprojection_errors(G2, p3, p2, fc, cc)
        better = (jnp.sum(err2 <= thresh, -1) >= jnp.sum(inl, -1)) & ~bad2
        G = jnp.where(better[:, None, None], G2, G)
        inl = jnp.where(better[:, None], err2 <= thresh, inl)
        valid = ~degen & ~bad & (jnp.sum(inl, -1) >= min_inliers)
        return G, inl, valid, better

    out = body(*(jnp.asarray(a, dt) for a in (scene.fc, scene.cc, pt2d, pt3d)))
    return tuple(np.asarray(a) for a in out)


def test_phase8_limits_cover_the_jax_gap():
    """chip_smoke.py's limits for path 8's card-vs-CPU fit are twice the
    JAX package's own float32-vs-float64 gap of the same call (phase 8's
    inputs and the port's indices), measured here: the recorded gaps
    (JAX_F32_G_GAP, to the digits kept) and refit flips
    (JAX_F32_REFIT_FLIPS) must match this measurement."""
    cs, scene, _, pt2d, pt3d, thresh, idx = _phase8_inputs()
    G32, _, v32, b32 = _jax_fit_given(idx, scene, pt2d, pt3d, thresh,
                                      cs.RANSAC_MIN_INLIERS, jnp.float32)
    G64, _, v64, b64 = _jax_fit_given(idx, scene, pt2d, pt3d, thresh,
                                      cs.RANSAC_MIN_INLIERS, jnp.float64)
    np.testing.assert_array_equal(v32, v64)
    assert int((b32 != b64).sum()) == cs.JAX_F32_REFIT_FLIPS
    assert cs.RANSAC_VALID_FLIPS == 2 * cs.JAX_F32_REFIT_FLIPS
    gap = np.abs(G32.astype(np.float64) - G64).reshape(len(G32), -1).max(1)[v64]
    got = {"median": np.median(gap), "p90": np.quantile(gap, 0.9), "max": gap.max()}
    for q, v in got.items():
        assert cs.JAX_F32_G_GAP[q] == float(f"{v:.3g}"), (q, v, cs.JAX_F32_G_GAP[q])
        assert cs.RANSAC_G_LIMITS[q] == 2.0 * cs.JAX_F32_G_GAP[q]
    # the port's own CPU run sits within those limits of the JAX f32 run
    rt = ransac.fit_camera_ransac(torch.from_numpy(idx), torch.from_numpy(pt2d),
                                  torch.from_numpy(pt3d), scene.fc, scene.cc,
                                  inl_thresh=thresh, min_inliers=cs.RANSAC_MIN_INLIERS)
    np.testing.assert_array_equal(rt.valid.numpy(), v32)
    port = np.abs(rt.G.numpy() - G32).reshape(len(G32), -1).max(1)[v64]
    assert np.median(port) <= cs.RANSAC_G_LIMITS["median"]
    assert port.max() <= cs.RANSAC_G_LIMITS["max"]


@pytest.mark.slow  # the JAX verification of 256 hypotheses at 1280x720: ~60 s on the CPU
def test_phase8_verification_picks_what_the_jax_package_picks():
    """Path 8's whole workload on the CPU, the port beside the JAX package
    (float32, the port's indices): the same valid hypotheses and the same
    select_best winner.  On this plane every chain that converges scores
    a mean correlation above 0.9999, and the winner is a hypothesis with
    few inliers far from the true pose in both packages (ROADMAP Queue 3);
    the valid hypotheses' median centre error stays under bench.py's 0.05."""
    cs, scene, p_gt, pt2d, pt3d, thresh, idx = _phase8_inputs()
    img_ref, img_new, img_2 = cs.make_problem()[3:6]
    idx = torch.from_numpy(idx)
    rt = ransac.fit_camera_ransac(idx, torch.from_numpy(pt2d), torch.from_numpy(pt3d),
                                  scene.fc, scene.cc, inl_thresh=thresh,
                                  min_inliers=cs.RANSAC_MIN_INLIERS)
    cfg = ICGNParams(lv_f=4, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01, donorm=True)
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, cfg.num_levels, cfg.psz,
                               device="cpu")
    imgs = (img_ref, img_new, img_2)
    pyrs = [build_pyramid(torch.from_numpy(im), cfg.num_levels, cfg.psz) for im in imgs]
    res_t = chain.track_nposes(pyrs, rt.poses, torch.from_numpy(pt3d), rt.inliers, cam, cfg)
    best_t, _ = chain.select_best(res_t, rt.valid)

    # the JAX package on the port's samples
    G, inl, valid, _ = _jax_fit_given(idx.numpy(), scene, pt2d, pt3d, thresh,
                                      cs.RANSAC_MIN_INLIERS, jnp.float32)
    jcfg = JParams(lv_f=4, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01, donorm=True)
    jcam = JCam.create(scene.fc, scene.cc, scene.wh, jcfg.num_levels, jcfg.psz)
    jpyrs = [jbuild(jnp.asarray(im), jcfg.num_levels, jcfg.psz) for im in imgs]
    res_j = jchain.track_nposes(jpyrs, jlie.se3_log(G), jnp.asarray(pt3d), inl, jcam, jcfg)
    best_j, _ = jchain.select_best(res_j, valid)

    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(valid))
    assert int(best_t) == int(best_j)
    c_gt = geo.se3_exp(p_gt)
    c_gt = -c_gt[:, :3].T @ c_gt[:, 3]

    def centre_err(p):
        Gp = geo.se3_exp(np.asarray(p, np.float64))
        return np.linalg.norm(-Gp[:, :3].T @ Gp[:, 3] - c_gt)

    errs = np.array([centre_err(p) for p in rt.poses.numpy()])
    b = int(best_t)
    print(f"winner {b}: {int(rt.num_inliers[b])} inliers, port centre error {errs[b]:.4f}, "
          f"JAX {centre_err(np.asarray(jlie.se3_log(G))[b]):.4f}; median over the "
          f"{int(rt.valid.sum())} valid hypotheses {np.median(errs[rt.valid.numpy()]):.4f}")
    assert np.median(errs[rt.valid.numpy()]) < 0.05
