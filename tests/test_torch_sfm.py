"""The port's geometry for the VO engine (``ops/linalg.py``'s 3x3
eigensolver, ``sfm/{triangulate,epipolar,twoview}.py``, ``vo/metrics.py``)
against the JAX package, and the eigensolver against the float64 LAPACK
oracle, on the same float32 inputs made with numpy from a seed.

Each tolerance stands beside the gap it was set from: the JAX package's
own float32-vs-float64 gap of the same call on the same inputs (the
port's float32 gap to the JAX float32 result is of that size, since both
round the same expressions in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.ops import linalg as jlinalg
from invcompcamtrack_tpu.sfm import epipolar as jepi
from invcompcamtrack_tpu.sfm import triangulate as jtr
from invcompcamtrack_tpu.sfm import twoview as jtwo
from invcompcamtrack_tpu.vo import metrics as jmet
from invcompcamtrack_torch.ops import linalg
from invcompcamtrack_torch.sfm import epipolar, triangulate as tr, twoview
from invcompcamtrack_torch.vo import metrics
from tests.oracles import geometry_np as geo
from tests.oracles import triang_np as ora
from tests.test_triangulate import _multiview
from tests.torch_helpers import t32


def _np(t):
    return np.asarray(t, np.float64)


def _random_sym(rng, n, cond_exp=0.0):
    """tests/test_linalg.py's random symmetric PSD batch, eigenvalue
    spread 10**-cond_exp."""
    Q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = rng.uniform(0.1, 1.0, size=(n, 3))
    lam[:, 0] *= 10.0 ** (-cond_exp)
    return np.einsum("nij,nj,nkj->nik", Q, lam, Q).astype(np.float32)


# ---------------------------------------------------------------------------
# sym3x3_eigh / sym3x3_trunc_pinv

# Eigenvalues, relative to the largest: the JAX package's f32 result sits
# up to 1.1e-5 from its f64 result (spreads 1e-6 and 1e-7; 2.8e-6 at
# spread 1); the port's sits 2.2e-6 from the JAX f32 result and 1.3e-5
# from the LAPACK oracle.
EIGVAL_TOL = 1e-5
ORACLE_TOL = 3e-5
# Reconstruction V diag(lam) V^T - A, relative to the largest eigenvalue:
# JAX f32 1.1e-5 at spreads 1e-6 and 1e-7 (3.4e-6 at spread 1); the port
# 1.1e-5.
RECON_TOL = 3e-5


@pytest.mark.parametrize("cond_exp", [0.0, 4.0, 6.0, 7.0])
def test_sym3x3_eigh_matches_jax_and_oracle(rng, cond_exp):
    A = _random_sym(rng, 128, cond_exp)
    lam_t, V_t = linalg.sym3x3_eigh(torch.from_numpy(A))
    lam_j, _ = jlinalg.sym3x3_eigh(jnp.asarray(A, jnp.float32))
    lam_ref = np.linalg.eigvalsh(A.astype(np.float64))
    scale = np.abs(lam_ref).max(axis=-1, keepdims=True)
    assert np.abs(_np(lam_t) - _np(lam_j)).max() <= EIGVAL_TOL * scale.max()
    assert (np.abs(_np(lam_t) - lam_ref) <= ORACLE_TOL * scale).all()
    V = _np(V_t)
    np.testing.assert_allclose(np.einsum("nji,njk->nik", V, V),
                               np.broadcast_to(np.eye(3), (len(A), 3, 3)), atol=1e-5)
    R = np.einsum("nij,nj,nkj->nik", V, _np(lam_t), V)
    assert (np.abs(R - A).max(axis=(-2, -1)) <= RECON_TOL * scale[:, 0]).all()


def test_sym3x3_eigh_degenerate_roots(rng):
    # double and triple roots, rank 1, the zero matrix: the identity-basis
    # and cross-product fallbacks.  The eigenvectors of a repeated root are
    # any basis of its space, so what is held is the reconstruction; the
    # eigenvalues of clustered roots cost sqrt(eps) (JAX f32 vs f64: 2.1e-4;
    # the port 1.2e-4 from JAX f32, its reconstruction 2.1e-4)
    Q, _ = np.linalg.qr(rng.normal(size=(8, 3, 3)))
    A = np.concatenate([np.einsum("nij,j,nkj->nik", Q, np.array(lam), Q)
                        for lam in ([1.0, 1.0, 2.0], [2.0, 1.0, 1.0], [1.0, 1.0, 1.0],
                                    [0.0, 0.0, 1.0], [0.0, 1.0, 1.0], [0.0, 0.0, 0.0])]
                       ).astype(np.float32)
    lam_t, V_t = linalg.sym3x3_eigh(torch.from_numpy(A))
    lam_j, _ = jlinalg.sym3x3_eigh(jnp.asarray(A, jnp.float32))
    np.testing.assert_allclose(_np(lam_t), _np(lam_j), atol=1e-3)
    V = _np(V_t)
    R = np.einsum("nij,nj,nkj->nik", V, _np(lam_t), V)
    np.testing.assert_allclose(R, A, atol=1e-3)
    assert np.isfinite(V).all()


def test_sym3x3_trunc_pinv_matches_jax_and_oracle(rng):
    """tests/test_linalg.py's deviation-8 claim, for the port: at a
    spread of 1e-7 below a floor of 1e-5 the float32 truncated
    pseudo-inverse agrees with the float64 LAPACK one (relative to its
    largest entry: JAX f32 1.6e-6; the port 2.3e-6; tol 5e-5 as there),
    and with the JAX f32 result (1.7e-6; JAX f32 vs its f64 1.6e-6)."""
    floor = 1e-5
    A = _random_sym(rng, 256, cond_exp=7.0).astype(np.float64)
    lam, Q = np.linalg.eigh(A)
    inv_l = np.where(lam > floor * lam[..., 2:3], 1.0 / np.maximum(lam, 1e-300), 0.0)
    P_ref = np.einsum("nij,nj,nkj->nik", Q, inv_l, Q)
    scale = np.abs(P_ref).max(axis=(-2, -1), keepdims=True)
    P_t = _np(linalg.sym3x3_trunc_pinv(t32(A), floor))
    P_j = _np(jlinalg.sym3x3_trunc_pinv(jnp.asarray(A, jnp.float32), floor))
    assert (np.abs(P_t - P_ref) / scale).max() < 5e-5
    assert (np.abs(P_t - P_j) / scale).max() < 1e-5


# ---------------------------------------------------------------------------
# triangulation (tests/test_triangulate.py's multi-view problems)


def _rel(a, b):
    """Max gap relative to each 3x3 block's largest entry."""
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b) / np.abs(b).max(axis=(-2, -1), keepdims=True)))


def _batch(rng, n=8, noise=0.3, n_views=4):
    """n of tests/test_triangulate.py's multi-view problems, stacked."""
    cases = [_multiview(rng, n_views, noise) for _ in range(n)]
    X_gt = np.stack([c[0] for c in cases])
    P = np.stack([c[1] for c in cases]).astype(np.float32)
    obs = np.stack([c[2] for c in cases]).astype(np.float32)
    return X_gt, P, obs, cases


def test_projection_matrix_matches_jax(rng):
    from invcompcamtrack_tpu.core.pose import projection_matrix as jpm
    from invcompcamtrack_torch.core.pose import projection_matrix

    R = geo.se3_exp(np.r_[np.zeros(3), rng.normal(size=3) * 0.2])[:, :3].astype(np.float32)
    tw = rng.normal(size=3).astype(np.float32)
    got = projection_matrix((500.0, 510.0), (320.0, 240.0), t32(R), t32(tw))
    want = jpm((500.0, 510.0), (320.0, 240.0), jnp.asarray(R), jnp.asarray(tw))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-4)


def test_sym3x3_inverse_matches_jax(rng):
    # well-conditioned blocks: JAX f32 vs f64 6.0e-7 relative; the port
    # 0.0 from JAX f32 (the same cofactor expressions)
    A = _random_sym(rng, 64)
    got = _np(tr.sym3x3_inverse(torch.from_numpy(A)))
    want = _np(jtr.sym3x3_inverse(jnp.asarray(A)))
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_triangulate_dlt_and_gn_match_jax(rng):
    # DLT: JAX f32 vs f64 7.7e-7 in X (points ~2 from cameras ~4 away),
    # the port 9.5e-7 from JAX f32; covariances relative to their largest
    # entry 2.4e-7 / 3.2e-7.  GN (8 steps): JAX f32 vs f64 1.2e-6, the port
    # 1.2e-6; covariances 4.3e-7 / 4.5e-7.
    _, P, obs, cases = _batch(rng)
    X_t, cov_t = tr.triangulate_dlt(t32(P), t32(obs))
    X_j, cov_j = jtr.triangulate_dlt(jnp.asarray(P), jnp.asarray(obs))
    np.testing.assert_allclose(_np(X_t), _np(X_j), atol=1e-5)
    assert _rel(cov_t, cov_j) < 3e-6
    X0 = (_np(X_j) + rng.normal(size=(len(P), 3)) * 0.2).astype(np.float32)
    Xg_t, covg_t = tr.triangulate_gn(t32(P), t32(obs), t32(X0), num_iters=8)
    Xg_j, covg_j = jtr.triangulate_gn(jnp.asarray(P), jnp.asarray(obs), jnp.asarray(X0),
                                      num_iters=8)
    np.testing.assert_allclose(_np(Xg_t), _np(Xg_j), atol=1e-5)
    assert _rel(covg_t, covg_j) < 3e-6
    # and against the float64 oracle (the port: 7.3e-7)
    for i, (_, P_l, pt2d, _, _) in enumerate(cases):
        Xo = ora.gauss_newton(list(P_l), pt2d, X0[i].astype(np.float64), num_iters=8)
        np.testing.assert_allclose(_np(Xg_t[i]), Xo, atol=1e-5)


def test_triangulate_lm_matches_jax(rng):
    # X after 8 steps: JAX f32 vs f64 6.2e-7, the port 1.2e-6 from JAX f32.
    # The covariance is not compared: it is the inverse of whichever damped
    # system the last accept/reject picked, and JAX's own f32 and f64 runs
    # part by 4.6 x (relative) there
    _, P, obs, cases = _batch(rng, noise=0.5)
    X0 = np.stack([c[0] for c in cases]) + rng.normal(size=(len(P), 3)) * 0.3
    X0 = X0.astype(np.float32)
    X_t, cov_t = tr.triangulate_lm(t32(P), t32(obs), t32(X0), num_iters=8)
    X_j, _ = jtr.triangulate_lm(jnp.asarray(P), jnp.asarray(obs), jnp.asarray(X0),
                                num_iters=8)
    np.testing.assert_allclose(_np(X_t), _np(X_j), atol=1e-5)
    assert np.isfinite(_np(cov_t)).all()
    for i, (_, P_l, pt2d, _, _) in enumerate(cases):
        Xo = ora.lm(list(P_l), pt2d, X0[i].astype(np.float64), num_iters=8)
        np.testing.assert_allclose(_np(X_t[i]), Xo, atol=1e-5)


def test_triangulate_depth_only_matches_jax(rng):
    # JAX f32 vs f64 5.4e-7 in X, 5.2e-7 relative in the variance; the
    # port 4.8e-7 and 4.5e-7 from JAX f32
    X_gt, P, obs, cases = _batch(rng, noise=0.2)
    campos = np.stack([c[4][0] for c in cases])
    d = X_gt - campos
    ptdir = d / np.linalg.norm(d, axis=1, keepdims=True)
    X0 = X_gt + ptdir * 0.4
    args = [a.astype(np.float32) for a in (P, obs, campos, ptdir, X0)]
    X_t, var_t = tr.triangulate_depth_only(*map(t32, args), num_iters=8)
    X_j, var_j = jtr.triangulate_depth_only(*map(jnp.asarray, args), num_iters=8)
    np.testing.assert_allclose(_np(X_t), _np(X_j), atol=5e-6)
    np.testing.assert_allclose(_np(var_t), _np(var_j), rtol=5e-6)
    assert (_np(var_t) > 0).all()


def test_triangulate_mask_and_chirality_match_jax(rng):
    """A 6-view problem with 2 garbage views masked out, and the DLT's
    chirality NaN-out, as in tests/test_triangulate.py."""
    X_gt, P, obs, cases = _batch(rng, n=4, noise=0.1)
    P6 = np.concatenate([P, P[:, :2]], axis=1)
    obs6 = np.concatenate([obs, obs[:, :2] + 100.0], axis=1)
    mask = np.array([1.0, 1.0, 1.0, 1.0, 0.0, 0.0], np.float32)
    X_t, _ = tr.triangulate_dlt(t32(P6), t32(obs6), mask=t32(mask))
    X4_t, _ = tr.triangulate_dlt(t32(P), t32(obs))
    np.testing.assert_allclose(_np(X_t), _np(X4_t), rtol=1e-6)
    X0 = (X_gt + 0.1).astype(np.float32)
    Xg_t, _ = tr.triangulate_gn(t32(P6), t32(obs6), t32(X0), num_iters=5, mask=t32(mask))
    Xg_j, _ = jtr.triangulate_gn(jnp.asarray(P6), jnp.asarray(obs6), jnp.asarray(X0),
                                 num_iters=5, mask=jnp.asarray(mask))
    # (JAX f32 vs f64 7.2e-7; the port 7.2e-7 from JAX f32)
    np.testing.assert_allclose(_np(Xg_t), _np(Xg_j), atol=5e-6)
    # chirality: the flipped rotation NaNs out exactly where JAX does
    R0 = np.stack([c[3][0] for c in cases]).astype(np.float32)
    c0 = np.stack([c[4][0] for c in cases]).astype(np.float32)
    for sign in (1.0, -1.0):
        Xc_t, cc_t = tr.triangulate_dlt(t32(P), t32(obs), R0=t32(sign * R0), c0=t32(c0))
        Xc_j, _ = jtr.triangulate_dlt(jnp.asarray(P), jnp.asarray(obs),
                                      R0=jnp.asarray(sign * R0), c0=jnp.asarray(c0))
        np.testing.assert_array_equal(np.isnan(_np(Xc_t)), np.isnan(_np(Xc_j)))
        assert np.isnan(_np(cc_t)).any(axis=(1, 2)).tolist() == np.isnan(
            _np(Xc_t)).any(axis=1).tolist()


# ---------------------------------------------------------------------------
# epipolar geometry and the two-view bootstrap


def _two_view(rng, n=64, noise=0.0):
    """Normalised matches of n points seen from the identity and from a
    pose with a 0.3-unit baseline; the second view's pose (6,)."""
    X = np.c_[rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 9, n)]
    p1 = np.r_[0.3, 0.05, -0.04, 0.02, -0.03, 0.01]
    G = geo.se3_exp(p1)
    Xc = X @ G[:, :3].T + G[:, 3]
    xn0 = X[:, :2] / X[:, 2:]
    xn1 = Xc[:, :2] / Xc[:, 2:]
    xn1 = xn1 + rng.normal(size=xn1.shape) * noise
    return xn0.astype(np.float32), xn1.astype(np.float32), p1


def _unit_sign(F):
    F = F / np.linalg.norm(F, axis=(-2, -1), keepdims=True)
    i = np.argmax(np.abs(F.reshape(F.shape[:-2] + (9,))), axis=-1)
    s = np.sign(np.take_along_axis(F.reshape(F.shape[:-2] + (9,)), i[..., None], -1))
    return F * s[..., None]


def test_fundamental_8pt_and_sampson_match_jax(rng):
    """F up to sign and scale (its eigenvector's sign is arbitrary).

    On a batch of 12-point samples of normalised matches (a 0.3 baseline
    at depths 4-9) the smallest eigenvector of the 9x9 A^T A is
    ill-conditioned in float32: unit-normalised, JAX's f32 F sits 3.0e-3
    from its f64 F, and the port's 2.9e-3 from JAX f32.  So each is held
    to the JAX f64 result, the port within 3 x JAX f32's own gap.  The
    weighted refit over all 64 matches: JAX f32 vs f64 9.1e-5, the port
    3.9e-4 from JAX f32 and 3.0e-4 from JAX f64 (two float32
    eigensolvers, whose own gap reaches 3.0e-3 above), tol 1e-3.  The Sampson
    and epiline distances on one F: the port equals JAX f32 (0.0); JAX f32
    vs f64 3.4e-12 of distances up to 1.7e-7, 2.8e-8 of up to 5.8e-4."""
    xa, xb, _ = _two_view(rng, n=64, noise=2e-4)
    idx = np.stack([rng.choice(64, 12, replace=False) for _ in range(16)])
    F_t = _unit_sign(_np(epipolar.fundamental_8pt(t32(xa)[idx], t32(xb)[idx])))
    F_j = _unit_sign(_np(jepi.fundamental_8pt(jnp.asarray(xa)[idx], jnp.asarray(xb)[idx])))
    F_64 = _unit_sign(_np(jepi.fundamental_8pt(jnp.asarray(xa, jnp.float64)[idx],
                                               jnp.asarray(xb, jnp.float64)[idx])))
    assert np.abs(F_t - F_64).max() <= 3 * np.abs(F_j - F_64).max()
    w = (rng.uniform(size=64) > 0.2).astype(np.float32)
    Fw_t = epipolar.fundamental_8pt(t32(xa), t32(xb), weights=t32(w))
    Fw_j = jepi.fundamental_8pt(jnp.asarray(xa), jnp.asarray(xb), weights=jnp.asarray(w))
    np.testing.assert_allclose(_unit_sign(_np(Fw_t)), _unit_sign(_np(Fw_j)), atol=1e-3)
    F_in = jnp.asarray(_np(Fw_t), jnp.float32)
    d_t = _np(epipolar.sampson_distance(Fw_t, t32(xa), t32(xb)))
    d_j = _np(jepi.sampson_distance(F_in, jnp.asarray(xa), jnp.asarray(xb)))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-12)
    e_t = _np(epipolar.epiline_distance(Fw_t, t32(xa), t32(xb)))
    e_j = _np(jepi.epiline_distance(F_in, jnp.asarray(xa), jnp.asarray(xb)))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5, atol=1e-7)


def test_fit_fundamental_ransac_given_samples(rng):
    """The port's F-RANSAC on the JAX call's own samples picks the same
    hypothesis and inlier set (pixel matches with 20 % gross outliers)."""
    import jax

    xa, xb, _ = _two_view(rng, n=80, noise=0.0)
    xa, xb = xa * 500 + 320, xb * 500 + 240
    out = rng.uniform(size=80) < 0.2
    xb[out] += rng.normal(size=(out.sum(), 2)).astype(np.float32) * 30
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 64)
    idx = np.asarray(jax.vmap(lambda k: jax.random.choice(k, 80, shape=(8,),
                                                          replace=False))(keys))
    r_j = jepi.fit_fundamental_ransac(key, jnp.asarray(xa), jnp.asarray(xb),
                                      n_samples=64, thresh=1.0)
    r_t = epipolar.fit_fundamental_ransac(torch.from_numpy(idx), t32(xa), t32(xb),
                                          thresh=1.0)
    assert int(r_t.best) == int(r_j.best)
    np.testing.assert_array_equal(_np(r_t.inliers), _np(r_j.inliers))
    assert int(r_t.num_inliers) == int(r_j.num_inliers) >= 0.7 * 80


def test_sample_indices_rows_without_repeats():
    idx = epipolar.sample_indices(50, 256)
    assert idx.shape == (256, 8) and idx.device.type == "cpu"
    assert all(len(set(r.tolist())) == 8 for r in idx)
    assert int(idx.min()) >= 0 and int(idx.max()) < 50
    assert torch.equal(idx, epipolar.sample_indices(50, 256))


def test_decompose_essential_same_candidate_set(rng):
    """The four candidates as a set (the SVD's signs and order may
    differ): each port candidate equals one JAX candidate (the port 1.5e-7
    from JAX f32, JAX f32 vs f64 2.1e-7), and the true pose is among them
    (2.3e-7)."""
    _, _, p1 = _two_view(rng)
    G = geo.se3_exp(p1)
    t = G[:, 3] / np.linalg.norm(G[:, 3])
    E = geo.skew(t) @ G[:, :3]
    E = E.astype(np.float32)
    C_t = _np(twoview.decompose_essential(t32(E)))
    C_j = _np(jtwo.decompose_essential(jnp.asarray(E)))
    for c in C_t:
        assert min(np.abs(c - cj).max() for cj in C_j) < 1e-5
    for cj in C_j:
        assert min(np.abs(c - cj).max() for c in C_t) < 1e-5
    want = np.c_[G[:, :3], t]
    assert min(np.abs(c - want).max() for c in C_t) < 1e-5


def test_initialize_two_view_given_jax_samples(rng):
    """The sample-taking part of initialize_two_view, fed the indices that
    the JAX call draws: the same valid set and inlier count, and the pose
    and seeds within the float32 eigensolver's reach (the refit's 9x9
    eigenvector, above).  Over seeds 0-3 of this set-up: pose, JAX f32 vs
    f64 1.2e-4 to 4.9e-4, the port 9.1e-5 to 2.9e-4 from JAX f32; seeds
    at depths 4-9, JAX f32 vs f64 9.8e-4 to 6.8e-3, the port 1.7e-3 to
    5.7e-3.  Tolerances 1e-3 and 2e-2."""
    import jax

    xn0, xn1, p1 = _two_view(rng, n=96, noise=1e-4)
    valid = rng.uniform(size=96) > 0.1
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 256)
    idx = np.asarray(jax.vmap(lambda k: jax.random.choice(k, 96, shape=(8,),
                                                          replace=False))(keys))
    r_j = jtwo.initialize_two_view(key, jnp.asarray(xn0), jnp.asarray(xn1),
                                   jnp.asarray(valid))
    r_t = twoview.initialize_two_view(torch.from_numpy(idx), t32(xn0), t32(xn1),
                                      torch.tensor(valid))
    np.testing.assert_allclose(_np(r_t.pose1), _np(r_j.pose1), atol=1e-3)
    np.testing.assert_array_equal(_np(r_t.valid), _np(r_j.valid))
    assert int(r_t.num_inliers) == int(r_j.num_inliers)
    v = _np(r_t.valid).astype(bool)
    np.testing.assert_allclose(_np(r_t.landmarks)[v], _np(r_j.landmarks)[v], atol=2e-2)
    assert np.isnan(_np(r_t.landmarks)[~v]).all()
    # the recovered direction of motion is the true one (scale is free)
    G_t = geo.se3_exp(_np(r_t.pose1))
    G_gt = geo.se3_exp(p1)
    np.testing.assert_allclose(G_t[:, :3], G_gt[:, :3], atol=1e-3)
    np.testing.assert_allclose(G_t[:, 3], G_gt[:, 3] / np.linalg.norm(G_gt[:, 3]), atol=1e-2)


# ---------------------------------------------------------------------------
# trajectory metrics


def test_trajectory_metrics_match_jax(rng):
    # float32 centres ~1-5.  s, R, t: the port 0.0, 2.3e-7, 3.0e-7 from
    # JAX f32, JAX f32 vs f64 2.1e-7, 1.4e-7, 1.8e-7.  ATE relative (scaled
    # / unscaled): 1.5e-6 / 1.0e-7, JAX f32 vs f64 8.6e-7 / 4.1e-8; RPE
    # 1.1e-7 / 7.7e-8; the rotation RPE 9.6e-6 / 9.9e-6.  The rotation RPE
    # of identical rotations is arccos of a float32 trace: 2.2e-4 here,
    # 0.0 in JAX f32 (sqrt(2 eps) is 4.9e-4)
    src = rng.normal(size=(30, 3))
    R = geo.se3_exp(np.r_[np.zeros(3), 0.3, -0.2, 0.5])[:, :3]
    dst = (1.7 * src @ R.T + [1.0, -2.0, 3.0] + rng.normal(size=(30, 3)) * 0.01)
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    s_t, R_t, t_t = metrics.umeyama_align(t32(src), t32(dst))
    s_j, R_j, t_j = jmet.umeyama_align(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-6)
    np.testing.assert_allclose(_np(R_t), _np(R_j), atol=1e-6)
    np.testing.assert_allclose(_np(t_t), _np(t_j), atol=1e-5)
    for ws in (True, False):
        np.testing.assert_allclose(
            float(metrics.ate_rmse(t32(src), t32(dst), with_scale=ws)),
            float(jmet.ate_rmse(jnp.asarray(src), jnp.asarray(dst), with_scale=ws)),
            rtol=5e-6)
    np.testing.assert_allclose(float(metrics.rpe_trans(t32(src), t32(dst), delta=2)),
                               float(jmet.rpe_trans(jnp.asarray(src), jnp.asarray(dst),
                                                    delta=2)), rtol=1e-6)
    Rg = np.stack([geo.se3_exp(np.r_[np.zeros(3), rng.normal(size=3) * 0.1])[:, :3]
                   for _ in range(6)]).astype(np.float32)
    dR = geo.se3_exp(np.r_[np.zeros(3), 0.0, 0.0, 0.05])[:, :3]
    Re = Rg.copy()
    Re[1::2] = np.einsum("ij,njk->nik", dR, Rg[1::2])
    got = float(metrics.rpe_rot(t32(Re), t32(Rg)))
    np.testing.assert_allclose(got, float(jmet.rpe_rot(jnp.asarray(Re), jnp.asarray(Rg))),
                               rtol=5e-5)
    np.testing.assert_allclose(got, 0.05, rtol=1e-3)
    assert float(metrics.rpe_rot(t32(Rg), t32(Rg))) < 1e-3
