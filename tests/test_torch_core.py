"""The port's core/ and ops/linalg.py against the JAX package and the
float64 numpy oracle, on the same float32 inputs.

Tolerances: these are short float32 expressions whose operands are of
order 1 (poses, rotations) or 10 (points), so the two frameworks differ
only by the order of a few roundings: 1e-6 absolute on order-1 values
(about 8 ulp), 1e-5 on the order-10 normalisation statistics.  Against
the float64 oracle the float32 rounding itself counts, measured at
1.4e-7 for exp and 1.2e-7 for log on these poses; 1e-6 again.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.core import lie as jlie
from invcompcamtrack_tpu.core import pose as jpose
from invcompcamtrack_tpu.core.camera import CameraPyramid as JCam
from invcompcamtrack_tpu.ops.linalg import cholesky_solve_sym as jchol
from invcompcamtrack_torch import convert
from invcompcamtrack_torch.core import lie, pose
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.ops.linalg import cholesky_solve_sym
from tests.oracles import geometry_np as geo
from tests.torch_helpers import t32


def _poses(rng):
    """Random poses plus zero, tiny and near-threshold rotations."""
    rand = np.c_[rng.normal(size=(12, 3)), rng.normal(scale=0.5, size=(12, 3))]
    special = [[0.1, 0.2, 0.3, 0.0, 0.0, 0.0],
               [0.1, 0.2, 0.3, 1e-12, 0.0, 0.0],
               [1.0, -2.0, 3.0, 1e-6, 0.0, 0.0],
               [0.5, 0.1, 0.2, 3e-5, -2e-5, 1e-5],
               [0.5, 0.1, 0.2, 1e-4, 0.0, 0.0],
               [0.0, 0.0, 0.0, 0.0, 0.0, 2.5]]
    return np.concatenate([rand, special]).astype(np.float32)


def test_se3_exp_log_match_jax_and_oracle(rng):
    P = _poses(rng)
    G_jax = np.asarray(jlie.se3_exp(jnp.asarray(P)))
    G = lie.se3_exp(t32(P)).numpy()
    np.testing.assert_allclose(G, G_jax, atol=1e-6)
    G_ora = np.stack([geo.se3_exp(p.astype(np.float64)) for p in P])
    np.testing.assert_allclose(G, G_ora, atol=1e-6)

    p_jax = np.asarray(jlie.se3_log(jnp.asarray(G_jax)))
    p = lie.se3_log(t32(G_jax)).numpy()
    np.testing.assert_allclose(p, p_jax, atol=1e-6)
    p_ora = np.stack([geo.se3_log(g.astype(np.float64)) for g in G_jax])
    np.testing.assert_allclose(p, p_ora, atol=1e-6)
    # zero and tiny rotations take the guarded branches without NaN
    assert np.all(np.isfinite(G)) and np.all(np.isfinite(p))
    np.testing.assert_array_equal(p[-6, 3:], 0.0)


def test_skew_and_camera_center(rng):
    w = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(lie.skew(t32(w)).numpy(),
                                  np.asarray(jlie.skew(jnp.asarray(w))))
    G = np.asarray(jlie.se3_exp(jnp.asarray(_poses(rng))))
    np.testing.assert_allclose(lie.camera_center(t32(G)).numpy(),
                               np.asarray(jlie.camera_center(jnp.asarray(G))),
                               atol=1e-5)


def test_camera_pyramid_matches_jax():
    fc, cc, wh = (1000.0, 1200.0), (641.5, 358.0), (1280, 720)
    cam_jax = JCam.create(fc, cc, wh, 5, 8)
    cam = CameraPyramid.create(fc, cc, wh, 5, 8)
    for s in range(5):
        for a, b in zip(cam.level(s), cam_jax.level(s)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    conv = convert.camera_from_numpy(cam_jax)
    assert conv.padding == 8 and conv.num_levels == 5
    np.testing.assert_array_equal(conv.fx.numpy(), cam.fx.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_normalize_points_and_poses_match_jax(rng, masked):
    X = (rng.normal(size=(3, 20, 3)) * 3 + 5).astype(np.float32)
    mask = rng.uniform(size=(3, 20)) > 0.3
    jm = jnp.asarray(mask) if masked else None
    tm = torch.as_tensor(mask) if masked else None
    Xn_j, mean_j, var_j = jpose.normalize_points(jnp.asarray(X), jm)
    Xn, mean, var = pose.normalize_points(t32(X), tm)
    np.testing.assert_allclose(Xn.numpy(), np.asarray(Xn_j), atol=1e-6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=1e-6)

    P = _poses(rng)[:3]
    pn_j = jpose.normalize_pose(jnp.asarray(P), mean_j, var_j)
    pn = pose.normalize_pose(t32(P), mean, var)
    np.testing.assert_allclose(pn.numpy(), np.asarray(pn_j), atol=1e-5)
    back = pose.unnormalize_pose(pn, mean, var).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jpose.unnormalize_pose(pn_j, mean_j, var_j)), atol=1e-5)
    np.testing.assert_allclose(back, P, atol=1e-4)  # round trip


def test_projection_and_frustum_match_jax(rng):
    P = _poses(rng)[:4] * 0.1
    X = np.c_[rng.uniform(-2, 2, (4, 30, 2)), rng.uniform(4, 9, (4, 30, 1))]
    X = X.astype(np.float32)
    G_jax = jlie.se3_exp(jnp.asarray(P))
    G = lie.se3_exp(t32(P))
    np.testing.assert_allclose(pose.transform_points(G, t32(X)).numpy(),
                               np.asarray(jpose.transform_points(G_jax, jnp.asarray(X))),
                               atol=1e-5)
    uv_j, Xc_j = jpose.project_points(G_jax, jnp.asarray(X), 300.0, 310.0, 161.5,
                                      118.0, return_cam=True)
    uv, Xc = pose.project_points(G, t32(X), 300.0, 310.0, 161.5, 118.0,
                                 return_cam=True)
    np.testing.assert_allclose(uv.numpy(), np.asarray(uv_j), atol=2e-3)
    np.testing.assert_allclose(Xc.numpy(), np.asarray(Xc_j), atol=1e-5)
    # border-inclusive: points exactly on 0 and on (swo, sho) are inside
    uv_b = np.array([[0.0, 0.0], [320.0, 240.0], [320.0, 0.0], [-1e-3, 5.0],
                     [5.0, 240.001], [160.0, 120.0]], np.float32)
    np.testing.assert_array_equal(
        pose.in_frustum(t32(uv_b), 320.0, 240.0).numpy(),
        np.asarray(jpose.in_frustum(jnp.asarray(uv_b), 320.0, 240.0)))
    assert pose.in_frustum(t32(uv_b), 320.0, 240.0).tolist() == [
        True, True, True, False, False, True]


def test_cholesky_solve_sym_matches_jax(rng):
    A = rng.normal(size=(8, 6, 6))
    H = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(6)
    H[0] = H[0] * np.r_[1e4, 1e4, 1e4, 1e-2, 1e-2, 1e-2][:, None] \
        * np.r_[1e4, 1e4, 1e4, 1e-2, 1e-2, 1e-2][None, :]  # unit imbalance
    B3 = rng.normal(size=(6, 3))
    H[1] = B3 @ B3.T                                       # rank 3
    H = H.astype(np.float32)
    b = rng.normal(size=(8, 6)).astype(np.float32)
    x_j = np.asarray(jchol(jnp.asarray(H), jnp.asarray(b)))
    x = cholesky_solve_sym(t32(H), t32(b)).numpy()
    # term-for-term the same arithmetic: only the last rounding may differ;
    # the rank-3 system breaks down (nan/inf) identically in both
    np.testing.assert_array_equal(np.isfinite(x), np.isfinite(x_j))
    assert np.all(np.isfinite(x[[0] + list(range(2, 8))]))
    fin = np.isfinite(x_j)
    np.testing.assert_allclose(x[fin], x_j[fin], rtol=1e-5,
                               atol=1e-6 * np.abs(x_j[fin]).max())
    x64 = np.linalg.solve(H[2:].astype(np.float64),
                          b[2:, :, None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(x[2:], x64, rtol=1e-3, atol=1e-4)
