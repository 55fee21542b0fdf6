"""Multi-camera rig triangulation and rig pose tracking (port of
``invcompcamtrack_tpu/vo/rig.py``).

A rig is a set of C cameras with fixed extrinsics relative to the rig
body: cam_c = extr_c . rig (both [R|t] world -> frame), the reference's
12-camera van-rig workload (reference:
run_GeoAutomation_triangulation_test.py.ipynb cells 4, 6, 10).  Landmarks
are triangulated across cameras and rig poses with the masked multi-view
machinery of ``sfm/triangulate.py``, and a rig pose is refined by damped
GN over se(3) with a ``torch.func.jacfwd`` Jacobian, a Python loop of
``num_iters`` steps where the JAX module scans, each solve
``torch.linalg.solve_ex`` (no host sync).
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core.pose import projection_matrix
from invcompcamtrack_torch.sfm.triangulate import triangulate_dlt, triangulate_gn


def rig_camera_poses(rig_pose: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    """rig_pose: (..., 6) se3; extrinsics: (C, 3, 4) cam-from-rig.
    Returns (..., C, 3, 4) cam-from-world."""
    G_rig = lie.se3_exp(rig_pose)[..., None, :, :]
    return lie.se3_compose(extrinsics, G_rig)


def rig_projection_matrices(rig_pose, extrinsics, fc, cc):
    """(..., C, 3, 4) P-matrices in the triangulation convention."""
    G = rig_camera_poses(rig_pose, extrinsics)
    return projection_matrix(fc, cc, G[..., :3], lie.camera_center(G))


def triangulate_rig_tracks(rig_poses: torch.Tensor, extrinsics: torch.Tensor,
                           obs: torch.Tensor, mask: torch.Tensor, fc, cc,
                           refine_iters: int = 4):
    """N-view triangulation of tracks observed across rig poses and
    cameras.

    rig_poses: (T, 6); extrinsics: (C, 3, 4);
    obs: (L, T, C, 2) pixel observations; mask: (L, T, C).
    Returns (X (L, 3), cov (L, 3, 3)).
    """
    T, C = rig_poses.shape[0], extrinsics.shape[0]
    P_flat = rig_projection_matrices(rig_poses, extrinsics, fc, cc).reshape(T * C, 3, 4)
    L = obs.shape[0]
    P_b = P_flat.expand((L, T * C, 3, 4))
    obs_f = obs.reshape(L, T * C, 2)
    m = mask.reshape(L, T * C).to(obs.dtype)
    X0, _ = triangulate_dlt(P_b, obs_f, mask=m)
    X0 = torch.nan_to_num(X0)
    return triangulate_gn(P_b, obs_f, X0, num_iters=refine_iters, mask=m)


def refine_rig_pose(rig_pose0: torch.Tensor, extrinsics: torch.Tensor,
                    X: torch.Tensor, obs: torch.Tensor, mask: torch.Tensor,
                    fc, cc, num_iters: int = 8, damp: float = 1e-4):
    """Refine one rig pose against known 3-D points (the reference's
    cell-10 LM).  X: (L, 3); obs: (L, C, 2); mask: (L, C).
    Returns (pose (6,), final mean-squared residual)."""
    fc = torch.as_tensor(fc, dtype=X.dtype, device=X.device)
    cc = torch.as_tensor(cc, dtype=X.dtype, device=X.device)

    def residuals(p):
        G = rig_camera_poses(p, extrinsics)            # (C, 3, 4)
        # a broadcast product and sum, not einsum: under jacfwd the tangent
        # of a float32 pose can be float64 (core/lie.py), which einsum refuses
        Xc = torch.sum(G[None, :, :, :3] * X[:, None, None, :], dim=-1) + G[None, :, :, 3]
        # masked points may sit at z ~ 0: guard the division BEFORE the
        # mask multiply (inf * 0 = NaN)
        z = torch.where(mask, Xc[..., 2], torch.ones_like(Xc[..., 2]))
        proj = Xc[..., :2] / z[..., None] * fc + cc
        return ((obs - proj) * mask[..., None]).reshape(-1)

    jac = torch.func.jacfwd(residuals)
    eye = torch.eye(6, dtype=rig_pose0.dtype, device=rig_pose0.device)
    p = rig_pose0
    msq = torch.full((), float("inf"), dtype=rig_pose0.dtype, device=rig_pose0.device)
    for _ in range(num_iters):
        r = residuals(p)
        J = jac(p).to(p.dtype)                         # (2LC, 6)
        H = torch.einsum("ki,kj->ij", J, J)
        H = H + damp * eye * torch.clamp(torch.diagonal(H), min=1e-9)
        g = torch.einsum("ki,k->i", J, r)
        # J is the Jacobian of the RESIDUAL (obs - proj), so the GN step
        # is p - H^{-1} J^T r
        delta = torch.linalg.solve_ex(H, g[:, None], check_errors=False)[0][:, 0]
        p = p - delta
        msq = torch.mean(residuals(p) ** 2)
    return p, msq
