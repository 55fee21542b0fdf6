"""Pose normalisation, projection and the frustum test (port of
``invcompcamtrack_tpu/core/pose.py``).

Same semantics as the JAX module, quirks included: ``normalize_points``
divides by the mean squared distance ``varval`` itself, not its square
root (reference: odometer.cpp:184-226), and ``in_frustum`` is
border-inclusive.  All functions batch over leading dimensions.
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core.camera import distort


def normalize_points(X: torch.Tensor, mask: torch.Tensor | None = None):
    """X: (..., N, 3) -> (Xn, mean (..., 3), varval (...,)) with
    ``varval = mean_i ||X_i - mean||^2`` and ``Xn = (X - mean) / varval``.

    An optional boolean ``mask`` (..., N) restricts the statistics to the
    selected points; masked-out rows are still normalised with them.
    """
    if mask is None:
        mean = torch.mean(X, dim=-2, keepdim=True)
        centered = X - mean
        varval = torch.mean(torch.sum(centered * centered, dim=-1), dim=-1)
    else:
        m = mask[..., None].to(X.dtype)
        cnt = torch.clamp(torch.sum(m, dim=-2, keepdim=True), min=1.0)
        mean = torch.sum(X * m, dim=-2, keepdim=True) / cnt
        centered = X - mean
        varval = (torch.sum(torch.sum(centered * centered, dim=-1) * m[..., 0],
                            dim=-1) / cnt[..., 0, 0])
    Xn = centered / varval[..., None, None]
    return Xn, mean[..., 0, :], varval


def _pose_with_center(R: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    t = -lie.matvec(R, c)
    return lie.se3_log(torch.cat([R, t[..., None]], dim=-1))


def normalize_pose(p: torch.Tensor, mean: torch.Tensor,
                   varval: torch.Tensor) -> torch.Tensor:
    """c = -R^T t; c' = (c - mean)/varval; t' = -R c'; p' = log([R | t'])."""
    G = lie.se3_exp(p)
    c = (lie.camera_center(G) - mean) / varval[..., None]
    return _pose_with_center(G[..., :3], c)


def unnormalize_pose(p: torch.Tensor, mean: torch.Tensor,
                     varval: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`normalize_pose`."""
    G = lie.se3_exp(p)
    c = lie.camera_center(G) * varval[..., None] + mean
    return _pose_with_center(G[..., :3], c)


def transform_points(G: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """x_cam = R X + t.  G: (..., 3, 4), X: (..., N, 3) -> (..., N, 3)."""
    return torch.matmul(X, G[..., :3].transpose(-1, -2)) + G[..., None, :, 3]


def project_points(G: torch.Tensor, X: torch.Tensor, fx, fy, cx, cy,
                   return_cam: bool = False):
    """Pinhole projection -> (..., N, 2) pixel coords (and optionally the
    camera-frame points)."""
    Xc = transform_points(G, X)
    z = Xc[..., 2]
    uv = torch.stack([(Xc[..., 0] / z) * fx + cx,
                      (Xc[..., 1] / z) * fy + cy], dim=-1)
    if return_cam:
        return uv, Xc
    return uv


def in_frustum(uv: torch.Tensor, swo, sho) -> torch.Tensor:
    """Invalid iff x<0 | y<0 | x>swo | y>sho (border-inclusive)."""
    x, y = uv[..., 0], uv[..., 1]
    return (x >= 0) & (y >= 0) & (x <= swo) & (y <= sho)


def reproject(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor, fc, cc, kc=None,
              camcenter: bool = False) -> torch.Tensor:
    """The python layer's reprojection with optional distortion
    (reference: func_util_geom.py:519-536); leading axes broadcast.

    camcenter=False: x_cam = R (X - t)   [t = world camera center]
    camcenter=True:  x_cam = R X - t
    """
    if camcenter:
        Xc = torch.einsum("...ij,...nj->...ni", R, X) - t[..., None, :]
    else:
        Xc = torch.einsum("...ij,...nj->...ni", R, X - t[..., None, :])
    pn = Xc[..., 0:2] / Xc[..., 2:3]
    if kc is not None:
        pn = distort(pn, kc)
    fc = torch.as_tensor(fc, dtype=pn.dtype, device=pn.device)
    cc = torch.as_tensor(cc, dtype=pn.dtype, device=pn.device)
    return pn * fc + cc


def projection_matrix(fc, cc, R: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """P = K [-R | R tw], the reference python layer's (sign-flipped)
    projection-matrix convention of the triangulation stack (reference:
    func_util_geom.py:538-545); tw is the world camera center."""
    fc = torch.as_tensor(fc, dtype=R.dtype, device=R.device)
    cc = torch.as_tensor(cc, dtype=R.dtype, device=R.device)
    K = torch.zeros(R.shape[:-2] + (3, 3), dtype=R.dtype, device=R.device)
    K[..., 0, 0] = fc[..., 0]
    K[..., 1, 1] = fc[..., 1]
    K[..., 0, 2] = cc[..., 0]
    K[..., 1, 2] = cc[..., 1]
    K[..., 2, 2] = 1.0
    P = torch.cat([-R, lie.matvec(R, tw)[..., None]], dim=-1)
    return torch.matmul(K, P)
