"""Batched RANSAC camera-pose fitting (port of
``invcompcamtrack_tpu/sfm/ransac.py``).

The reference's sequential RANSAC driver (reference:
func_ransac_fitcameras_odom.m:29-87) as one batched hypothesis pool:

- the caller's ``(S, sample_size)`` index sets (drawn on the CPU by
  ``sfm/epipolar.py::sample_indices``, so that the card and the CPU see
  the same samples; the JAX module's ``jax.random`` stream cannot be
  reproduced),
- the collinearity degeneracy test of every sample (reference: :175-194),
- batched linear PnP (``pnp_auto``; replaces ASPnP),
- reprojection-error inliers against ALL correspondences with the
  distorted model (reference: :47-54), an inlier-weighted PnP refit of
  every hypothesis, and the ``min_inliers`` gate (reference: :50, :83-87).

Invalid hypotheses keep their slot with ``valid=False``: fixed shapes, no
compaction, no host sync.  The winner is chosen downstream by odometry
verification (``solver/chain.py::track_nposes`` and ``select_best``), the
reference's "highest mean patch correlation wins" (reference: :151-154).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core.camera import distort, undistort
from invcompcamtrack_torch.sfm.pnp import collinearity_degenerate, pnp_auto


class RansacResult(NamedTuple):
    poses: torch.Tensor        # (S, 6) se(3) coefficients of [R|t]
    G: torch.Tensor            # (S, 3, 4)
    inliers: torch.Tensor      # (S, N) bool
    num_inliers: torch.Tensor  # (S,)
    valid: torch.Tensor        # (S,) hypothesis survived all gates


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)


def reprojection_errors(G, Xw, pt2d, fc, cc, kc=None):
    """Pixel reprojection error of [R|t] (..., 3, 4) against observations
    pt2d (N, 2) of Xw (N, 3), with the reference's distortion model
    applied to the projections (reference: :47-49) -> (..., N)."""
    Xc = torch.einsum("...ij,...nj->...ni", G[..., :3], Xw) + G[..., None, :, 3]
    pn = Xc[..., 0:2] / Xc[..., 2:3]
    if kc is not None:
        pn = distort(pn, kc)
    proj = pn * _like(fc, pn) + _like(cc, pn)
    return torch.linalg.norm(proj - pt2d, dim=-1)


def fit_camera_ransac(idx: torch.Tensor, pt2d: torch.Tensor, pt3d: torch.Tensor,
                      fc, cc, kc=None, inl_thresh: float = 10.0,
                      min_inliers: int = 5) -> RansacResult:
    """idx: (S, sample_size) int indices into the N correspondences
    (``sample_indices(N, S, k=sample_size, generator)``; sample_size >= 6
    for the linear PnP); pt2d: (N, 2) pixel observations; pt3d: (N, 3)
    world points.

    Returns S hypotheses (poses as [R|t], the tracker's convention).
    """
    idx = idx.to(pt2d.device)
    S = idx.shape[0]
    fc = _like(fc, pt2d)
    cc = _like(cc, pt2d)

    # undistort once for the solver, keep the raw points for inlier
    # scoring (reference: :22-25, :47)
    pn = (pt2d - cc) / fc
    if kc is not None:
        pn = undistort(pn, kc)

    samp3d = pt3d[idx]   # (S, n, 3)
    samp2n = pn[idx]     # (S, n, 2)
    samp2d = pt2d[idx]

    degen = collinearity_degenerate(samp2d, samp3d)
    G, pnp_bad = pnp_auto(samp3d, samp2n)

    err = reprojection_errors(G, pt3d, pt2d, fc, cc, kc)
    inl = err <= inl_thresh

    # least-squares refit on each hypothesis' inlier set (weighted PnP
    # over the full correspondence set; the points broadcast, not copied)
    w = inl.to(G.dtype)
    Xb = pt3d.expand((S,) + tuple(pt3d.shape))
    pnb = pn.expand((S,) + tuple(pn.shape))
    G_refit, refit_bad = pnp_auto(Xb, pnb, weights=w)
    err_refit = reprojection_errors(G_refit, pt3d, pt2d, fc, cc, kc)
    better = (torch.sum(err_refit <= inl_thresh, -1) >= torch.sum(inl, -1)) & (~refit_bad)
    G = torch.where(better[..., None, None], G_refit, G)
    err = torch.where(better[..., None], err_refit, err)
    inl = err <= inl_thresh
    cnt = torch.sum(inl, dim=-1)
    valid = ((~degen) & (~pnp_bad) & (cnt >= min_inliers)
             & torch.all(torch.isfinite(G.reshape(S, -1)), dim=-1))
    return RansacResult(poses=lie.se3_log(G), G=G, inliers=inl, num_inliers=cnt,
                        valid=valid)
