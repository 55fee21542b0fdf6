"""Covariance propagation and uncertainty-visualisation helpers (port of
``invcompcamtrack_tpu/sfm/covariance.py``).

- 3-D point covariance -> 2-D reprojection covariance through the
  projection Jacobian (reference: func_util_geom.py:429-445; the
  triangulation stack's P = K[-R | R t] convention),
- covariance ellipsoid (3-D) and ellipse (2-D) parameters for plotting
  (reference: func_util_geom.py:396-427), from ``torch.linalg.eigh`` as
  the JAX module takes ``jnp.linalg.eigh``.
"""

from __future__ import annotations

import math

import torch

from invcompcamtrack_torch.sfm.triangulate import _proj_jacobian


def project_cov_3d_to_2d(cov3: torch.Tensor, X: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """cov3: (..., 3, 3); X: (..., 3); P: (..., 3, 4) -> (..., 2, 2)."""
    J = _proj_jacobian(P[..., None, :, :], X)[..., 0, :, :]  # (..., 2, 3)
    return torch.einsum("...ij,...jk,...lk->...il", J, cov3, J)


def cov_ellipse(cov2: torch.Tensor, n_std: float = 1.0):
    """2-D covariance -> (width, height, angle_deg) of the n-sigma
    ellipse (reference: func_get_cov_ellipe, func_util_geom.py:415-427)."""
    evals, evecs = torch.linalg.eigh(cov2)
    order = torch.argsort(evals, dim=-1, stable=True).flip(-1)
    evals = torch.gather(evals, -1, order)
    v = torch.gather(evecs, -1, order[..., None, :].expand(evecs.shape))
    angle = torch.atan2(v[..., 1, 0], v[..., 0, 0]) * (180.0 / math.pi)
    width = 2.0 * n_std * torch.sqrt(torch.clamp(evals[..., 0], min=0.0))
    height = 2.0 * n_std * torch.sqrt(torch.clamp(evals[..., 1], min=0.0))
    return width, height, angle


def cov_ellipsoid_axes(cov3: torch.Tensor, n_std: float = 1.0):
    """3-D covariance -> principal semi-axes (3,) and rotation (3, 3)
    (reference: func_get_cov_ellipsoid, func_util_geom.py:396-413)."""
    evals, evecs = torch.linalg.eigh(cov3)
    return n_std * torch.sqrt(torch.clamp(evals, min=0.0)), evecs
