"""Batched multi-view triangulation: DLT, Gauss-Newton, LM, depth-only
(port of ``invcompcamtrack_tpu/sfm/triangulate.py``).

Conventions of the JAX module, kept:

- projection matrices use the reference python layer's sign convention
  ``P = K [-R | R t_w]`` (``core.pose.projection_matrix``),
- residuals are ``observed - projected``, mean-squared over ``2 V``
  (reference: triang.c:9-32),
- DLT solves the inhomogeneous normal equations with ``(A^T A)^{-1}`` as
  the covariance estimate and a chirality NaN-out
  (reference: triang.c:262-322, func_util_geom.py:565-579),
- LM damping multiplies the diagonal of J^T J by (1 + damp); a step is
  re-taken once with more damping when the residual does not drop
  (reference: triang.c:327-373),
- depth-only GN optimises the distance along the first view's ray
  (reference: triang.c:378-435).

Each ``lax.scan`` of the JAX module is a fixed Python loop of
``num_iters`` steps with the same freeze masks, and every accept/reject
is a ``torch.where``: nothing reads a value back to the host.  An
optional per-view boolean ``mask`` supports variable-length tracks.
Every function batches over leading axes (the streams of the
multi-stream VO engine: ``P (S, C, V, 3, 4)``, ``pt2d (S, C, V, 2)``,
and for ``triangulate_dlt`` ``R0 (S, 1, 3, 3)``, ``c0 (S, 1, 3)``), each
point solved as alone.
"""

from __future__ import annotations

import torch


def _hom(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def project_P(P: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """P: (..., V, 3, 4); X: (..., 3) -> (..., V, 2) pixel coords."""
    ph = torch.einsum("...vij,...j->...vi", P, _hom(X))
    return ph[..., :2] / ph[..., 2:3]


def residuals(P, pt2d, X, mask=None):
    """(res, res_msq): res = observed - projected, masked views zeroed;
    res_msq = sum(res^2) / (2 V) with V the static view count
    (triang.c:31 divides by 2*noviews regardless)."""
    res = pt2d - project_P(P, X)
    if mask is not None:
        res = res * mask[..., None]
    V = res.shape[-2]
    res_msq = torch.sum(res * res, dim=(-2, -1)) / (2.0 * V)
    return res, res_msq


def sym3x3_inverse(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a symmetric 3x3 by cofactors
    (reference: triang.c:135-148).  Batched."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    i00 = f * d - e * e
    i01 = c * e - f * b
    i02 = b * e - c * d
    i11 = f * a - c * c
    i12 = b * c - a * e
    i22 = a * d - b * b
    det = a * i00 + b * i01 + c * i02
    inv = torch.stack([
        torch.stack([i00, i01, i02], dim=-1),
        torch.stack([i01, i11, i12], dim=-1),
        torch.stack([i02, i12, i22], dim=-1),
    ], dim=-2)
    return inv / det[..., None, None]


def _proj_jacobian(P, X):
    """d(projection)/dX: (..., V, 2, 3), the (P0j D - P2j N)/D^2
    quotient-rule form (reference: triang.c:38-72)."""
    Xh = _hom(X)
    n0 = torch.einsum("...vj,...j->...v", P[..., 0, :], Xh)
    n1 = torch.einsum("...vj,...j->...v", P[..., 1, :], Xh)
    d = torch.einsum("...vj,...j->...v", P[..., 2, :], Xh)
    dsq = d * d
    j0 = (P[..., 0, :3] * d[..., None] - P[..., 2, :3] * n0[..., None]) / dsq[..., None]
    j1 = (P[..., 1, :3] * d[..., None] - P[..., 2, :3] * n1[..., None]) / dsq[..., None]
    return torch.stack([j0, j1], dim=-2)


def _normal_system(P, pt2d, X, mask):
    """Masked residuals flattened over views, the flattened Jacobian and
    J^T J at X."""
    res, res_msq = residuals(P, pt2d, X, mask)
    J = _proj_jacobian(P, X)
    if mask is not None:
        J = J * mask[..., None, None]
    Jf = J.reshape(J.shape[:-3] + (-1, 3))
    rf = res.reshape(res.shape[:-2] + (-1,))
    JtJ = torch.einsum("...ki,...kj->...ij", Jf, Jf)
    return rf, res_msq, Jf, JtJ


def _eye3_like(X: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=X.dtype, device=X.device).expand(X.shape + (3,))


def triangulate_dlt(P, pt2d, R0=None, c0=None, mask=None):
    """Linear triangulation via the inhomogeneous DLT normal equations.

    P: (..., V, 3, 4); pt2d: (..., V, 2).  Returns (X, cov) with
    cov = (A^T A)^{-1}.  Given (R0, c0), the rotation and world center
    of the first view, points with ``(R0 (X - c0))_z < 0`` become NaN
    (reference: func_util_geom.py:575-579).
    """
    # A rows per view: [x P2 - P0 ; y P2 - P1]  (reference: triang.c:279-287)
    a_x = pt2d[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    a_y = pt2d[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    A = torch.stack([a_x, a_y], dim=-2)  # (..., V, 2, 4)
    if mask is not None:
        A = A * mask[..., None, None]
    A = A.reshape(A.shape[:-3] + (-1, 4))
    AtA = torch.einsum("...ki,...kj->...ij", A[..., :3], A[..., :3])
    rhs = -torch.einsum("...ki,...k->...i", A[..., :3], A[..., 3])
    cov = sym3x3_inverse(AtA)
    X = torch.einsum("...ij,...j->...i", cov, rhs)
    if R0 is not None and c0 is not None:
        z = torch.sum(R0[..., 2, :] * (X - c0), dim=-1)
        bad = z < 0
        X = torch.where(bad[..., None], torch.full_like(X, float("nan")), X)
        cov = torch.where(bad[..., None, None], torch.full_like(cov, float("nan")), cov)
    return X, cov


def triangulate_gn(P, pt2d, X0, num_iters: int = 10, minres: float = 0.0,
                   mask=None):
    """Gauss-Newton refinement of the full 3-D position
    (reference: triang.c:193-238): ``num_iters`` masked steps; a point
    freezes once its res_msq <= minres.  Returns (X, cov = (J^T J)^{-1}
    at the last active step)."""
    X = X0
    cov = _eye3_like(X0)
    active = torch.ones(X0.shape[:-1], dtype=torch.bool, device=X0.device)
    for _ in range(num_iters):
        rf, res_msq, Jf, JtJ = _normal_system(P, pt2d, X, mask)
        cov_i = sym3x3_inverse(JtJ)
        g = torch.einsum("...ki,...k->...i", Jf, rf)
        delta = torch.einsum("...ij,...j->...i", cov_i, g)
        active = active & (res_msq > minres)
        X = torch.where(active[..., None], X + delta, X)
        cov = torch.where(active[..., None, None], cov_i, cov)
    return X, cov


def triangulate_lm(P, pt2d, X0, num_iters: int = 10, damp_init: float = 2.0,
                   damp_fct: float = 10.0, minres: float = 1e-5,
                   maxdamp: float = 1e10, mask=None):
    """Levenberg-Marquardt refinement with the reference's accept/reject
    flow (reference: triang.c:327-373): per iteration take a damped
    step; if the residual dropped by more than ``minres`` accept it and
    divide damp by ``damp_fct``, else multiply damp by ``damp_fct`` and
    take (and keep) a fresh step from the pre-step point.  A point
    freezes when res_msq <= minres or damp >= maxdamp.
    """
    eye = torch.eye(3, dtype=X0.dtype, device=X0.device)

    def lm_step(X, rf, JtJ, Jf, damp):
        # damp the diagonal: A = JtJ + damp * diag(JtJ)  (triang.c:242-245)
        diag = eye * torch.diagonal(JtJ, dim1=-2, dim2=-1)[..., None, :]
        Ainv = sym3x3_inverse(JtJ + damp[..., None, None] * diag)
        g = torch.einsum("...ki,...k->...i", Jf, rf)
        X_new = X + torch.einsum("...ij,...j->...i", Ainv, g)
        _, msq = residuals(P, pt2d, X_new, mask)
        return X_new, msq, Ainv

    X = X0
    _, res_old = residuals(P, pt2d, X0, mask)
    cov = _eye3_like(X0)
    damp = torch.full(X0.shape[:-1], damp_init, dtype=X0.dtype, device=X0.device)
    active = res_old > minres
    for _ in range(num_iters):
        rf, _, Jf, JtJ = _normal_system(P, pt2d, X, mask)
        X_try, msq_try, cov_try = lm_step(X, rf, JtJ, Jf, damp)
        improved = msq_try < (res_old - minres)
        damp_up = damp * damp_fct
        X_retry, msq_retry, cov_retry = lm_step(X, rf, JtJ, Jf, damp_up)

        X_new = torch.where(improved[..., None], X_try, X_retry)
        msq_new = torch.where(improved, msq_try, msq_retry)
        cov_new = torch.where(improved[..., None, None], cov_try, cov_retry)
        damp_new = torch.where(improved, damp / damp_fct, damp_up)

        X = torch.where(active[..., None], X_new, X)
        cov = torch.where(active[..., None, None], cov_new, cov)
        damp = torch.where(active, damp_new, damp)
        res_old = torch.where(active, msq_new, res_old)
        active = active & (res_old > minres) & (damp < maxdamp)
    return X, cov


def triangulate_depth_only(P, pt2d, campos, ptdir, X0, num_iters: int = 10,
                           minres: float = 0.0, mask=None):
    """Gauss-Newton on the depth along the first view's ray
    (reference: triang.c:378-435).

    campos: (..., 3) first-view world center; ptdir: (..., 3) unit ray.
    The depth starts at ||X0 - campos||.  Returns (X, depth_var) with
    depth_var = 1 / (J^T J), the reference's scalar covariance.
    """
    depth = torch.linalg.norm(X0 - campos, dim=-1)

    # depth-independent pieces (reference: triang.c:80-110)
    ch = _hom(campos)
    d1 = torch.einsum("...vj,...j->...v", P[..., 2, :], ch)
    d2 = torch.einsum("...vj,...j->...v", P[..., 2, :3], ptdir)
    aa = torch.einsum("...vij,...j->...vi", P[..., :2, :3], ptdir)
    bb = torch.einsum("...vij,...j->...vi", P[..., :2, :], ch)
    nom = aa * d1[..., None] - bb * d2[..., None]  # (..., V, 2)

    var = torch.zeros_like(depth)
    active = torch.ones(depth.shape, dtype=torch.bool, device=depth.device)
    for _ in range(num_iters):
        X = campos + ptdir * depth[..., None]
        res, res_msq = residuals(P, pt2d, X, mask)
        denom = (d2 * depth[..., None] + d1) ** 2
        jac = nom / denom[..., None]
        if mask is not None:
            jac = jac * mask[..., None]
        jtj = torch.sum(jac * jac, dim=(-2, -1))
        var_i = 1.0 / jtj
        delta = var_i * torch.sum(jac * res, dim=(-2, -1))
        active = active & (res_msq > minres)
        depth = torch.where(active, depth + delta, depth)
        var = torch.where(active, var_i, var)
    return campos + ptdir * depth[..., None], var
