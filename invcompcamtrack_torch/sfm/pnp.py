"""Batched linear PnP pose-from-correspondences (port of
``invcompcamtrack_tpu/sfm/pnp.py``).

Given normalised image points x_n = K^{-1} x, ``pnp_dlt`` solves for the
3x4 matrix [R|t] with ``x_n ~ [R|t] X`` as the eigenvector of the 12x12
DLT normal matrix with the smallest eigenvalue, then projects onto SE(3)
(scale from ``det``, chirality from the mean sample depth, SVD onto
SO(3) with ``det R = +1``).  ``pnp_planar`` takes the homography route
for coplanar samples, and ``pnp_auto`` picks per sample by
``planarity``.

The operations are the JAX module's, in its order: ``torch.linalg.eigh``
(ascending, as ``jnp.linalg.eigh``), ``svd`` and ``det`` where it calls
them (library calls on the card, as XLA's are there; no Pallas kernel
computes them), and ``einsum`` where it contracts at
``Precision.HIGHEST`` (the package keeps TF32 off).  An eigenvector's sign
cancels: in ``G / scale`` (``det`` is odd in G), and through q, H and E in
the planar route; ``U Vᵀ`` is invariant to paired sign flips.  For planar
samples ``pnp_dlt``'s null space is degenerate and its output is
arbitrary; ``pnp_auto`` drops it with a ``torch.where``, which carries no
value of the branch it drops.
"""

from __future__ import annotations

import itertools

import torch


def _fix_last_column(U: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """U with its last column times ``sign`` (..., ): det(U Vᵀ) -> +1."""
    return torch.cat([U[..., :2], U[..., 2:] * sign[..., None, None]], dim=-1)


def _so3_projection(M: torch.Tensor) -> torch.Tensor:
    """The rotation nearest to M (..., 3, 3): U Vᵀ, last column of U
    flipped where det(U Vᵀ) = -1."""
    U, _, Vt = torch.linalg.svd(M)
    R = torch.matmul(U, Vt)
    return torch.matmul(_fix_last_column(U, torch.sign(torch.linalg.det(R))), Vt)


def pnp_dlt(Xw: torch.Tensor, xn: torch.Tensor, weights=None):
    """Xw: (..., n, 3) world points; xn: (..., n, 2) normalised image
    coords (K already removed).  n >= 6.  Returns G: (..., 3, 4) = [R|t]
    with x_cam = R X + t, and a degeneracy flag (...,) (True = bad).
    """
    Xh = torch.cat([Xw, torch.ones_like(Xw[..., :1])], dim=-1)  # (..., n, 4)
    zero = torch.zeros_like(Xh)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    # rows: [X 0 -u*X ; 0 X -v*X] for P = rows of [R|t]
    r1 = torch.cat([Xh, zero, -u * Xh], dim=-1)  # (..., n, 12)
    r2 = torch.cat([zero, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2n, 12)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    # smallest eigenvector of a 12x12 symmetric matrix
    _, evecs = torch.linalg.eigh(AtA)
    p = evecs[..., :, 0]
    G = p.reshape(p.shape[:-1] + (3, 4))

    # scale + chirality: mean depth of the sample must be positive
    det = torch.linalg.det(G[..., :3])
    scale = torch.sign(det) * torch.abs(det) ** (1.0 / 3.0)
    degenerate = torch.abs(scale) < 1e-12
    scale = torch.where(degenerate, torch.ones_like(scale), scale)
    G = G / scale[..., None, None]
    depth = torch.einsum("...j,...nj->...n", G[..., 2, :3], Xw) + G[..., 2, 3][..., None]
    flip = torch.mean(depth, dim=-1) < 0
    G = torch.where(flip[..., None, None], -G, G)

    R = _so3_projection(G[..., :3])
    return torch.cat([R, G[..., 3:4]], dim=-1), degenerate


def _weighted_cov(Xw: torch.Tensor, weights):
    """(mean (..., 1, 3), centred points, 3x3 scatter) of the sample."""
    if weights is None:
        mean = torch.mean(Xw, dim=-2, keepdim=True)
        C = Xw - mean
        return mean, C, torch.einsum("...ni,...nj->...ij", C, C)
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1e-12)
    mean = torch.sum(Xw * w, dim=-2, keepdim=True) / wsum
    C = Xw - mean
    return mean, C, torch.einsum("...ni,...nj->...ij", C * w, C)


def pnp_planar(Xw: torch.Tensor, xn: torch.Tensor, weights=None):
    """Homography-based PnP for (near-)coplanar samples.

    Plane frame from the sample scatter (3x3 eigh), then
    x_n ~ H [q1, q2, 1] with H = [R e1 | R e2 | R Xbar + t]; H from the
    9x9 DLT normal matrix; [h1 h2 h1xh2] orthonormalised by SVD, with
    scale = mean norm of h1, h2 and the sign fixed by the mean sample
    depth.
    """
    mean, C, cov = _weighted_cov(Xw, weights)
    _, evecs = torch.linalg.eigh(cov)  # ascending; normal = evecs[..., 0]
    e1 = evecs[..., :, 2]
    e2 = evecs[..., :, 1]
    q1 = torch.einsum("...ni,...i->...n", C, e1)
    q2 = torch.einsum("...ni,...i->...n", C, e2)
    qh = torch.stack([q1, q2, torch.ones_like(q1)], dim=-1)  # (..., n, 3)

    u = xn[..., 0:1]
    v = xn[..., 1:2]
    zero = torch.zeros_like(qh)
    r1 = torch.cat([qh, zero, -u * qh], dim=-1)  # (..., n, 9)
    r2 = torch.cat([zero, qh, -v * qh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, hv = torch.linalg.eigh(AtA)
    H = hv[..., :, 0].reshape(hv.shape[:-2] + (3, 3))

    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    scale = 0.5 * (torch.linalg.norm(h1, dim=-1) + torch.linalg.norm(h2, dim=-1))
    degenerate = scale < 1e-12
    scale = torch.where(degenerate, torch.ones_like(scale), scale)
    h1, h2, h3 = h1 / scale[..., None], h2 / scale[..., None], h3 / scale[..., None]
    # chirality: mean depth of the (weighted) samples must be positive
    depth = (h3[..., 2][..., None] + torch.einsum("...n,...->...n", q1, h1[..., 2])
             + torch.einsum("...n,...->...n", q2, h2[..., 2]))
    if weights is not None:
        flip = torch.sum(depth * weights, dim=-1) < 0
    else:
        flip = torch.mean(depth, dim=-1) < 0
    sgn = torch.where(flip, -1.0, 1.0).to(h1.dtype)[..., None]
    h1, h2, h3 = h1 * sgn, h2 * sgn, h3 * sgn

    # orthonormalise [h1 h2 h1xh2] -> Rp (columns R e1, R e2, R n)
    Rp = _so3_projection(torch.stack([h1, h2, torch.linalg.cross(h1, h2)], dim=-1))

    # R = Rp [e1 e2 n]^T;  t = h3 - R mean
    E = torch.stack([e1, e2, torch.linalg.cross(e1, e2)], dim=-1)
    R = torch.matmul(Rp, E.transpose(-1, -2))
    t = h3 - torch.einsum("...ij,...j->...i", R, mean[..., 0, :])
    return torch.cat([R, t[..., None]], dim=-1), degenerate


def planarity(Xw: torch.Tensor, weights=None) -> torch.Tensor:
    """Ratio of the smallest to the middle eigenvalue of the sample
    scatter: ~0 for coplanar samples."""
    evals = torch.linalg.eigvalsh(_weighted_cov(Xw, weights)[2])
    return evals[..., 0] / torch.clamp(evals[..., 1], min=1e-20)


def pnp_auto(Xw: torch.Tensor, xn: torch.Tensor, weights=None,
             planar_thresh: float = 1e-3):
    """Both solvers; per sample the one that its planarity picks."""
    G_g, bad_g = pnp_dlt(Xw, xn, weights=weights)
    G_p, bad_p = pnp_planar(Xw, xn, weights=weights)
    is_planar = planarity(Xw, weights=weights) < planar_thresh
    G = torch.where(is_planar[..., None, None], G_p, G_g)
    bad = torch.where(is_planar, bad_p, bad_g)
    return G, bad


def _triples(n: int, device) -> torch.Tensor:
    """All C(n, 3) index triples (i < j < k), in itertools' order."""
    return torch.tensor(list(itertools.combinations(range(n), 3)),
                        dtype=torch.long, device=device).reshape(-1, 3)


def collinearity_degenerate(pts2d: torch.Tensor, pts3d: torch.Tensor,
                            eps: float = 2.22e-16) -> torch.Tensor:
    """True if ANY 3-subset of the sample is collinear in 2D (homog.) or
    3D, the reference's ``degenfn_P``
    (reference: func_ransac_fitcameras_odom.m:175-194).

    pts2d: (..., n, 2); pts3d: (..., n, 3).  All C(n, 3) triples are
    gathered with one index tensor (the JAX module loops over them) and
    get the same cross and dot products, each triple's alone.
    """
    tri = _triples(pts2d.shape[-2], pts2d.device)
    p2h = torch.cat([pts2d, torch.ones_like(pts2d[..., :1])], dim=-1)

    def triple_product(p):
        a, b, c = (p[..., tri[:, m], :] for m in range(3))  # (..., T, 3)
        return torch.abs(torch.sum(torch.linalg.cross(a, b) * c, dim=-1)) < eps

    return torch.any(triple_product(pts3d) | triple_product(p2h), dim=-1)
