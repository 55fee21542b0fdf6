"""Fundamental-matrix estimation and epipolar distances (port of
``invcompcamtrack_tpu/sfm/epipolar.py``).

The normalised 8-point solver runs as a batched hypothesis pool.  It
takes ``torch.linalg.eigh`` of the 9x9 ``A^T A`` and an SVD for the
rank-2 projection, as the JAX module does; no Pallas kernel computes
them there, so they stay library calls here (cuSOLVER on the card).  An
eigenvector's sign is arbitrary and F is divided by ``|F_22|``, so F is
defined up to sign.

``fit_fundamental_ransac`` draws its 8-point samples with
:func:`sample_indices` (a ``torch.Generator`` on the CPU, so that the
card and the CPU see the same samples) or takes them from the caller;
the JAX module's ``jax.random`` stream cannot be reproduced.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _normalize_pts(x: torch.Tensor, weights=None):
    """Hartley normalisation: zero mean, mean distance sqrt(2)."""
    if weights is None:
        mean = torch.mean(x, dim=-2, keepdim=True)
        d = torch.linalg.norm(x - mean, dim=-1)
        scale = 2.0 ** 0.5 / torch.clamp(torch.mean(d, dim=-1), min=1e-12)
    else:
        w = weights[..., None]
        wsum = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1e-12)
        mean = torch.sum(x * w, dim=-2, keepdim=True) / wsum
        d = torch.linalg.norm(x - mean, dim=-1) * weights
        scale = 2.0 ** 0.5 / torch.clamp(torch.sum(d, dim=-1) / wsum[..., 0, 0],
                                         min=1e-12)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0, 0]], dim=-1),
        torch.stack([zero, scale, -scale * mean[..., 0, 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    xn = (x - mean) * scale[..., None, None]
    return xn, T


def fundamental_8pt(xa: torch.Tensor, xb: torch.Tensor,
                    weights=None) -> torch.Tensor:
    """Normalised 8-point algorithm; xa, xb: (..., n>=8, 2) -> (..., 3, 3)
    with rank-2 enforcement.  Per-point weights (an inlier mask) give
    the least-squares refit."""
    xan, Ta = _normalize_pts(xa, weights)
    xbn, Tb = _normalize_pts(xb, weights)
    u, v = xan[..., 0], xan[..., 1]
    up, vp = xbn[..., 0], xbn[..., 1]
    # rows: [u'u, u'v, u', v'u, v'v, v', u, v, 1] for x'^T F x = 0
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v,
                     torch.ones_like(u)], dim=-1)
    if weights is not None:
        A = A * weights[..., None]
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, evecs = torch.linalg.eigh(AtA)
    F = evecs[..., :, 0].reshape(evecs.shape[:-2] + (3, 3))
    # rank-2 projection
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = torch.einsum("...ij,...j,...jk->...ik", U, S, Vt)
    # denormalise: F = Tb^T F Ta
    F = torch.einsum("...ji,...jk,...kl->...il", Tb, F, Ta)
    return F / torch.clamp(torch.abs(F[..., 2:3, 2:3]), min=1e-12)


def epiline_distance(F: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Normalised distance of xb to the epiline of xa (the line normalised
    like cv2.computeCorrespondEpilines; reference: func_util_geom.py:52-55)."""
    xah = torch.cat([xa, torch.ones_like(xa[..., :1])], dim=-1)
    l = torch.einsum("...ij,...nj->...ni", F, xah)
    norm = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    l = l / torch.clamp(norm, min=1e-12)[..., None]
    return torch.abs(l[..., 0] * xb[..., 0] + l[..., 1] * xb[..., 1] + l[..., 2])


def sampson_distance(F, xa, xb):
    xah = torch.cat([xa, torch.ones_like(xa[..., :1])], dim=-1)
    xbh = torch.cat([xb, torch.ones_like(xb[..., :1])], dim=-1)
    Fx = torch.einsum("...ij,...nj->...ni", F, xah)
    Ftx = torch.einsum("...ji,...nj->...ni", F, xbh)
    num = torch.sum(xbh * Fx, dim=-1) ** 2
    den = Fx[..., 0] ** 2 + Fx[..., 1] ** 2 + Ftx[..., 0] ** 2 + Ftx[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def sample_indices(n: int, n_samples: int, k: int = 8,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """(n_samples, k) int64 indices into n points, each row without
    repeats, drawn on the CPU from ``generator`` (seeded with 0 when
    None), so that every device sees the same samples."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    keys = torch.rand((n_samples, n), generator=generator)
    return torch.argsort(keys, dim=1)[:, :k]


class FRansacResult(NamedTuple):
    F: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    best: torch.Tensor


def fit_fundamental_ransac(idx: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                           thresh: float = 1.0) -> FRansacResult:
    """Batched F-RANSAC over the 8-point samples ``idx`` (n_samples, 8)
    (:func:`sample_indices`); inliers by epiline distance (the
    reference's static/dynamic splitter, run_test_OF_track.py:309-343).
    Returns the best model and its inlier mask."""
    idx = idx.to(xa.device)
    n_samples = idx.shape[0]
    Fs = fundamental_8pt(xa[idx], xb[idx])
    d = epiline_distance(Fs, xa.expand((n_samples,) + xa.shape),
                         xb.expand((n_samples,) + xb.shape))
    inl = d <= thresh
    cnt = torch.sum(inl, dim=-1)
    best = torch.argmax(cnt)
    return FRansacResult(F=Fs[best], inliers=inl[best], num_inliers=cnt[best], best=best)
