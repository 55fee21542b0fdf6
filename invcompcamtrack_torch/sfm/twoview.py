"""Two-view relative-pose initialisation, the essential-matrix bootstrap
(port of ``invcompcamtrack_tpu/sfm/twoview.py``).

- E from the normalised 8-point solver on calibrated coordinates (for
  calibrated points F == E up to scale), RANSAC over a batch of
  hypotheses,
- the closed-form decomposition E -> {R1, R2} x {+-t}, with the
  cheirality count over triangulated depths choosing among the four,
- DLT + GN triangulation of the surviving matches as landmark seeds.

The JAX module draws its 256 eight-point samples with ``jax.random``,
whose stream cannot be reproduced here.  So the function is split in
two: :func:`sample_indices` (``sfm/epipolar.py``) draws the ``(256, 8)``
indices from a ``torch.Generator`` on the CPU, and
:func:`initialize_two_view` takes them and does the rest.

Monocular scale is free; ``t`` is unit-norm.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core.pose import projection_matrix
from invcompcamtrack_torch.sfm.epipolar import fundamental_8pt, sampson_distance
from invcompcamtrack_torch.sfm.triangulate import triangulate_dlt, triangulate_gn


class TwoViewInit(NamedTuple):
    pose1: torch.Tensor      # (6,) se(3) of frame 1 (frame 0 = identity)
    landmarks: torch.Tensor  # (N, 3) triangulated seeds (NaN where invalid)
    valid: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor


def decompose_essential(E: torch.Tensor) -> torch.Tensor:
    """E -> the 4 candidate [R|t] (world->cam of view 1, view 0 = identity)."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.linalg.det(U) * torch.linalg.det(Vt)
    Vt = Vt * torch.where(d < 0, -1.0, 1.0)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ (W @ Vt)
    R2 = U @ (W.T @ Vt)
    t = U[:, 2]
    return torch.stack([torch.cat([R, (s * t)[:, None]], dim=1)
                        for R in (R1, R2) for s in (1.0, -1.0)])  # (4, 3, 4)


def initialize_two_view(idx: torch.Tensor, xn0: torch.Tensor, xn1: torch.Tensor,
                        match_valid: torch.Tensor,
                        thresh: float = 2e-4) -> TwoViewInit:
    """Bootstrap from matched NORMALISED image points (K removed).

    idx: (n_samples, 8) sample indices (``sfm.epipolar.sample_indices``);
    xn0/xn1: (N, 2); match_valid: (N,).  thresh is a Sampson threshold in
    normalised coordinates (~ (px / f)^2 scale).
    """
    N = xn0.shape[0]
    idx = idx.to(xn0.device)
    n_samples = idx.shape[0]
    Es = fundamental_8pt(xn0[idx], xn1[idx])
    d = sampson_distance(Es, xn0.expand((n_samples,) + xn0.shape),
                         xn1.expand((n_samples,) + xn1.shape))
    inl = (d <= thresh) & match_valid
    cnt = torch.sum(inl, dim=-1)
    best = torch.argmax(cnt)
    inliers = inl[best]
    # least-squares refit of E on the winning inlier set
    E = fundamental_8pt(xn0, xn1, weights=inliers.to(xn0.dtype))

    # 4-way decomposition; pick by cheirality over triangulated depths
    cands = decompose_essential(E)
    dt, dev = E.dtype, E.device
    fc = torch.ones(2, dtype=dt, device=dev)
    cc = torch.zeros(2, dtype=dt, device=dev)
    P0 = projection_matrix(fc, cc, torch.eye(3, dtype=dt, device=dev),
                           torch.zeros(3, dtype=dt, device=dev))
    obs = torch.stack([xn0, xn1], dim=1)
    scores, Xs, goods = [], [], []
    for G in cands:
        P1 = projection_matrix(fc, cc, G[:, :3], lie.camera_center(G))
        P = torch.stack([P0, P1]).expand(N, 2, 3, 4)
        X, _ = triangulate_dlt(P, obs)
        X = torch.nan_to_num(X, nan=0.0, posinf=0.0, neginf=0.0)
        X, _ = triangulate_gn(P, obs, X, num_iters=3)
        z0 = X[:, 2]
        z1 = (X @ G[:, :3].T + G[:, 3])[:, 2]
        good = (z0 > 1e-6) & (z1 > 1e-6) & inliers & torch.all(torch.isfinite(X), dim=1)
        scores.append(torch.sum(good))
        Xs.append(X)
        goods.append(good)
    pick = torch.argmax(torch.stack(scores))
    G = cands[pick]
    X = torch.stack(Xs)[pick]
    good = torch.stack(goods)[pick]
    return TwoViewInit(
        pose1=lie.se3_log(G),
        landmarks=torch.where(good[:, None], X, torch.full_like(X, float("nan"))),
        valid=good,
        num_inliers=cnt[best],
    )
