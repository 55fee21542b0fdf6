"""Trajectory evaluation: ATE / RPE with Umeyama alignment (port of
``invcompcamtrack_tpu/vo/metrics.py``): ATE-RMSE and RPE (Sturm et al.,
the KITTI/EuRoC convention) with closed-form Umeyama similarity
alignment."""

from __future__ import annotations

import torch


def umeyama_align(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = True):
    """Least-squares similarity transform mapping src -> dst.

    src/dst: (N, 3).  Returns (s, R, t) with dst ~ s R src + t.
    """
    mu_s = src.mean(dim=0)
    mu_d = dst.mean(dim=0)
    cs = src - mu_s
    cd = dst - mu_d
    cov = cd.T @ cs / src.shape[0]
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    sgn = torch.where(det < 0, -1.0, 1.0).to(src.dtype)
    S = torch.diag(torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn]))
    R = U @ (S @ Vt)
    var_s = torch.mean(torch.sum(cs * cs, dim=1))
    if with_scale:
        s = torch.sum(D * torch.diagonal(S)) / torch.clamp(var_s, min=1e-20)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def ate_rmse(centers_est: torch.Tensor, centers_gt: torch.Tensor,
             align: bool = True, with_scale: bool = True):
    """Absolute trajectory error (RMSE over camera centers).  Monocular
    VO has a free global scale, so ``with_scale=True`` is the meaningful
    default for KITTI-style monocular evaluation."""
    if align:
        s, R, t = umeyama_align(centers_est, centers_gt, with_scale)
        est = s * (centers_est @ R.T) + t
    else:
        est = centers_est
    err = est - centers_gt
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=1)))


def rpe_trans(centers_est: torch.Tensor, centers_gt: torch.Tensor, delta: int = 1):
    """Relative pose (translation) error over frame gaps of ``delta``."""
    de = centers_est[delta:] - centers_est[:-delta]
    dg = centers_gt[delta:] - centers_gt[:-delta]
    err = torch.linalg.norm(de - dg, dim=1)
    return torch.sqrt(torch.mean(err * err))


def rpe_rot(R_est: torch.Tensor, R_gt: torch.Tensor, delta: int = 1):
    """Relative rotation error (RMS geodesic angle, radians) over frame
    gaps of ``delta``.  R_est/R_gt: (N, 3, 3) world->cam rotations."""
    dRe = torch.einsum("nij,nkj->nik", R_est[delta:], R_est[:-delta])
    dRg = torch.einsum("nij,nkj->nik", R_gt[delta:], R_gt[:-delta])
    E = torch.einsum("nij,nkj->nik", dRe, dRg)
    tr = E[:, 0, 0] + E[:, 1, 1] + E[:, 2, 2]
    ang = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    return torch.sqrt(torch.mean(ang * ang))
