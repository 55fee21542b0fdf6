"""SE(3) exp/log as batched torch programs (port of
``invcompcamtrack_tpu/core/lie.py``).

Same conventions as the JAX module: ``p = [t_x, t_y, t_z, w_x, w_y,
w_z]``, group element ``[R | t]`` (3x4, ``x_cam = R X + t``), Taylor
fallback below ``SIG_THRESH`` and a hard zero rotation below
``EPSILON``.  Both branches of every switch are evaluated with safe
denominators and selected with ``torch.where``, so the functions are
NaN-free under ``torch.func.jacfwd`` / ``vmap``.
"""

from __future__ import annotations

import torch

SIG_THRESH = 1e-4   # small-angle switch (reference: utilities.h:22)
EPSILON = 1e-10     # zero-rotation guard (reference: utilities.h:23)


def skew(w: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix; w: (..., 3) -> (..., 3, 3)."""
    zero = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zero, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def _exp_coeffs(sig_sq: torch.Tensor):
    """(sin s/s, (1-cos s)/s^2, (s-sin s)/s^3) with the nested-Horner
    Taylor fallback, switched on sig^2 as in the JAX module."""
    small = sig_sq <= SIG_THRESH * SIG_THRESH
    sig_safe = torch.sqrt(torch.where(small, torch.ones_like(sig_sq), sig_sq))
    sa_exact = torch.sin(sig_safe) / sig_safe
    sb_exact = (1.0 - torch.cos(sig_safe)) / (sig_safe * sig_safe)
    sc_exact = (sig_safe - torch.sin(sig_safe)) / (sig_safe * (sig_safe * sig_safe))
    sa_tay = 1.0 - sig_sq / 6.0 * (1.0 - sig_sq / 20.0 * (1.0 - sig_sq / 42.0))
    sb_tay = 0.5 * (1.0 - sig_sq / 12.0 * (1.0 - sig_sq / 30.0 * (1.0 - sig_sq / 56.0)))
    sc_tay = (1.0 - sig_sq / 20.0 * (1.0 - sig_sq / 42.0 * (1.0 - sig_sq / 72.0))) / 6.0
    return (torch.where(small, sa_tay, sa_exact),
            torch.where(small, sb_tay, sb_exact),
            torch.where(small, sc_tay, sc_exact))


# The 3x3 products below are broadcast products and sums, not
# ``torch.matmul``: under ``torch.func.jacfwd`` (the tracker's Hessian
# map-back) a float32 0-d value times a Python float can carry a float64
# tangent, and matmul refuses the mixed operands.
def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return torch.sum(A * x[..., None, :], dim=-1)


def matmat(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) -> (..., 3, 3)."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _eye_like(m: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=m.dtype, device=m.device).expand(m.shape)


def se3_exp(p: torch.Tensor) -> torch.Tensor:
    """p: (..., 6) as [t, w] -> G: (..., 3, 4) = [R | V t]."""
    t, w = p[..., 0:3], p[..., 3:6]
    sig_sq = torch.sum(w * w, dim=-1)
    sa, sb, sc = _exp_coeffs(sig_sq)
    wx = skew(w)
    wx2 = matmat(wx, wx)
    eye = _eye_like(wx)
    R = eye + sa[..., None, None] * wx + sb[..., None, None] * wx2
    V = eye + sb[..., None, None] * wx + sc[..., None, None] * wx2
    return torch.cat([R, matvec(V, t)[..., None]], dim=-1)


def se3_log(G: torch.Tensor) -> torch.Tensor:
    """G: (..., 3, 4) = [R | t] -> p: (..., 6) = [V^{-1} t, w]."""
    R = G[..., :3]
    t = G[..., 3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_th = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    theta = torch.arccos(cos_th)

    tiny = theta < EPSILON
    theta_safe = torch.where(tiny, torch.ones_like(theta), theta)
    coef = theta_safe / (2.0 * torch.sin(theta_safe))
    coef = torch.where(tiny, torch.zeros_like(coef), coef)

    wx = coef[..., None, None] * (R - R.transpose(-1, -2))
    w = torch.stack([-wx[..., 1, 2], wx[..., 0, 2], -wx[..., 0, 1]], dim=-1)
    wx2 = matmat(wx, wx)

    small = theta < SIG_THRESH
    th_safe = torch.where(small, torch.ones_like(theta), theta)
    h_exact = (1.0 - th_safe / (2.0 * torch.tan(th_safe / 2.0))) / (th_safe * th_safe)
    h = torch.where(small, torch.full_like(theta, 1.0 / 12.0), h_exact)

    V_inv = _eye_like(wx) - 0.5 * wx + h[..., None, None] * wx2
    return torch.cat([matvec(V_inv, t), w], dim=-1)


def camera_center(G: torch.Tensor) -> torch.Tensor:
    """World-space camera center c = -R^T t of [R|t]."""
    R = G[..., :3]
    t = G[..., 3]
    return -matvec(R.transpose(-1, -2), t)


def se3_inverse(G: torch.Tensor) -> torch.Tensor:
    """[R|t] -> [R^T | -R^T t]."""
    Rt = G[..., :3].transpose(-1, -2)
    return torch.cat([Rt, -matvec(Rt, G[..., 3])[..., None]], dim=-1)


def se3_compose(Ga: torch.Tensor, Gb: torch.Tensor) -> torch.Tensor:
    """Group composition Ga . Gb: x -> Ra (Rb x + tb) + ta."""
    Ra, ta = Ga[..., :3], Ga[..., 3]
    R = matmat(Ra, Gb[..., :3])
    t = matvec(Ra, Gb[..., 3]) + ta
    return torch.cat([R, t[..., None]], dim=-1)


def se3_matrix(G: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> homogeneous (..., 4, 4)."""
    bottom = torch.zeros(G.shape[:-2] + (1, 4), dtype=G.dtype, device=G.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([G, bottom], dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3) rotation."""
    return se3_exp(torch.cat([torch.zeros_like(w), w], dim=-1))[..., :3]


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation -> axis-angle vector (..., 3)."""
    G = torch.cat([R, torch.zeros_like(R[..., :1])], dim=-1)
    return se3_log(G)[..., 3:6]
