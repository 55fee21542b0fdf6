"""Horizon-based camera-orientation estimation (port of
``invcompcamtrack_tpu/vo/horizon.py``).

The reference's horizon-alignment experiment (reference:
misc_src/run_orientation_extraction_test.ipynb cells 1-8): a world great
circle (the horizon, orthogonal to the up vector) is projected through a
candidate rotation; pixel strips sampled orthogonally across the projected
line show the largest above-vs-below contrast at the right rotation.  The
loss is differentiable; ``estimate_orientation`` takes clipped gradient
steps on the so(3) tangent, its gradients from ``torch.autograd.grad``
where the JAX module takes ``jax.value_and_grad``.  The bilinear taps are
the module's own (``_bilinear``), as in the JAX module: no kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from invcompcamtrack_torch.core import lie


def _circle_points(n: int, dtype, device) -> torch.Tensor:
    """Unit great circle in the horizon plane (up = +y; reference cell 1)."""
    t = torch.arange(n, dtype=dtype, device=device) * (2.0 * math.pi / n)
    return torch.stack([torch.sin(t), torch.zeros_like(t), torch.cos(t)], dim=1)


def _bilinear(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    x = torch.clamp(pts[:, 0], 0.0, W - 2.0)
    y = torch.clamp(pts[:, 1], 0.0, H - 2.0)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)

    def tap(yy, xx):
        return flat[(yy * W + xx).long()]

    return ((1 - fx) * (1 - fy) * tap(y0, x0) + fx * (1 - fy) * tap(y0, x0 + 1)
            + (1 - fx) * fy * tap(y0 + 1, x0) + fx * fy * tap(y0 + 1, x0 + 1))


def horizon_loss(w: torch.Tensor, img: torch.Tensor, fc, cc,
                 n_circle: int = 64, n_strip: int = 8,
                 strip_scale: float | None = None) -> torch.Tensor:
    """Negative above/below contrast across the projected horizon.

    w: (3,) so(3) tangent (rotation = exp(w)); img: (H, W) grayscale.
    Lower is better.  Invisible / behind-camera points are masked.
    """
    H, W = img.shape
    fc = torch.as_tensor(fc, dtype=img.dtype, device=img.device)
    cc = torch.as_tensor(cc, dtype=img.dtype, device=img.device)
    if strip_scale is None:
        strip_scale = float(np.sqrt(H * W) / 10.0)

    R = lie.so3_exp(w)
    C = _circle_points(n_circle, img.dtype, img.device)
    Xc = torch.einsum("ij,nj->ni", R, C)
    # in front of the camera (the reference keeps sum(circlept * R[2]) > 0)
    front = Xc[:, 2] > 1e-3
    z = torch.where(front, Xc[:, 2], torch.ones_like(Xc[:, 2]))
    uv = Xc[:, :2] / z[:, None] * fc + cc
    visible = front & (uv[:, 0] > 0) & (uv[:, 0] < W) & (uv[:, 1] > 0) & (uv[:, 1] < H)

    # local tangent of the projected circle -> orthogonal strip direction
    tang = torch.roll(uv, -1, dims=0) - torch.roll(uv, 1, dims=0)
    tang = tang / torch.clamp(torch.linalg.norm(tang, dim=1, keepdim=True), min=1e-9)
    ortho = torch.stack([tang[:, 1], -tang[:, 0]], dim=1)

    dist = torch.linspace(1.0, strip_scale, n_strip, dtype=img.dtype, device=img.device)
    up = uv[:, None, :] + ortho[:, None, :] * dist[None, :, None]
    dn = uv[:, None, :] - ortho[:, None, :] * dist[None, :, None]
    v_up = _bilinear(img, up.reshape(-1, 2)).reshape(n_circle, n_strip)
    v_dn = _bilinear(img, dn.reshape(-1, 2)).reshape(n_circle, n_strip)

    contrast = torch.abs(torch.mean(v_up, dim=1) - torch.mean(v_dn, dim=1))
    m = visible.to(img.dtype)
    return -torch.sum(contrast * m) / torch.clamp(torch.sum(m), min=1.0)


def loss_and_grad(w: torch.Tensor, img: torch.Tensor, fc, cc):
    """(horizon_loss, its gradient in w), as ``jax.value_and_grad``."""
    w = w.detach().requires_grad_(True)
    with torch.enable_grad():
        val = horizon_loss(w, img, fc, cc)
        (g,) = torch.autograd.grad(val, w)
    return val.detach(), g


def estimate_orientation(img: torch.Tensor, fc, cc, w0=None,
                         num_iters: int = 100, lr: float = 2e-3):
    """Gradient-descent refinement of the camera orientation from the
    horizon, on ``img``'s device.  Returns (w (3,), loss): R = so3_exp(w)."""
    w = (torch.zeros(3, dtype=img.dtype, device=img.device) if w0 is None
         else torch.as_tensor(w0, dtype=img.dtype, device=img.device))
    for _ in range(num_iters):
        _, g = loss_and_grad(w, img, fc, cc)
        gn = torch.linalg.norm(g)
        g = torch.where(gn > 1.0, g / gn, g)  # clip
        w = w - lr * g
    return w, horizon_loss(w, img, fc, cc)
