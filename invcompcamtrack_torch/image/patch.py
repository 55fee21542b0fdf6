"""Batched sub-pixel patch extraction in plain torch (port of
``invcompcamtrack_tpu/image/patch.py``).

A ``psz x psz`` patch around sub-pixel center ``(x, y)`` (unpadded
coordinates) samples the padded plane with 4 weights that are constant
over the patch:

    u0 = ceil(x + 1e-5), rx = x - floor(x)     (same for v0, ry)
    w = [rx*ry, (1-rx)*ry, rx*(1-ry), (1-rx)*(1-ry)]
    patch[r, c] = w0*S[r+1, c+1] + w1*S[r+1, c] + w2*S[r, c+1] + w3*S[r, c]

where ``S`` is the ``(psz+1, psz+1)`` support whose top-left corner is
``(v0 - psz/2 - 1 + padding, u0 - psz/2 - 1 + padding)``.  A support
that would leave the plane is moved back inside it, as
``jax.lax.dynamic_slice`` does in the JAX package (callers mask such
points with ``pose.in_frustum``).  The patch mean, when asked for, is
taken on the intensity plane only.

These functions are the building blocks of K1's plain version
(``ops/patch_gather.py``); the Pallas kernels that carry them on the
TPU outside the tracker's fused path (K5, K6) are not yet ported.
"""

from __future__ import annotations

import torch


def bilinear_base(centers: torch.Tensor, psz: int, padding: int):
    """centers (..., 2) -> support origin rows, cols (...,) int32 into
    the padded plane (not clamped) and the 4 weights (..., 4)."""
    x = centers[..., 0]
    y = centers[..., 1]
    u0 = torch.ceil(x + 1e-5).to(torch.int32)
    v0 = torch.ceil(y + 1e-5).to(torch.int32)
    rx = x - torch.floor(x)
    ry = y - torch.floor(y)
    w = torch.stack([rx * ry, (1.0 - rx) * ry, rx * (1.0 - ry),
                     (1.0 - rx) * (1.0 - ry)], dim=-1)
    return v0 - psz // 2 - 1 + padding, u0 - psz // 2 - 1 + padding, w


def clamp_to_fit(start: torch.Tensor, size: int, extent: int) -> torch.Tensor:
    """Move a window start so that ``size`` samples fit in ``extent``
    (the start rule of ``jax.lax.dynamic_slice``)."""
    return torch.clamp(start, 0, extent - size)


def slice_windows(plane: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor,
                  size: int) -> torch.Tensor:
    """plane (..., Hp, Wp); starts (M,) -> (..., M, size, size), each
    start clamped to fit."""
    Hp, Wp = plane.shape[-2:]
    ar = torch.arange(size, device=plane.device)
    rows = clamp_to_fit(row0, size, Hp).long()[:, None] + ar
    cols = clamp_to_fit(col0, size, Wp).long()[:, None] + ar
    return plane[..., rows[:, :, None], cols[:, None, :]]


def combine(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """window (..., M, psz+1, psz+1), w (M, 4) -> (..., M, psz, psz)."""
    w = w[:, :, None, None]
    return (w[:, 0] * window[..., 1:, 1:] + w[:, 1] * window[..., 1:, :-1]
            + w[:, 2] * window[..., :-1, 1:] + w[:, 3] * window[..., :-1, :-1])


def _patch_mean_removed(p: torch.Tensor) -> torch.Tensor:
    return p - torch.mean(p, dim=(-2, -1), keepdim=True)


def extract_patches(img: torch.Tensor, centers: torch.Tensor, psz: int,
                    padding: int, patch_norm: bool = False) -> torch.Tensor:
    """img (Hp, Wp) padded; centers (..., 2) -> (..., psz, psz)."""
    lead = centers.shape[:-1]
    row0, col0, w = bilinear_base(centers.reshape(-1, 2), psz, padding)
    patches = combine(slice_windows(img, row0, col0, psz + 1), w)
    patches = patches.reshape(lead + (psz, psz))
    return _patch_mean_removed(patches) if patch_norm else patches


def extract_patches_grad(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                         centers: torch.Tensor, psz: int, padding: int,
                         patch_norm: bool = False):
    """One (I, dI/dx, dI/dy) gather sharing indices and weights ->
    three (..., psz, psz) tensors; the mean applies to I only."""
    lead = centers.shape[:-1]
    row0, col0, w = bilinear_base(centers.reshape(-1, 2), psz, padding)
    planes = torch.stack([img, dx, dy])
    patches = combine(slice_windows(planes, row0, col0, psz + 1), w)
    p_img, p_dx, p_dy = (patches[k].reshape(lead + (psz, psz)) for k in range(3))
    if patch_norm:
        p_img = _patch_mean_removed(p_img)
    return p_img, p_dx, p_dy
