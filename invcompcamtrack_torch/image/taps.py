"""Index, slice and tap helpers of sub-pixel patch sampling.

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
points with ``pose.in_frustum``).

The plain versions and the kernel wrappers of ``ops/patch_gather.py`` and
the window cache of ``ops/window_sample.py`` take their indices and
weights from here; this module imports nothing of the package.  The K5
and K6 kernels repeat ``bilinear_base`` and ``clamp_to_fit`` operation for
operation (``csrc/patch_gather.cuh``: ``support_start``,
``bilinear_weights``): a change here is a change there.
"""

from __future__ import annotations

import torch

_FAR = float(2 ** 30)


def bilinear_base(centers: torch.Tensor, psz: int, padding: int):
    """centers (..., 2) -> support origin rows, cols (...,) int32 into
    the padded plane (not clamped) and the 4 weights (..., 4)."""
    x = centers[..., 0]
    y = centers[..., 1]
    # a float beyond int32 converts differently on the CPU and on the
    # card: clamp first (such a center is far outside any image)
    u0 = torch.clamp(torch.ceil(x + 1e-5), -_FAR, _FAR).to(torch.int32)
    v0 = torch.clamp(torch.ceil(y + 1e-5), -_FAR, _FAR).to(torch.int32)
    rx = x - torch.floor(x)
    ry = y - torch.floor(y)
    w = torch.stack([rx * ry, (1.0 - rx) * ry, rx * (1.0 - ry),
                     (1.0 - rx) * (1.0 - ry)], dim=-1)
    return v0 - psz // 2 - 1 + padding, u0 - psz // 2 - 1 + padding, w


def clamp_to_fit(start: torch.Tensor, size: int, extent: int) -> torch.Tensor:
    """Move a window start so that ``size`` samples fit in ``extent``
    (the start rule of ``jax.lax.dynamic_slice``)."""
    return torch.clamp(start, 0, extent - size)


def slice_windows(planes: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor,
                  size) -> torch.Tensor:
    """planes (..., P, Hp, Wp), a stack of P planes; starts (P, m), row p
    into plane p -> (..., P, m, h, w) with ``size`` = h = w or (h, w),
    each start clamped to fit."""
    P, Hp, Wp = planes.shape[-3:]
    h, w = (size, size) if isinstance(size, int) else size
    dev = planes.device
    rows = clamp_to_fit(row0, h, Hp).long()[..., None] + torch.arange(h, device=dev)
    cols = clamp_to_fit(col0, w, Wp).long()[..., None] + torch.arange(w, device=dev)
    plane = torch.arange(P, device=dev)[:, None, None, None]
    return planes[..., plane, rows[..., :, None], cols[..., None, :]]


def combine(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """window (..., M, psz+1, psz+1), w (M, 4) or any (..., M, 4) that
    broadcasts against it -> (..., M, psz, psz)."""
    w = w[..., None, None]
    return (w[..., 0, :, :] * window[..., 1:, 1:] + w[..., 1, :, :] * window[..., 1:, :-1]
            + w[..., 2, :, :] * window[..., :-1, 1:] + w[..., 3, :, :] * window[..., :-1, :-1])


def patch_mean_removed(p: torch.Tensor) -> torch.Tensor:
    return p - torch.mean(p, dim=(-2, -1), keepdim=True)
