"""Sparse pyramidal inverse-compositional Lucas-Kanade point tracking
(port of ``invcompcamtrack_tpu/match/lk.py``).

The 2-DoF (pure translation) sibling of the 6-DoF IC-GN pose solver in
``solver/icgn.py``, on the same patch machinery:

per level (coarse -> fine), per point:
  - extract reference patch + gradients once (K6); 2x2 Hessian of
    [dx, dy],
  - iterate: sample query patch at current position (from windows cached
    once per level by K7, or with ``window_cache=False`` from the image
    by K5), residual ``ref - query``, delta = H^{-1} J^T r,
    position += delta,
with frustum-invalid points frozen.  All points run as one batch per
level; ``lax.scan`` becomes a fixed loop of ``max_iters`` masked steps.
Pyramids whose levels are stacks of S planes track S point sets ``(S, N,
2)``, set s on pair s, in the same launches (what ``jax.vmap`` makes of
the JAX functions; the multi-stream VO engine).
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.image.patch import extract_patches, extract_patches_grad
from invcompcamtrack_torch.image.pyramid import Pyramid
from invcompcamtrack_torch.ops.window_sample import (
    gather_windows_any,
    sample_from_windows,
    window_origin,
)


def track_points_lk(pyr_a: Pyramid, pyr_b: Pyramid, xy: torch.Tensor,
                    psz: int = 8, padding: int | None = None,
                    num_levels: int | None = None, max_iters: int = 8,
                    eps: float = 0.03, min_det: float = 1e-6,
                    init_xy: torch.Tensor | None = None,
                    window_cache: bool = True):
    """Track points from image A to image B.

    pyr_a/pyr_b: pyramids, built as the pose solver's are.
    xy: (N, 2) positions in image A (level-0 unpadded coords); (S, N, 2)
    for pyramids of stacked planes.
    init_xy: optional initial guesses in image B (e.g. an expected
    disparity for stereo matching), which widens the convergence basin
    far beyond the pyramid's reach.
    Returns (xy_b (..., N, 2), valid (..., N)).
    """
    if padding is None:
        padding = psz
    if num_levels is None:
        num_levels = len(pyr_a)
    L = num_levels

    # guesses start at the coarsest level, in that level's coordinates
    start = xy if init_xy is None else init_xy
    guess = start / (2.0 ** (L - 1))
    valid = torch.all(torch.isfinite(xy), dim=-1)

    for s in range(L - 1, -1, -1):
        scale = 2.0 ** s
        xy_s = xy / scale
        lvl_a, lvl_b = pyr_a[s], pyr_b[s]
        H_img = lvl_a.img.shape[-2] - 2 * padding
        W_img = lvl_a.img.shape[-1] - 2 * padding

        ref, gx, gy = extract_patches_grad(lvl_a.img, lvl_a.dx, lvl_a.dy, xy_s,
                                           psz, padding)
        flat = ref.shape[:-2] + (-1,)
        gxf = gx.reshape(flat)
        gyf = gy.reshape(flat)
        h00 = torch.sum(gxf * gxf, dim=-1)
        h01 = torch.sum(gxf * gyf, dim=-1)
        h11 = torch.sum(gyf * gyf, dim=-1)
        det = h00 * h11 - h01 * h01
        good = valid & (det > min_det) & _inb(xy_s, W_img, H_img)
        det_safe = torch.where(good, det, torch.ones_like(det))
        zero = torch.zeros_like(det)
        inv00 = torch.where(good, h11 / det_safe, zero)
        inv01 = torch.where(good, -h01 / det_safe, zero)
        inv11 = torch.where(good, h00 / det_safe, zero)
        reff = ref.reshape(flat)

        if window_cache:
            # cache query windows at the level-entry guesses; iterations
            # resample them (same trick as the pose solver)
            win = psz + 8
            g0 = torch.where(torch.isfinite(guess), guess, torch.zeros_like(guess))
            origins = window_origin(g0, psz, win, padding)
            qwin = gather_windows_any(lvl_b.img, origins, win)

        pos = guess
        for _ in range(max_iters):
            if window_cache:
                q = sample_from_windows(qwin, origins, pos, psz, padding)
            else:
                q = extract_patches(lvl_b.img, pos, psz, padding)
            r = reff - q.reshape(flat)
            bx = torch.sum(gxf * r, dim=-1)
            by = torch.sum(gyf * r, dim=-1)
            dx = inv00 * bx + inv01 * by
            dy = inv01 * bx + inv11 * by
            act = good & (torch.abs(dx) + torch.abs(dy) > eps) & _inb(pos, W_img, H_img)
            step = torch.stack([dx, dy], dim=-1)
            pos = pos + torch.where(act[..., None], step, torch.zeros_like(step))
        guess = pos
        valid = valid & _inb(guess, W_img, H_img)
        if s > 0:
            guess = guess * 2.0

    return guess, valid


def _inb(p, W, H):
    return (p[..., 0] >= 0) & (p[..., 1] >= 0) & (p[..., 0] <= W) & (p[..., 1] <= H)


def lk_forward_backward(pyr_a: Pyramid, pyr_b: Pyramid, xy: torch.Tensor,
                        ratio_th: float = 0.2, abs_th: float = 1.0,
                        init_xy: torch.Tensor | None = None, **kw):
    """Forward/backward verified tracking, with the gate of the
    flow-transfer tracker (classoftrack.py:85-93).  Returns (xy_b, valid).

    ``init_xy`` seeds only the forward pass (an expected position in B,
    e.g. a reprojection); the backward pass is seeded at the original
    ``xy``, which is the correct prior for the return trip.
    """
    xy_b, ok_f = track_points_lk(pyr_a, pyr_b, xy, init_xy=init_xy, **kw)
    back_init = xy if init_xy is not None else None
    xy_back, ok_b = track_points_lk(pyr_b, pyr_a, xy_b, init_xy=back_init, **kw)
    err = torch.sqrt(torch.sum((xy - xy_back) ** 2, dim=-1))
    disp = torch.sqrt(torch.sum((xy - xy_b) ** 2, dim=-1))
    gate = (err / torch.clamp(disp, min=1e-12) < ratio_th) & (err < abs_th)
    return xy_b, ok_f & ok_b & gate
