"""Dense pyramidal Lucas-Kanade optical flow (port of
``invcompcamtrack_tpu/match/dense_flow.py``).

Coarse-to-fine dense LK with window sums as box-filter convolutions:

per level (coarse -> fine):
  flow = 2x upsampled coarser flow
  iterate:
    I1w = warp(I1, flow)                      (K8, ``ops/warp.py``)
    It  = I1w - I0;  (Ix, Iy) = grad I0
    A = box([Ix^2, IxIy, Iy^2]); b = box([Ix It, Iy It])
    flow -= A^{-1} b   (closed-form 2x2, det-guarded)

Everything is dense tensor work in PyTorch except the warp, which is
one launch of the hand-written kernel K8 per iteration on a CUDA tensor
and its plain version, ``warp_image``, on a CPU tensor.  The box sums
are ``F.conv2d`` with a ones kernel and zero padding (TF32 off, set by
the package).  ``lax.fori_loop`` becomes a fixed Python loop.

Outputs interoperate with the flow-transfer track table
(``match/track.py``), the EPE evaluation and the colour-wheel viz.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from invcompcamtrack_torch.image.pyramid import Pyramid, central_gradients
from invcompcamtrack_torch.ops import warp

# Backward warp out(x) = img(x + flow(x)), bilinear, edge-clamped: the
# exact per-pixel bilinear, K8's plain version.
warp_image = warp.warp_image_plain


def _box(x: torch.Tensor, radius: int) -> torch.Tensor:
    k = 2 * radius + 1
    kernel = torch.ones((1, 1, k, k), dtype=x.dtype, device=x.device)
    return F.conv2d(x[None, None], kernel, padding=radius)[0, 0]


def _lk_refine(I0, I1, flow, iters: int, radius: int, min_det: float):
    Ix, Iy = central_gradients(I0)
    Ix = Ix * 0.5  # central_gradients returns unscaled I[x+1]-I[x-1]
    Iy = Iy * 0.5
    a11 = _box(Ix * Ix, radius)
    a12 = _box(Ix * Iy, radius)
    a22 = _box(Iy * Iy, radius)
    det = a11 * a22 - a12 * a12
    good = det > min_det
    det_safe = torch.where(good, det, torch.ones_like(det))

    for _ in range(iters):
        It = warp.warp_image(I1, flow) - I0
        b1 = _box(Ix * It, radius)
        b2 = _box(Iy * It, radius)
        du = (a22 * b1 - a12 * b2) / det_safe
        dv = (a11 * b2 - a12 * b1) / det_safe
        upd = torch.stack([du, dv], dim=-1)
        flow = flow - torch.where(good[..., None], upd, torch.zeros_like(upd))
    return flow


def global_shift(I0: torch.Tensor, I1: torch.Tensor) -> torch.Tensor:
    """Dominant integer translation I0 -> I1 via FFT cross-correlation:
    the peak of ifft(F1 conj(F0)) at d means I1(x) ~ I0(x - d).  Returns
    (dx, dy) as a (2,) tensor of I0's type, with no host synchronisation."""
    w0 = I0 - I0.mean()
    w1 = I1 - I1.mean()
    xc = torch.fft.ifft2(torch.fft.fft2(w1) * torch.conj(torch.fft.fft2(w0))).real
    xc = torch.fft.fftshift(xc)
    H, W = I0.shape
    idx = torch.argmax(xc)
    dy = torch.div(idx, W, rounding_mode="floor") - H // 2
    dx = idx % W - W // 2
    return torch.stack([dx, dy]).to(I0.dtype)


def dense_flow_lk(pyr0: Pyramid, pyr1: Pyramid, padding: int,
                  iters: int = 3, radius: int = 4,
                  min_det: float = 1e-4, global_init: bool = True) -> torch.Tensor:
    """Dense flow from image 0 to image 1.

    pyr0/pyr1: pyramids from image.pyramid.build_pyramid (their padding
    is stripped here).  Returns (H, W, 2) at full resolution.

    ``global_init`` seeds the coarsest level with the FFT-correlation
    dominant translation, which extends the usable range far beyond the
    pyramid's LK basin for large mostly-translational motion.
    """
    L = len(pyr0)
    flow = None
    for s in range(L - 1, -1, -1):
        I0 = pyr0[s].img[padding:-padding, padding:-padding].contiguous()
        I1 = pyr1[s].img[padding:-padding, padding:-padding].contiguous()
        H, W = I0.shape
        if flow is None:
            init = global_shift(I0, I1) if global_init \
                else torch.zeros((2,), dtype=I0.dtype, device=I0.device)
            flow = init.expand(H, W, 2).contiguous()
        else:
            # half-pixel-centred bilinear, edge-clamped, to the level's own
            # size (an odd level is not exactly twice the coarser one)
            up = F.interpolate(flow.permute(2, 0, 1)[None], size=(H, W),
                               mode="bilinear", align_corners=False)
            flow = 2.0 * up[0].permute(1, 2, 0).contiguous()
        flow = _lk_refine(I0, I1, flow, iters, radius, min_det)
    return flow
