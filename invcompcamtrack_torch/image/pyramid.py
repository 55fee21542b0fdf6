"""Image pyramid and gradients (port of
``invcompcamtrack_tpu/image/pyramid.py``).

Level i+1 is the 2x2 mean of level i (odd trailing row/col dropped);
gradients are 3-tap central differences ``[-1, 0, 1]`` with reflect-101
borders; each level is padded by ``padding`` pixels, images by
replicating the border and gradients with zeros.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class PyramidLevel(NamedTuple):
    img: torch.Tensor  # (H + 2p, W + 2p) padded image, or (S, ...) a stack
    dx: torch.Tensor   # same shape, zero-padded gradient
    dy: torch.Tensor


Pyramid = Tuple[PyramidLevel, ...]


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean (odd trailing row/col dropped).  ``avg_pool2d`` sums each
    window in row-major order.  XLA's order for the JAX package's
    reshape-mean depends on the width: the two agree bit for bit at
    320x240, 640x360 and 1280x720, and within 1 ulp elsewhere."""
    return F.avg_pool2d(img[None], 2)[0]


def central_gradients(img: torch.Tensor):
    """dx[i,j] = I[i,j+1] - I[i,j-1] (and dy vertically), reflect-101
    borders, no 1/2 scaling."""
    px = torch.cat([img[..., 1:2], img, img[..., -2:-1]], dim=-1)
    py = torch.cat([img[..., 1:2, :], img, img[..., -2:-1, :]], dim=-2)
    return px[..., 2:] - px[..., :-2], py[..., 2:, :] - py[..., :-2, :]


def pad_level(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
              padding: int) -> PyramidLevel:
    pad = (padding,) * 4
    return PyramidLevel(
        img=F.pad(img[None], pad, mode="replicate")[0],
        dx=F.pad(dx, pad),
        dy=F.pad(dy, pad),
    )


def build_pyramid(img: torch.Tensor, num_levels: int, padding: int) -> Pyramid:
    """img: (H, W) float -> tuple of ``num_levels`` padded levels; a
    stack of S images (S, H, W) gives levels with a leading S, each
    image's as its own pyramid's."""
    levels = []
    cur = img
    for i in range(num_levels):
        if i > 0:
            cur = downsample2x(cur)
        levels.append(pad_level(cur, *central_gradients(cur), padding))
    return tuple(levels)
