"""Shi-Tomasi corner detection (port of
``invcompcamtrack_tpu/match/features.py``; the reference seeds corners
with ``cv2.goodFeaturesToTrack(gray, 1000, 0.001, 5)``,
run_OF_point_track.py.ipynb cell 2):

- structure tensor from central-difference gradients, box-filtered,
- corner response = min eigenvalue of the 2x2 tensor (closed form),
- non-max suppression via max-pooling with the given radius,
- top-K selection (fixed K, masked) by response threshold relative to
  the global maximum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from invcompcamtrack_torch.image.pyramid import central_gradients


def _box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean over the (2r+1)^2 box of each image of x (..., H, W)."""
    k = 2 * radius + 1
    kernel = torch.ones((1, 1, k, k), dtype=x.dtype, device=x.device) / (k * k)
    return F.conv2d(x.reshape((-1, 1) + x.shape[-2:]), kernel,
                    padding=radius).reshape(x.shape)


def _maxpool_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    # (max_pool2d pads with -inf)
    return F.max_pool2d(x.reshape((-1, 1) + x.shape[-2:]), 2 * radius + 1, stride=1,
                        padding=radius).reshape(x.shape)


def shi_tomasi_response(img: torch.Tensor, window_radius: int = 1) -> torch.Tensor:
    """Min-eigenvalue corner response map, same shape as img (H, W) or a
    stack of images (S, H, W)."""
    dx, dy = central_gradients(img)
    ixx = _box_filter(dx * dx, window_radius)
    ixy = _box_filter(dx * dy, window_radius)
    iyy = _box_filter(dy * dy, window_radius)
    tr = 0.5 * (ixx + iyy)
    det_part = torch.sqrt(torch.clamp(0.25 * (ixx - iyy) ** 2 + ixy * ixy, min=0.0))
    return tr - det_part  # smaller eigenvalue


def shi_tomasi_corners(img: torch.Tensor, max_corners: int = 1000,
                       quality_level: float = 0.001, min_distance: int = 5,
                       border: int = 8):
    """Top-K corners with NMS.

    Returns (xy (K, 2) float, valid (K,)): fixed K with a validity mask
    instead of a variable-length corner list.  A stack of S images (S, H,
    W) gives (S, K, 2) and (S, K), each image's corners as its own call's
    (threshold, top-k and tiles per image, as ``jax.vmap`` makes them).
    """
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    dev = img.device
    neg_inf = torch.full((), float("-inf"), dtype=img.dtype, device=dev)
    resp = shi_tomasi_response(img)
    # suppress borders
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inside = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    resp = torch.where(inside, resp, neg_inf)
    # non-max suppression
    is_peak = resp >= _maxpool_same(resp, min_distance)
    thresh = quality_level * torch.amax(resp, dim=(-2, -1), keepdim=True)
    score = torch.where(is_peak & (resp >= thresh), resp, neg_inf)

    # Selection.  For large images the score map is bucketed into a grid
    # of tiles, each tile's argmax taken, then the top-k over the (few
    # thousand) tile winners.  This caps corners at one per tile, which
    # for tracking seeds enforces the spatial spread that
    # goodFeaturesToTrack's min_distance only approximates.  Small images
    # keep the exact flat top-k.
    if H * W > 64 * max_corners:
        tile = max(8, int(round((H * W / (4.0 * max_corners)) ** 0.5)))
        Hp = -(-H // tile) * tile
        Wp = -(-W // tile) * tile
        padded = F.pad(score, (0, Wp - W, 0, Hp - H), value=float("-inf"))
        tiles = padded.reshape(lead + (Hp // tile, tile, Wp // tile, tile))
        tiles = tiles.transpose(-3, -2).reshape(lead + (-1, tile * tile))
        t_val, t_arg = torch.max(tiles, dim=-1)
        n_tiles = t_val.shape[-1]
        t_id = torch.arange(n_tiles, device=dev)
        ty = torch.div(t_id, Wp // tile, rounding_mode="floor")
        tx = t_id % (Wp // tile)
        py = torch.div(t_arg, tile, rounding_mode="floor")
        px = t_arg % tile
        flat_idx = (ty * tile + py) * W + (tx * tile + px)
        k = min(max_corners, n_tiles)
        vals, sel = torch.topk(t_val, k)
        idx = torch.gather(flat_idx, -1, sel)
        if k < max_corners:
            pad = max_corners - k
            vals = torch.cat([vals, neg_inf.expand(lead + (pad,))], dim=-1)
            idx = torch.cat([idx, torch.zeros(lead + (pad,), dtype=idx.dtype, device=dev)],
                            dim=-1)
    else:
        vals, idx = torch.topk(score.reshape(lead + (-1,)), max_corners)
    xy = torch.stack([(idx % W).to(img.dtype),
                      torch.div(idx, W, rounding_mode="floor").to(img.dtype)], dim=-1)
    return xy, torch.isfinite(vals)
