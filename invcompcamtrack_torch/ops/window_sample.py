"""Per-point window cache: origins, gather and resample (port of
``invcompcamtrack_tpu/ops/window_sample.py``).

Once per scale the tracker caches a ``(win, win)`` window of the query
image per point; every GN iteration then resamples the ``(psz, psz)``
patch from that window.  The tap math is ``image/taps.py``'s
(``bilinear_base``, ``combine``); the integer offset of the tap support
inside the window is clamped to ``[0, win - psz - 1]``.

``sample_from_windows`` resamples on the tracker's non-fused path
(``psz != 8``) and is the readable spec of the resample inside K2
(``ops/icgn_iter.py``), which takes the offsets and weights that
``window_taps`` computes.  The JAX module reaches the tap support by a
select-shift over the possible offsets, which spares its device a
gather; here the window is indexed at ``(row_w, col_w)`` directly, which
picks the same floats for the same 4-tap sum.  ``gather_windows_any``
fills the cache: K7 (``ops/patch_gather.py``) on a CUDA tensor, its
plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.image.taps import bilinear_base, combine
from invcompcamtrack_torch.ops import patch_gather


def window_origin(centers: torch.Tensor, psz: int, win: int,
                  padding: int) -> torch.Tensor:
    """(row, col) int32 origin in the PADDED image of the window that
    puts the center's patch mid-window -> (..., 2)."""
    slack = (win - psz - 1) // 2
    row0, col0, _ = bilinear_base(centers, psz, padding)
    return torch.stack([row0 - slack, col0 - slack], dim=-1)


def window_taps(centers: torch.Tensor, origins: torch.Tensor, psz: int,
                padding: int, win: int):
    """Window-frame offsets and weights of the tap support.

    centers (..., 2) current sub-pixel positions (unpadded coords),
    origins (..., 2) -> row_w, col_w (...,) int32 in [0, win-psz-1] and
    the weights (..., 4) = (w00, w01, w10, w11).
    """
    n_off = win - psz
    row0, col0, wts = bilinear_base(centers, psz, padding)
    row_w = torch.clamp(row0 - origins[..., 0], 0, n_off - 1)
    col_w = torch.clamp(col0 - origins[..., 1], 0, n_off - 1)
    return row_w, col_w, wts


def resample_windows(windows: torch.Tensor, row_w: torch.Tensor,
                     col_w: torch.Tensor, wts: torch.Tensor,
                     psz: int) -> torch.Tensor:
    """windows (M, win, win), offsets (M,), weights (M, 4) -> the 4-tap
    patches (M, psz, psz), summed as ``image/taps.py`` sums them."""
    M = windows.shape[0]
    ar = torch.arange(psz + 1, device=windows.device)
    rows = row_w.long()[:, None] + ar
    cols = col_w.long()[:, None] + ar
    m = torch.arange(M, device=windows.device)[:, None, None]
    return combine(windows[m, rows[:, :, None], cols[:, None, :]], wts)


def sample_from_windows(windows: torch.Tensor, origins: torch.Tensor,
                        centers: torch.Tensor, psz: int, padding: int,
                        patch_norm: bool = False) -> torch.Tensor:
    """windows (..., N, WIN, WIN) cached at ``origins`` (..., N, 2);
    centers (..., N, 2) -> (..., N, psz, psz) patches."""
    win = windows.shape[-1]
    lead = centers.shape[:-1]
    row_w, col_w, wts = window_taps(centers, origins, psz, padding, win)
    patches = resample_windows(windows.reshape(-1, win, win), row_w.reshape(-1),
                               col_w.reshape(-1), wts.reshape(-1, 4), psz)
    patches = patches.reshape(lead + (psz, psz))
    if patch_norm:
        patches = patches - torch.mean(patches, dim=(-2, -1), keepdim=True)
    return patches


def gather_windows_any(img: torch.Tensor, origins: torch.Tensor,
                       win: int) -> torch.Tensor:
    """Integer-origin (win, win) windows of the PADDED image; origins
    (..., 2) int32.  A window that would leave the image is moved back
    inside it (the ``dynamic_slice`` rule of the JAX package's XLA
    path).  K7 on a CUDA tensor, its plain version on a CPU tensor."""
    return patch_gather.gather_windows(img, origins, win, win)
