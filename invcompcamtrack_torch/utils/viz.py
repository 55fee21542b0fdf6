"""Optical-flow visualization with the standard Middlebury color wheel
(the port's own copy of ``invcompcamtrack_tpu/utils/viz.py``, a numpy
module that imports no JAX; a test holds the two equal).

Renders (u, v) flow fields the same way the reference's viewer does
(behavioral spec: misc_src/func_viz_flow.py:12-100: 55-entry wheel,
optional log magnitude, saturation toward white at small radius, 0.75
dimming beyond unit radius), fully vectorized: the wheel is generated by
linear interpolation between hue anchors and the per-pixel coloring is
one broadcasted gather.
"""

from __future__ import annotations

import numpy as np

# The Middlebury wheel: six hue arcs (R->Y->G->C->B->M->R) whose lengths
# encode perceptual spacing.  These segment lengths are the published
# Middlebury constants (public domain, used by every flow toolkit).
_SEGMENTS = (15, 6, 4, 11, 13, 6)
_ANCHORS = np.array([
    [1.0, 0.0, 0.0],   # red
    [1.0, 1.0, 0.0],   # yellow
    [0.0, 1.0, 0.0],   # green
    [0.0, 1.0, 1.0],   # cyan
    [0.0, 0.0, 1.0],   # blue
    [1.0, 0.0, 1.0],   # magenta
    [1.0, 0.0, 0.0],   # wrap back to red
])


def make_colorwheel() -> np.ndarray:
    """(55, 3) RGB wheel: each arc linearly blends anchor i -> i+1,
    endpoint excluded (the next arc starts exactly there)."""
    arcs = []
    for i, n in enumerate(_SEGMENTS):
        t = np.arange(n)[:, None] / n
        arcs.append((1.0 - t) * _ANCHORS[i] + t * _ANCHORS[i + 1])
    return np.concatenate(arcs, axis=0)


def viz_flow(u: np.ndarray, v: np.ndarray, logscale: bool = True,
             scaledown: float = 6.0) -> np.ndarray:
    """(H, W) flow components -> (H, W, 3) uint8 rendering.

    Hue encodes direction, radius encodes (optionally log-compressed)
    magnitude; radius <= 1 blends toward white, radius > 1 is dimmed.
    """
    wheel = make_colorwheel()
    ncols = len(wheel)

    mag = np.hypot(u, v)
    radius = (np.log1p(mag) if logscale else mag) / scaledown

    # continuous wheel coordinate from the flow direction
    fk = (np.arctan2(-v, -u) / np.pi + 1.0) * 0.5 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int64)
    k1 = (k0 + 1) % ncols
    frac = (fk - k0)[..., None]

    col = (1.0 - frac) * wheel[k0] + frac * wheel[k1]          # (H, W, 3)
    r = radius[..., None]
    col = np.where(r <= 1.0, 1.0 - r * (1.0 - col), 0.75 * col)
    return np.floor(255.0 * col).astype(np.uint8)
