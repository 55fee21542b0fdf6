"""3D trajectory/camera visualization helpers (matplotlib).

Ports of the reference's plotting utilities: camera frustum wireframes
(reference: func_plot_cameras, func_util_geom.py:360-394) and the
equal-axis fix for 3D plots (reference: func_set_axes_equal,
func_util_geom.py:330-358).  Host-side, matplotlib-optional.

The port's own copy of ``invcompcamtrack_tpu/utils/plot3d.py``: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def camera_frustum_lines(fc, cc, wh, R: np.ndarray, t_cam: np.ndarray,
                         scale: float = 2.0) -> np.ndarray:
    """Wireframe segments of a camera frustum in world coords.

    R, t_cam: world->cam ([R|t]); returns (16, 2, 3) line segments
    (image border pyramid + up-direction tick).
    """
    c = -R.T @ t_cam
    corners_px = np.array([
        [0, 0], [wh[0], 0], [wh[0], wh[1]], [0, wh[1]],
    ], float)
    rays = np.stack([
        (corners_px[:, 0] - cc[0]) / fc[0],
        (corners_px[:, 1] - cc[1]) / fc[1],
        np.ones(4),
    ], axis=1)
    world = (rays * scale) @ R + c  # R^T rays
    segs = []
    for k in range(4):
        segs.append([c, world[k]])
        segs.append([world[k], world[(k + 1) % 4]])
    # up tick (negative y in image = up)
    up_px = np.array([cc[0], -0.2 * wh[1]])
    up_ray = np.array([(up_px[0] - cc[0]) / fc[0], (up_px[1] - cc[1]) / fc[1], 1.0])
    segs.append([c, up_ray * scale @ R + c])
    for _ in range(7):
        segs.append([c, c])  # pad to fixed 16 segments
    return np.asarray(segs[:16])


def plot_cameras(ax, fc, cc, wh, poses: np.ndarray, color="r", scale=2.0):
    """Draw frusta for (K, 6) se(3) poses on a 3D axis."""
    import torch

    from invcompcamtrack_torch.core import lie

    for p in poses:
        G = lie.se3_exp(torch.as_tensor(np.asarray(p), dtype=torch.float32)).numpy()
        segs = camera_frustum_lines(fc, cc, wh, G[:, :3], G[:, 3], scale)
        for a, b in segs:
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], color=color,
                    linewidth=0.8)


def set_axes_equal(ax) -> None:
    """Equal-scale 3D axes (reference: func_util_geom.py:330-358)."""
    limits = np.array([ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()])
    origin = limits.mean(axis=1)
    radius = 0.5 * (limits[:, 1] - limits[:, 0]).max()
    ax.set_xlim3d(origin[0] - radius, origin[0] + radius)
    ax.set_ylim3d(origin[1] - radius, origin[1] + radius)
    ax.set_zlim3d(origin[2] - radius, origin[2] + radius)
