"""Rectified-stereo utilities (port of ``invcompcamtrack_tpu/sfm/stereo.py``).

The reference's stereo/KITTI chain triangulates from disparity and gates
tracks by 4-way left/right forward/backward consistency (reference:
run_test_OF_track.py:189-220, 360-371).
"""

from __future__ import annotations

import torch


def disparity_to_points(uv_left: torch.Tensor, disparity: torch.Tensor,
                        fx, fy, cx, cy, baseline) -> torch.Tensor:
    """Rectified-pair triangulation: Z = fx * B / d, X = (u - cx) Z / fx,
    Y = (v - cy) Z / fy (left-camera frame).  Non-positive disparities
    give NaN (behind / at infinity)."""
    d = torch.where(disparity > 0, disparity, torch.full_like(disparity, float("nan")))
    Z = fx * baseline / d
    X = (uv_left[..., 0] - cx) * Z / fx
    Y = (uv_left[..., 1] - cy) * Z / fy
    return torch.stack([X, Y, Z], dim=-1)


def stereo_flow_consistency(uv_l0, uv_r0, uv_l1, uv_r1,
                            max_vertical: float = 1.5, max_loop: float = 1.5):
    """4-way consistency over a stereo pair tracked one step:
    rectification (same row in L/R) at both times plus closed-loop
    displacement agreement.  Inputs are matched point sets (N, 2); returns
    a validity mask."""
    rect0 = torch.abs(uv_l0[..., 1] - uv_r0[..., 1]) < max_vertical
    rect1 = torch.abs(uv_l1[..., 1] - uv_r1[..., 1]) < max_vertical
    loop = torch.linalg.norm((uv_l1 - uv_l0) - (uv_r1 - uv_r0), dim=-1) < max_loop
    finite = (torch.all(torch.isfinite(uv_l0), -1) & torch.all(torch.isfinite(uv_r0), -1)
              & torch.all(torch.isfinite(uv_l1), -1) & torch.all(torch.isfinite(uv_r1), -1))
    return rect0 & rect1 & loop & finite
