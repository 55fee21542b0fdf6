"""Multi-frame forward/backward pose-chain tracking + NCC verification
(port of ``invcompcamtrack_tpu/solver/chain.py``).

The odometry-verification stage of RANSAC pose fitting, the reference's
``run_track_nposes`` binary (reference: run_track_nposes.cpp:133-365).
The reference loops over pose samples (``for sid``, :193); here the
sample axis is a batch through ``track_pose_batch`` for every frame pair:

per sample: start from its hypothesis pose, chain-track forward
``fb_frames[1]`` pairs and backward ``fb_frames[0]`` pairs (the pose
threads through, :229-265), then score every sample point by NCC between
mean-normalized unit-norm patches at level ``lv_l`` extracted at the
(back, reference, forward) reprojections, weighted by the squared chain
lengths (:271-352).  The whole score is one launch of K4
(``ops/ncc3.py``) on the card.

The per-sample inlier subsets are fixed-shape boolean masks over the
shared correspondence set (:207-213's gather, made static).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from invcompcamtrack_torch.config import ICGNParams
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core import pose as pose_ops
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.image.pyramid import Pyramid
from invcompcamtrack_torch.match.ncc import patch_correlation_combine
from invcompcamtrack_torch.ops.ncc3 import ncc3_scores
from invcompcamtrack_torch.solver.icgn import track_pose_batch


class ChainResult(NamedTuple):
    pose_tracks: torch.Tensor    # (S, M, 6) poses per image (M = fb0+fb1+1)
    correlations: torch.Tensor   # (S, N) per-point scores (-1 = invalid)
    mean_corr: torch.Tensor      # (S,) masked mean over each sample's inliers


def _strict_inside(uv, swo, sho):
    """The NCC scoring path uses a strictly-interior check
    (reference: run_track_nposes.cpp:292: > 0 and < swo)."""
    return (uv[..., 0] > 0) & (uv[..., 1] > 0) & (uv[..., 0] < swo) & (uv[..., 1] < sho)


def track_nposes(pyramids: Sequence[Pyramid], poses: torch.Tensor,
                 pt3d: torch.Tensor, inlier_masks: torch.Tensor,
                 cam: CameraPyramid, cfg: ICGNParams,
                 fb_frames=(1, 1)) -> ChainResult:
    """pyramids: M = fb0+fb1+1 image pyramids, index fb0 = reference frame.
    poses: (S, 6) hypothesis poses (world->cam of the reference frame).
    pt3d: (N, 3) shared correspondence set; inlier_masks: (S, N) bool.
    """
    fb0, fb1 = int(fb_frames[0]), int(fb_frames[1])
    S = poses.shape[0]
    Xb = pt3d.expand((S,) + tuple(pt3d.shape))

    tracks = [None] * (fb0 + fb1 + 1)
    tracks[fb0] = poses

    # forward chain (reference: run_track_nposes.cpp:229-246)
    p_cur = poses
    for fr in range(fb1):
        fr_t = fr + fb0
        p_cur = track_pose_batch(pyramids[fr_t], pyramids[fr_t + 1], Xb, p_cur,
                                 cam, cfg, point_mask=inlier_masks)
        tracks[fr_t + 1] = p_cur
    p_fwd_end = p_cur

    # backward chain (reference: :249-265)
    p_cur = poses
    for fr in range(fb0):
        fr_t = fb0 - fr
        p_cur = track_pose_batch(pyramids[fr_t], pyramids[fr_t - 1], Xb, p_cur,
                                 cam, cfg, point_mask=inlier_masks)
        tracks[fr_t - 1] = p_cur
    p_back_end = p_cur

    pose_tracks = torch.stack(tracks, dim=1)  # (S, M, 6)

    # --- NCC scoring at level lv_l (reference: :271-352) ---
    lvl = cfg.lv_l
    fx, fy, cx, cy, swo, sho = cam.level(lvl)
    if cfg.donorm:
        Xn, mean, varval = pose_ops.normalize_points(Xb, mask=inlier_masks)

    def reproject(p_batch):
        pn = pose_ops.normalize_pose(p_batch, mean, varval) if cfg.donorm else p_batch
        return pose_ops.project_points(lie.se3_exp(pn), Xn if cfg.donorm else Xb,
                                       fx, fy, cx, cy)

    uv_ref = reproject(poses)        # (S, N, 2)
    uv_fwd = reproject(p_fwd_end)
    uv_back = reproject(p_back_end)

    v_ref = _strict_inside(uv_ref, swo, sho)
    v_fwd = _strict_inside(uv_fwd, swo, sho)
    v_back = _strict_inside(uv_back, swo, sho)

    # patches: back from the OLDEST image, ref from frame fb0, fwd from
    # the NEWEST image (reference: :293, :300, :308), mean-normalized
    # (dopatchnorm forced, :281): gathers, norms and both correlations in
    # one kernel on the card, its plain version on the CPU
    def clean(uv):
        return torch.where(torch.isfinite(uv), uv, torch.zeros_like(uv)).contiguous()

    corr_br, corr_rf = ncc3_scores(
        pyramids[0][lvl].img, pyramids[fb0][lvl].img, pyramids[-1][lvl].img,
        clean(uv_back), clean(uv_ref), clean(uv_fwd), psz=cfg.psz, padding=cfg.psz)
    corr = patch_correlation_combine(corr_br, corr_rf, v_back, v_ref, v_fwd,
                                     (fb0, fb1))
    corr = torch.where(inlier_masks, corr, torch.full_like(corr, -1.0))

    m = inlier_masks.to(corr.dtype)
    mean_corr = (torch.sum(torch.where(inlier_masks, corr, torch.zeros_like(corr)), dim=1)
                 / torch.clamp(torch.sum(m, dim=1), min=1.0))
    return ChainResult(pose_tracks=pose_tracks, correlations=corr, mean_corr=mean_corr)


def select_best(result: ChainResult, valid: torch.Tensor):
    """Winner = highest mean patch correlation among valid hypotheses
    (reference: func_ransac_fitcameras_odom.m:151-154).  Returns
    (best_index, best_mean_corr)."""
    score = torch.where(valid, result.mean_corr,
                        torch.full_like(result.mean_corr, float("-inf")))
    best = torch.argmax(score)
    return best, score[best]
