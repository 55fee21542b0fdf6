"""The monocular visual-odometry engine, one stream (port of
``invcompcamtrack_tpu/vo/engine.py``).

Frame loop: pyramid -> IC-GN pose tracking against the newest keyframe's
map points -> keyframe policy -> LK re-observation + corner
triangulation of new landmarks -> sliding-window bundle adjustment.

The engine state is one fixed-shape ``VOState`` of device tensors
(landmark table, keyframe ring, observation grid, keyframe pyramid
stacks), as in the JAX module, and a frame is one of its step functions:
``_track_step`` for ordinary frames, ``_keyframe_step`` for keyframes
(track + re-observe + triangulate + BA).  The JAX module jits each step
into one program; here each step runs eagerly, op by op, and never reads
a device value back to the host:

- **The keyframe ring.**  ``kf_ptr`` (the newest slot) and the ring's
  occupancy are host values (``VOState.kf_ptr``, ``kf_valid_host``): the
  next slot is ``(kf_ptr + 1) % K`` and the founding partner slot (the
  oldest valid one) depends on the occupancy only, never on the data.
  So slots are Python ints, a keyframe's pyramid is a view into the
  ``(K, H_s, W_s)`` stacks, and promotion writes the new pyramid into
  its slot in place: the stacks (about 75 MB at 1280x720) are never
  copied.  The write happens after every read of the step, so a step
  consumes the state it was given (its pyramid stacks) and returns the
  next one.
- **The BA gate** (``lax.cond`` in the JAX module) is a select: the
  window BA always runs and ``torch.where(do_ba, ...)`` keeps or drops
  its result, as the JAX engine under ``vmap`` does.
- ``lax.top_k`` is ``torch.topk``; the ``vmap``s over the K poses are
  batched ``se3_exp``; ``jax.jacfwd`` is ``torch.func.jacfwd`` (under
  ``torch.func.vmap`` for the information-weighted priors);
  ``jnp.linalg.cholesky`` is ``torch.linalg.cholesky_ex`` with a failed
  factor set to NaN, which takes the same isotropic fallback.
- ``run_frames`` loops over keyframe periods where the JAX module scans,
  and pulls the chunk's camera centres back to the host once.

Kernels on this path: the tracker's K1 and K2 (``solver/icgn.py``), the
sparse LK's K6 and K7 (``match/lk.py``) and, with
``odo_info_weighted=True``, K5 (``image/patch.py::extract_patches``).

Not in this slice: ``VisualOdometryBatch`` and the multi-device BA paths
(``ba_mesh``, ``ba_temporal_mesh``), which raise ``NotImplementedError``
unless ``None``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from invcompcamtrack_torch.ba.window import BAProblem, OdoFactors, ba_residuals, ba_solve
from invcompcamtrack_torch.config import ICGNParams
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core import pose as pose_ops
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.device import resolve
from invcompcamtrack_torch.image.patch import extract_patches
from invcompcamtrack_torch.image.pyramid import Pyramid, PyramidLevel, build_pyramid
from invcompcamtrack_torch.match.features import shi_tomasi_corners
from invcompcamtrack_torch.match.lk import lk_forward_backward
from invcompcamtrack_torch.sfm.triangulate import triangulate_dlt, triangulate_gn
from invcompcamtrack_torch.solver.icgn import cam_level_padding, track_pose


@dataclasses.dataclass
class VOConfig:
    """The JAX module's ``VOConfig``: same fields and defaults (see there
    for the measurements behind each default), less the multi-device BA's
    axis names and CG iterations, which come with its slice."""

    tracker: ICGNParams = dataclasses.field(default_factory=ICGNParams)
    max_landmarks: int = 512
    window: int = 5              # BA keyframe window (ring size)
    keyframe_stride: int = 2     # promote every k-th frame to keyframe
    ba_iters: int = 6
    min_parallax_px: float = 2.0  # parallax needed to triangulate
    lk_psz: int = 8
    corners_per_kf: int = 512
    huber_px: float = 1.5        # BA Huber loss width (pixels)
    reobs_gate_px: float = 4.0   # reprojection gate on measured re-observations
    ba_obs_gate_px: float = 10.0  # gross-outlier observations leave the window
    min_tri_angle_deg: float = 0.4  # ray-angle gate on new triangulations
    max_obs_fail: int = 2        # consecutive failures before retirement
    min_kf_for_ba: int = 3
    min_lm_for_ba: int = 12
    ba_mode: str = "hybrid"      # "structure" | "full" | "hybrid"
    ba_struct_iters: int = 6     # hybrid: iterations of the structure pre-pass
    ba_joint_motion_only: bool = False  # hybrid: joint phase refines poses only
    polish_max_parallax_deg: float = 1.5  # hybrid: parallax gate on the polish
    polish_min_forwardness: float = 0.7   # hybrid: motion-direction gate
    polish_joint_turnover: float = 0.0    # hybrid: turnover routing threshold
    ba_lm_step_clip: float = 0.1  # per-iteration landmark trust region
    ba_lm_eig_floor: float = 5e-3  # spectral observability cutoff on H_ll
    odo_prior: bool = True       # full/hybrid: odometry prior factors
    odo_sigma_t: float = 0.01    # odometry 1-sigma translation (world units)
    odo_sigma_r: float = 0.001   # odometry 1-sigma rotation (radians)
    odo_info_weighted: bool = False  # weight each prior by the tracker's
    #   converged GN Hessian (its Fisher information), summed with the
    #   isotropic prior
    odo_info_px_sigma: float = 0.3  # assumed 1-sigma of the LK observations (px)
    ba_debug: bool = False       # print per-keyframe BA costs (syncs)
    ba_mesh: object = None       # multi-device BA: not in this slice
    ba_temporal_mesh: object = None  # multi-device BA: not in this slice


class VOState(NamedTuple):
    """Full engine state: fixed-shape device tensors and the ring's host
    mirror."""

    landmarks: torch.Tensor    # (L, 3)
    lm_valid: torch.Tensor     # (L,) bool
    lm_fail: torch.Tensor      # (L,) int32 consecutive re-observation failures
    kf_poses: torch.Tensor     # (K, 6)
    kf_valid: torch.Tensor     # (K,) bool
    kf_obs: torch.Tensor       # (K, L, 2) MEASURED pixel observations
    kf_obs_mask: torch.Tensor  # (K, L) bool
    kf_rel: torch.Tensor       # (K, 3, 4) measured relative pose slot (k-1)%K -> k
    kf_rel_valid: torch.Tensor  # (K,) bool
    kf_rel_info: torch.Tensor  # (K, 6, 6) photometric Fisher information of
    #                            slot k's rel measurement (zeros: not recorded)
    kf_pyr: Tuple[PyramidLevel, ...]  # per level: fields (K, H_s, W_s)
    kf_ptr: int                # newest keyframe slot (host)
    cur_pose: torch.Tensor     # (6,)
    frame_idx: int             # (host)
    kf_valid_host: Tuple[bool, ...]  # host mirror of kf_valid


def _raise_multi_device(cfg: VOConfig) -> None:
    if cfg.ba_mesh is not None or cfg.ba_temporal_mesh is not None:
        raise NotImplementedError(
            "ba_mesh and ba_temporal_mesh (the multi-device window BA) belong to "
            "the port's multi-device slice; leave them None")


# ---------------------------------------------------------------------------
# pyramid-ring helpers


def _index_pyr(kf_pyr, slot: int) -> Pyramid:
    """One keyframe's pyramid: views into the (K, ...) stacks."""
    return tuple(PyramidLevel(*(a[slot] for a in lvl)) for lvl in kf_pyr)


def _update_pyr(kf_pyr, slot: int, pyr: Pyramid):
    """Write one pyramid into slot of the (K, ...) stacks, in place."""
    for stack, lvl in zip(kf_pyr, pyr):
        for a, b in zip(stack, lvl):
            a[slot].copy_(b)
    return kf_pyr


def _row_set(arr: torch.Tensor, slot: int, row) -> torch.Tensor:
    out = arr.clone()
    out[slot] = row
    return out


def _camera_centers(poses: torch.Tensor) -> torch.Tensor:
    return lie.camera_center(lie.se3_exp(poses))


# ---------------------------------------------------------------------------
# device steps


def _track_frame(state: VOState, pyr: Pyramid, cam: CameraPyramid,
                 cfgt: ICGNParams, want_info: bool = False,
                 px_sigma: float = 0.3):
    """IC-GN track the new frame against the newest keyframe's map (the
    init pose is the reference image's pose, reference:
    odometer.cpp:241-255).

    With ``want_info``, also returns the tracker's (6, 6) Fisher
    information: the finest-scale GN Hessian divided by the photometric
    residual variance at the final pose, scaled by ``px_sigma^2`` into
    the BA's unit-noise-pixel convention.
    """
    fx, fy, cx, cy, swo, sho = cam.level(0)
    ref_pyr = _index_pyr(state.kf_pyr, state.kf_ptr)
    pose_ref = state.kf_poses[state.kf_ptr]
    G = lie.se3_exp(pose_ref)
    uv = pose_ops.project_points(G, state.landmarks, fx, fy, cx, cy)
    uv = torch.where(torch.isfinite(uv), uv, torch.full_like(uv, -1.0))
    vis = pose_ops.in_frustum(uv, swo, sho) & state.lm_valid
    if not want_info:
        return track_pose(ref_pyr, pyr, state.landmarks, pose_ref, cam, cfgt,
                          point_mask=vis)
    p_new, aux = track_pose(ref_pyr, pyr, state.landmarks, pose_ref, cam, cfgt,
                            point_mask=vis, return_aux=True)

    # photometric residual variance at convergence (finest level): one
    # patch-pair extraction per keyframe (K5 on the card)
    G_new = lie.se3_exp(p_new)
    uv_r, Xc_r = pose_ops.project_points(G, state.landmarks, fx, fy, cx, cy,
                                         return_cam=True)
    uv_n, Xc_n = pose_ops.project_points(G_new, state.landmarks, fx, fy, cx, cy,
                                         return_cam=True)
    ok = (vis & pose_ops.in_frustum(uv_r, swo, sho) & (Xc_r[..., 2] > 0)
          & pose_ops.in_frustum(uv_n, swo, sho) & (Xc_n[..., 2] > 0)
          & torch.all(torch.isfinite(uv_r) & torch.isfinite(uv_n), dim=-1))
    uv_r = torch.where(ok[..., None], uv_r, torch.zeros_like(uv_r))
    uv_n = torch.where(ok[..., None], uv_n, torch.zeros_like(uv_n))
    pad = cam_level_padding(cfgt)
    pr = extract_patches(ref_pyr[0].img, uv_r, cfgt.psz, pad, patch_norm=cfgt.dopatchnorm)
    pn = extract_patches(pyr[0].img, uv_n, cfgt.psz, pad, patch_norm=cfgt.dopatchnorm)
    d = (pr - pn) * ok[..., None, None].to(pr.dtype)
    cnt = torch.clamp(torch.sum(ok) * (cfgt.psz * cfgt.psz), min=1)
    sigma2_img = torch.sum(d * d) / cnt
    # floor: exact synthetic renders can converge to ~0 residual; 1e-4 of
    # the image's dynamic range squared keeps the information finite
    rng_img = torch.clamp(torch.amax(torch.abs(ref_pyr[0].img)), min=1.0)
    sigma2_img = torch.maximum(sigma2_img, (1e-4 * rng_img) ** 2)
    info = aux.hessian * (px_sigma ** 2) / sigma2_img
    info = torch.where(torch.isfinite(info), info, torch.zeros_like(info))
    return p_new, info


class _ReobsOut(NamedTuple):
    """Stage boundary: re-observation results (promote part 1)."""

    xy_meas: torch.Tensor   # (L, 2) measured LK positions in the new kf
    reobs: torch.Tensor     # (L,) bool: landmark successfully re-observed
    lm_fail: torch.Tensor   # (L,) int32 updated failure counters
    lm_valid: torch.Tensor  # (L,) bool after lifecycle retirement


class _TriOut(NamedTuple):
    """Stage boundary: triangulation results (promote part 2)."""

    landmarks: torch.Tensor     # (L, 3) with new seeds scattered in
    lm_valid: torch.Tensor      # (L,) bool
    lm_fail: torch.Tensor       # (L,) int32
    old_slot: int               # founding partner keyframe slot (host)
    old_obs: torch.Tensor       # (L, 2) partner row incl. founding obs
    old_obs_mask: torch.Tensor  # (L,)
    new_obs: torch.Tensor       # (L, 2) new keyframe's observation row
    new_obs_mask: torch.Tensor  # (L,)
    n_seeded: torch.Tensor      # () int32: landmarks newly triangulated


def _promote_reobserve(state: VOState, pyr: Pyramid, p_new,
                       cam: CameraPyramid, cfg: VOConfig) -> _ReobsOut:
    """Promote part 1: measured re-observation of existing landmarks.

    LK-track each landmark's patch from its measured position in the
    previous keyframe into the new keyframe, seeded at the predicted
    reprojection; the record is the MEASURED position.
    """
    cfgt = cfg.tracker
    fx, fy, cx, cy, swo, sho = cam.level(0)
    prev = state.kf_ptr
    prev_pyr = _index_pyr(state.kf_pyr, prev)
    G_prev = lie.se3_exp(state.kf_poses[prev])
    G_new = lie.se3_exp(p_new)

    proj_prev = pose_ops.project_points(G_prev, state.landmarks, fx, fy, cx, cy)
    proj_new = pose_ops.project_points(G_new, state.landmarks, fx, fy, cx, cy)
    proj_prev = torch.where(torch.isfinite(proj_prev), proj_prev, torch.zeros_like(proj_prev))
    proj_new_s = torch.where(torch.isfinite(proj_new), proj_new, torch.zeros_like(proj_new))
    start = torch.where(state.kf_obs_mask[prev][:, None], state.kf_obs[prev], proj_prev)
    xy_meas, lk_ok = lk_forward_backward(prev_pyr, pyr, start, init_xy=proj_new_s,
                                         psz=cfg.lk_psz, num_levels=cfgt.num_levels)
    vis_new = (pose_ops.in_frustum(proj_new_s, swo, sho)
               & torch.all(torch.isfinite(proj_new), dim=1))
    reproj_ok = torch.linalg.norm(xy_meas - proj_new_s, dim=1) < cfg.reobs_gate_px
    reobs = (state.lm_valid & lk_ok & vis_new & reproj_ok
             & pose_ops.in_frustum(xy_meas, swo, sho))

    # landmark lifecycle: consecutive misses while expected visible
    # retire the landmark and free its slot
    expected = state.lm_valid & vis_new
    lm_fail = torch.where(reobs, torch.zeros_like(state.lm_fail),
                          torch.where(expected, state.lm_fail + 1, state.lm_fail))
    lm_valid = state.lm_valid & (lm_fail < cfg.max_obs_fail)
    return _ReobsOut(xy_meas=xy_meas, reobs=reobs, lm_fail=lm_fail, lm_valid=lm_valid)


def _partner_slot(kf_valid_host, prev: int, new_slot: int, K: int) -> int:
    """The oldest valid keyframe other than the slot being evicted (the
    JAX module's argmax over ring ages, first on ties), on the host."""
    ages = [(prev - s) % K if kf_valid_host[s] and s != new_slot else -1
            for s in range(K)]
    return max(range(K), key=lambda s: ages[s])


def _promote_triangulate(state: VOState, pyr: Pyramid, p_new,
                         cam: CameraPyramid, cfg: VOConfig,
                         ro: _ReobsOut) -> _TriOut:
    """Promote part 2: triangulate new landmarks from measured corner
    tracks into free slots."""
    cfgt = cfg.tracker
    K = cfg.window
    fx, fy, cx, cy, _, _ = cam.level(0)
    fc2 = torch.stack([fx, fy])
    cc2 = torch.stack([cx, cy])
    prev = state.kf_ptr
    new_slot = (prev + 1) % K
    G_new = lie.se3_exp(p_new)

    # partner = the OLDEST valid keyframe in the window (the longest
    # baseline), never the slot evicted this step
    old_slot = _partner_slot(state.kf_valid_host, prev, new_slot, K)
    old_pyr = _index_pyr(state.kf_pyr, old_slot)
    G_old = lie.se3_exp(state.kf_poses[old_slot])

    psz = cfgt.psz
    xy0, cvalid = shi_tomasi_corners(old_pyr[0].img[psz:-psz, psz:-psz],
                                     max_corners=cfg.corners_per_kf, border=psz)
    xy1, lk_okc = lk_forward_backward(old_pyr, pyr, xy0, psz=cfg.lk_psz,
                                      num_levels=cfgt.num_levels)
    parallax = torch.linalg.norm(xy1 - xy0, dim=1)
    good = cvalid & lk_okc & (parallax > cfg.min_parallax_px)

    c_old = lie.camera_center(G_old)
    c_new = lie.camera_center(G_new)
    P0 = pose_ops.projection_matrix(fc2, cc2, G_old[:, :3], c_old)
    P1 = pose_ops.projection_matrix(fc2, cc2, G_new[:, :3], c_new)
    P = torch.stack([P0, P1]).expand(xy0.shape[0], 2, 3, 4)
    obs2 = torch.stack([xy0, xy1], dim=1)
    X_new, _ = triangulate_dlt(P, obs2, R0=G_old[:, :3], c0=c_old)
    X_new, _ = triangulate_gn(P, obs2, torch.nan_to_num(X_new), num_iters=3)
    depth_ok = ((pose_ops.transform_points(G_new, X_new)[..., 2] > 0.05)
                & (pose_ops.transform_points(G_old, X_new)[..., 2] > 0.05)
                & torch.all(torch.isfinite(X_new), dim=1))
    # ray-angle gate: depth is only observable with enough baseline
    r0 = X_new - c_old
    r1 = X_new - c_new
    cosang = torch.sum(r0 * r1, dim=1) / torch.clamp(
        torch.linalg.norm(r0, dim=1) * torch.linalg.norm(r1, dim=1), min=1e-12)
    ang_ok = cosang < math.cos(math.radians(cfg.min_tri_angle_deg))
    good = good & depth_ok & ang_ok

    landmarks, lm_valid, seeded, take = _fill_slots(state.landmarks, ro.lm_valid,
                                                    X_new, good)
    lm_fail = torch.where(seeded, torch.zeros_like(ro.lm_fail), ro.lm_fail)

    # seeded slots get their two MEASURED founding observations
    take_c = torch.clamp(take, 0, xy0.shape[0] - 1)
    old_obs = torch.where(seeded[:, None], xy0[take_c], state.kf_obs[old_slot])
    old_obs_mask = state.kf_obs_mask[old_slot] | seeded
    new_obs = torch.where(seeded[:, None], xy1[take_c], ro.xy_meas)
    new_obs_mask = ro.reobs | seeded
    return _TriOut(landmarks=landmarks, lm_valid=lm_valid, lm_fail=lm_fail,
                   old_slot=old_slot, old_obs=old_obs, old_obs_mask=old_obs_mask,
                   new_obs=new_obs, new_obs_mask=new_obs_mask,
                   n_seeded=torch.sum(seeded).to(torch.int32))


def _info_sqrt(cfg: VOConfig, kf_rel, kf_poses, kf_rel_info) -> torch.Tensor:
    """(K, 6, 6) square roots S (W = S^T S) of each odometry factor's
    information in the residual coordinates: the isotropic prior plus the
    tracker's measured information mapped through the inverse residual
    Jacobian A = dr_u/dp_k, W_r = A^-T W_p A^-1 (the JAX module's
    ``_fsqrt``, batched over the K factors)."""
    dt, dev = kf_rel.dtype, kf_rel.device
    I6 = torch.eye(6, dtype=dt, device=dev)
    w_iso = torch.cat([torch.full((3,), (1.0 / cfg.odo_sigma_t) ** 2, dtype=dt, device=dev),
                       torch.full((3,), (1.0 / cfg.odo_sigma_r) ** 2, dtype=dt, device=dev)])
    W_iso = torch.diag(w_iso)

    def r_of_pk(pk, rel_k, p_prev):
        D = lie.se3_compose(lie.se3_compose(lie.se3_exp(pk),
                                            lie.se3_inverse(lie.se3_exp(p_prev))),
                            lie.se3_inverse(rel_k))
        R = D[:, :3]
        rw = 0.5 * torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        return torch.cat([D[:, 3], rw])

    A = torch.func.vmap(torch.func.jacfwd(r_of_pk))(
        kf_poses, kf_rel, torch.roll(kf_poses, 1, dims=0)).to(dt)          # (K,6,6)
    Ainv = torch.linalg.solve_ex(A + 1e-8 * I6, I6.expand_as(A), check_errors=False)[0]
    Wp_s = 0.5 * (kf_rel_info + kf_rel_info.transpose(-1, -2))
    W_r = Ainv.transpose(-1, -2) @ Wp_s @ Ainv
    W_r = 0.5 * (W_r + W_r.transpose(-1, -2))
    # the isotropic term is the correlated-error floor; the photometric
    # term adds stiffness along the well-measured axes
    tr_p = torch.diagonal(Wp_s, dim1=-2, dim2=-1).sum(-1)
    W = W_iso + torch.where((tr_p > 0)[:, None, None], W_r, torch.zeros_like(W_r))
    ridge = 1e-6 * torch.diagonal(W, dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-12
    Lc, info = torch.linalg.cholesky_ex(W + ridge[:, None, None] * I6, check_errors=False)
    # a failed factor is NaN (as jnp.linalg.cholesky's), which takes the
    # isotropic fallback below
    Lc = torch.where((info == 0)[:, None, None], Lc, torch.full_like(Lc, float("nan")))
    S = Lc.transpose(-1, -2)
    finite = torch.isfinite(S).flatten(1).all(1)
    return torch.where(finite[:, None, None], S, torch.sqrt(W_iso).expand_as(S))


def _promote_commit(state: VOState, pyr: Pyramid, p_new,
                    cam: CameraPyramid, cfg: VOConfig,
                    tri: _TriOut, rel_info=None) -> VOState:
    """Promote parts 3-4: ring write, gross-outlier gating, windowed BA,
    post-BA retirement."""
    _raise_multi_device(cfg)
    K = cfg.window
    fx, fy, cx, cy, _, _ = cam.level(0)
    prev = state.kf_ptr
    new_slot = (prev + 1) % K
    dt, dev = p_new.dtype, p_new.device
    G_prev = lie.se3_exp(state.kf_poses[prev])
    G_new = lie.se3_exp(p_new)
    slots_all = torch.arange(K, device=dev)
    landmarks, lm_valid, lm_fail = tri.landmarks, tri.lm_valid, tri.lm_fail
    old_slot = tri.old_slot

    # ---- (3) ring write: evict new_slot, record the keyframe ----
    kf_obs = _row_set(state.kf_obs, old_slot, tri.old_obs)
    kf_obs[new_slot] = tri.new_obs
    kf_obs_mask = _row_set(state.kf_obs_mask, old_slot, tri.old_obs_mask)
    kf_obs_mask[new_slot] = tri.new_obs_mask
    kf_poses = _row_set(state.kf_poses, new_slot, p_new)
    kf_valid = _row_set(state.kf_valid, new_slot, True)
    kf_valid_host = tuple(v or s == new_slot for s, v in enumerate(state.kf_valid_host))
    kf_pyr = _update_pyr(state.kf_pyr, new_slot, pyr)

    # the photometric odometry measurement prev -> new, before BA
    # touches either pose: it anchors the odometry-prior factors
    kf_rel = _row_set(state.kf_rel, new_slot, lie.se3_compose(G_new, lie.se3_inverse(G_prev)))
    kf_rel_valid = _row_set(state.kf_rel_valid, new_slot, True)
    kf_rel_info = _row_set(state.kf_rel_info, new_slot,
                           rel_info if rel_info is not None else 0.0)

    # a landmark observed by no keyframe left in the window is retired
    observed_any = torch.any(kf_obs_mask & kf_valid[:, None], dim=0)
    lm_valid = lm_valid & observed_any

    # ---- (4) windowed BA on the measured observation grid ----
    if cfg.ba_mode == "structure":
        fixed = torch.ones((K,), dtype=torch.bool, device=dev)
    else:
        # the two OLDEST valid keyframes anchor the window; every newer
        # pose floats (invalid slots count as fixed)
        ages = torch.where(kf_valid, (new_slot - slots_all) % K, -1)
        oldest2 = torch.topk(ages, 2)[0][-1]
        fixed = (~kf_valid) | (ages >= oldest2)
    mask = kf_obs_mask & kf_valid[:, None] & lm_valid[None, :]
    prob = BAProblem(poses=kf_poses, landmarks=landmarks, obs=kf_obs, mask=mask,
                     fx=fx, fy=fy, cx=cx, cy=cy, fixed_pose_mask=fixed)
    # hard residual gate: a measurement grossly inconsistent with the
    # current state is a correspondence failure; it leaves the window
    res0, _ = ba_residuals(prob)
    obs_ok = torch.linalg.norm(res0, dim=-1) < cfg.ba_obs_gate_px
    kf_obs_mask = kf_obs_mask & (obs_ok | ~mask)
    mask = mask & obs_ok
    prob = prob._replace(mask=mask)
    do_ba = ((torch.sum(kf_valid) >= cfg.min_kf_for_ba)
             & (torch.sum(lm_valid) >= cfg.min_lm_for_ba))

    # observability statistic of the polish gate: the live map's mean
    # triangulation angle between the partner and the new keyframe
    c_old_g = lie.camera_center(lie.se3_exp(kf_poses[old_slot]))
    c_new_g = lie.camera_center(G_new)
    r0g = landmarks - c_old_g
    r1g = landmarks - c_new_g
    cosg = torch.sum(r0g * r1g, dim=1) / torch.clamp(
        torch.linalg.norm(r0g, dim=1) * torch.linalg.norm(r1g, dim=1), min=1e-12)
    ang = torch.arccos(torch.clamp(cosg, -1.0, 1.0))
    mean_parallax = (torch.sum(torch.where(lm_valid, ang, torch.zeros_like(ang)))
                     / torch.clamp(torch.sum(lm_valid), min=1))
    # motion-direction statistic of the forwardness gate: the window's
    # displacement-weighted translation fraction along the optical axis
    G_k = lie.se3_exp(kf_poses)
    kf_centers = lie.camera_center(G_k)                                # (K, 3)
    dc = kf_centers - torch.roll(kf_centers, 1, dims=0)
    dc_cam = torch.einsum("kij,kj->ki", G_k[..., :3], dc)
    step_len = torch.linalg.norm(dc, dim=1)
    f_ok = (kf_valid & torch.roll(kf_valid, 1) & (slots_all != (new_slot + 1) % K))
    wsum = torch.sum(torch.where(f_ok, step_len, torch.zeros_like(step_len)))
    forwardness = torch.sum(torch.where(f_ok, torch.abs(dc_cam[:, 2]),
                                        torch.zeros_like(step_len))) / torch.clamp(wsum, min=1e-12)
    polish_on = ((mean_parallax < math.radians(cfg.polish_max_parallax_deg))
                 & (forwardness >= cfg.polish_min_forwardness))

    odo = None
    if cfg.ba_mode in ("full", "hybrid") and cfg.odo_prior:
        # factor k constrains ring slots (k-1)%K -> k; the wrap-around
        # factor into the OLDEST slot is stale and masked out
        pred_valid = torch.roll(kf_valid, 1)
        oldest = (new_slot + 1) % K
        info_sqrt = (_info_sqrt(cfg, kf_rel, kf_poses, kf_rel_info)
                     if cfg.odo_info_weighted else None)
        odo = OdoFactors(
            rel=kf_rel,
            mask=kf_rel_valid & kf_valid & pred_valid & (slots_all != oldest),
            w_t=torch.tensor(1.0 / cfg.odo_sigma_t, dtype=dt, device=dev),
            w_r=torch.tensor(1.0 / cfg.odo_sigma_r, dtype=dt, device=dev),
            info_sqrt=info_sqrt)

    # ---- the BA, always run; do_ba selects its result below ----
    poses, lms = prob.poses, prob.landmarks
    if cfg.ba_mode in ("structure", "hybrid"):
        # structure phase: all poses fixed, refine the map only
        n_s = cfg.ba_struct_iters if cfg.ba_mode == "hybrid" else cfg.ba_iters
        _, lms, (es, es0) = ba_solve(
            prob._replace(fixed_pose_mask=torch.ones((K,), dtype=torch.bool, device=dev)),
            num_iters=n_s, huber_delta=cfg.huber_px, lm_step_clip=cfg.ba_lm_step_clip,
            per_landmark_accept=True, damp_min=1e-5, lm_eig_floor=cfg.ba_lm_eig_floor)
        if cfg.ba_debug:
            print(f"BA kf={state.frame_idx} struct {float(es0):.5f} -> {float(es):.5f}")
    if cfg.ba_mode in ("full", "hybrid"):
        # joint phase, odometry priors fused.  It starts from the RAW
        # window landmarks (docs/parity.md deviation 9); a motion-only
        # polish starts from the refined ones.
        mo = cfg.ba_mode == "hybrid" and cfg.ba_joint_motion_only
        joint_prob = prob._replace(landmarks=lms) if mo else prob
        if cfg.ba_mode == "hybrid" and not mo and cfg.polish_joint_turnover >= 0.0:
            # turnover routing: a MATURE map keeps the refined landmarks
            # and polishes motion-only against them; a YOUNG map runs
            # joint-from-raw.  `mo` becomes a device-side gate.
            turnover = tri.n_seeded.to(lms.dtype) / torch.clamp(
                torch.sum(lm_valid).to(lms.dtype), min=1.0)
            mo = turnover <= cfg.polish_joint_turnover
            joint_prob = prob._replace(landmarks=torch.where(mo, lms, prob.landmarks))
        poses_j, lms_j, (ej, ej0) = ba_solve(
            joint_prob, num_iters=cfg.ba_iters, huber_delta=cfg.huber_px,
            lm_step_clip=cfg.ba_lm_step_clip, per_landmark_accept=False,
            damp_min=1e-5, lm_eig_floor=cfg.ba_lm_eig_floor, odo=odo, motion_only=mo)
        if cfg.ba_mode == "hybrid":
            # observability gate (polish_max_parallax_deg)
            poses = torch.where(polish_on, poses_j, poses)
            lms = torch.where(polish_on, lms_j, lms)
        else:
            poses, lms = poses_j, lms_j
        if cfg.ba_debug:
            print(f"BA kf={state.frame_idx} joint {float(ej0):.5f} -> {float(ej):.5f} "
                  f"dpose={float((poses - prob.poses).abs().max()):.2e}")

    kf_poses = torch.where(do_ba, poses, kf_poses)
    landmarks = torch.where(do_ba, lms, landmarks)
    cur_pose = kf_poses[new_slot]
    # post-BA sanity: a landmark behind the newest camera is retired
    z_cur = pose_ops.transform_points(lie.se3_exp(cur_pose), landmarks)[..., 2]
    lm_valid = lm_valid & (z_cur > 0.01)

    return state._replace(
        landmarks=landmarks, lm_valid=lm_valid, lm_fail=lm_fail,
        kf_poses=kf_poses, kf_valid=kf_valid, kf_valid_host=kf_valid_host,
        kf_obs=kf_obs, kf_obs_mask=kf_obs_mask, kf_pyr=kf_pyr,
        kf_rel=kf_rel, kf_rel_valid=kf_rel_valid, kf_rel_info=kf_rel_info,
        kf_ptr=new_slot, cur_pose=cur_pose)


def _promote(state: VOState, pyr: Pyramid, p_new, cam: CameraPyramid,
             cfg: VOConfig, rel_info=None) -> VOState:
    """Keyframe promotion: measured re-observation of the map, corner
    triangulation into free slots, ring eviction, windowed BA."""
    ro = _promote_reobserve(state, pyr, p_new, cam, cfg)
    tri = _promote_triangulate(state, pyr, p_new, cam, cfg, ro)
    return _promote_commit(state, pyr, p_new, cam, cfg, tri, rel_info=rel_info)


def _track_step(state: VOState, img, cam: CameraPyramid, cfg: VOConfig):
    """One non-keyframe frame: pyramid + track."""
    pyr = build_pyramid(img, cfg.tracker.num_levels, cfg.tracker.psz)
    p_new = _track_frame(state, pyr, cam, cfg.tracker)
    return state._replace(cur_pose=p_new, frame_idx=state.frame_idx + 1), p_new


def _keyframe_step(state: VOState, img, cam: CameraPyramid, cfg: VOConfig):
    """One keyframe frame: pyramid + track + promote + BA."""
    pyr = build_pyramid(img, cfg.tracker.num_levels, cfg.tracker.psz)
    if cfg.odo_info_weighted:
        p_new, rel_info = _track_frame(state, pyr, cam, cfg.tracker, want_info=True,
                                       px_sigma=cfg.odo_info_px_sigma)
    else:
        p_new, rel_info = _track_frame(state, pyr, cam, cfg.tracker), None
    state = _promote(state, pyr, p_new, cam, cfg, rel_info=rel_info)
    state = state._replace(frame_idx=state.frame_idx + 1)
    return state, state.cur_pose


def _promote_step(state: VOState, img, pose, cam: CameraPyramid, cfg: VOConfig):
    """Promote a frame with an externally given pose (bootstrap path)."""
    pyr = build_pyramid(img, cfg.tracker.num_levels, cfg.tracker.psz)
    state = _promote(state, pyr, pose, cam, cfg)
    state = state._replace(frame_idx=state.frame_idx + 1)
    return state, state.cur_pose


def _run_periods(state: VOState, frames, cam: CameraPyramid, cfg: VOConfig):
    """Keyframe periods in turn: frames (P, stride, H, W), index 0 of each
    period the keyframe frame -> (state, (P * stride, 6) poses)."""
    ps = []
    for imgs in frames:
        state, p0 = _keyframe_step(state, imgs[0], cam, cfg)
        ps.append(p0)
        for j in range(1, cfg.keyframe_stride):
            state, pj = _track_step(state, imgs[j], cam, cfg)
            ps.append(pj)
    return state, torch.stack(ps)


def _fill_slots(landmarks, lm_valid, candidates, cand_valid):
    """Scatter valid candidates into free landmark slots (prefix-sum slot
    assignment, as in the track table).

    Returns (landmarks, lm_valid, seeded (L,) bool, take (L,) int32, the
    candidate index written into each seeded slot, -1 elsewhere).  The
    JAX module's out-of-range scatter (``mode="drop"``) is a scatter into
    ``max(L, C) + 1`` entries of which only the first L are read.
    """
    L = landmarks.shape[0]
    C = candidates.shape[0]
    dev = landmarks.device
    free = ~lm_valid
    slot_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    cand_rank = torch.cumsum(cand_valid.to(torch.int32), 0) - 1
    n = max(L, C) + 1
    scatter_idx = torch.where(cand_valid, cand_rank, n - 1).long()
    cand_for_rank = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cand_for_rank = cand_for_rank.scatter(0, scatter_idx,
                                          torch.arange(C, dtype=torch.int32, device=dev))
    take = cand_for_rank[torch.clamp(slot_rank, 0, L - 1).long()]
    seeded = free & (take >= 0)
    take = torch.where(seeded, take, torch.full_like(take, -1))
    seed_X = candidates[torch.clamp(take, 0, C - 1).long()]
    landmarks = torch.where(seeded[:, None], seed_X.to(landmarks.dtype), landmarks)
    return landmarks, lm_valid | seeded, seeded, take


def make_empty_state(cfg: VOConfig, wh, dtype=torch.float32, device=None) -> VOState:
    """A zeroed fixed-shape VOState for image size ``wh`` = (W, H), on the
    card unless ``device`` says otherwise."""
    dev = resolve(device)
    L = cfg.max_landmarks
    K = cfg.window
    cfgt = cfg.tracker
    zero_img = torch.zeros((int(wh[1]), int(wh[0])), dtype=dtype, device=dev)
    pyr0 = build_pyramid(zero_img, cfgt.num_levels, cfgt.psz)
    kf_pyr = tuple(PyramidLevel(*(torch.zeros((K,) + a.shape, dtype=a.dtype, device=dev)
                                  for a in lvl)) for lvl in pyr0)
    return VOState(
        landmarks=torch.zeros((L, 3), dtype=dtype, device=dev),
        lm_valid=torch.zeros((L,), dtype=torch.bool, device=dev),
        lm_fail=torch.zeros((L,), dtype=torch.int32, device=dev),
        kf_poses=torch.zeros((K, 6), dtype=dtype, device=dev),
        kf_valid=torch.zeros((K,), dtype=torch.bool, device=dev),
        kf_obs=torch.zeros((K, L, 2), dtype=dtype, device=dev),
        kf_obs_mask=torch.zeros((K, L), dtype=torch.bool, device=dev),
        kf_rel=torch.eye(3, 4, dtype=dtype, device=dev).repeat(K, 1, 1),
        kf_rel_valid=torch.zeros((K,), dtype=torch.bool, device=dev),
        kf_rel_info=torch.zeros((K, 6, 6), dtype=dtype, device=dev),
        kf_pyr=kf_pyr,
        kf_ptr=0,
        cur_pose=torch.zeros((6,), dtype=dtype, device=dev),
        frame_idx=0,
        kf_valid_host=(False,) * K,
    )


# ---------------------------------------------------------------------------


class VisualOdometry:
    """Stateful host facade: one eager device step per frame, or a loop
    of them per chunk (:meth:`run_frames`).  Runs on the card unless
    ``device`` says otherwise; frames may be numpy arrays or tensors."""

    def __init__(self, cam: CameraPyramid, fc, cc, cfg: VOConfig | None = None,
                 dtype=torch.float32, device=None):
        self.cfg = cfg or VOConfig()
        _raise_multi_device(self.cfg)
        self.device = resolve(device)
        self.cam = cam.to(self.device)
        self.fc = fc
        self.cc = cc
        self.dtype = dtype
        self.state: Optional[VOState] = None
        self.trajectory: list[np.ndarray] = []
        self._frame_idx = 0  # host mirror for the keyframe cadence

    # ---------- state views ----------

    @property
    def landmarks(self):
        return self.state.landmarks

    @property
    def lm_valid(self):
        return self.state.lm_valid

    @property
    def kf_poses(self):
        return self.state.kf_poses

    @property
    def kf_valid(self):
        return np.asarray(self.state.kf_valid_host)

    @property
    def kf_obs(self):
        return self.state.kf_obs

    @property
    def kf_obs_mask(self):
        return self.state.kf_obs_mask

    @property
    def cur_pose(self):
        return self.state.cur_pose

    @property
    def frame_idx(self) -> int:
        return self._frame_idx

    @property
    def _last_kf_slot(self) -> int:
        return self.state.kf_ptr

    # ---------- internals ----------

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device).to(self.dtype)

    def _pyr(self, img) -> Pyramid:
        cfgt = self.cfg.tracker
        return build_pyramid(self._tensor(img), cfgt.num_levels, cfgt.psz)

    def _append_centers(self, poses: torch.Tensor) -> None:
        """One pull of the camera centres of a (..., 6) pose or chunk."""
        cs = _camera_centers(poses).cpu().numpy().reshape(-1, 3)
        self.trajectory.extend(list(cs))

    # ---------- public API ----------

    def bootstrap_from_images(self, img0, img1, generator: torch.Generator | None = None,
                              scale: float = 1.0, num_matches: int = 512):
        """GT-free initialisation: corners + fb-LK matches -> essential
        matrix -> relative pose + triangulated seeds (``sfm/twoview.py``).
        The 256 eight-point samples come from ``generator``, a CPU
        ``torch.Generator`` (seeded with 0 when None).  Monocular scale
        is ``scale`` * unit baseline; seed observations are the measured
        match positions.  Returns the number of seed landmarks."""
        from invcompcamtrack_torch.sfm.epipolar import sample_indices
        from invcompcamtrack_torch.sfm.twoview import initialize_two_view

        cfgt = self.cfg.tracker
        pyr0, pyr1 = self._pyr(img0), self._pyr(img1)
        psz = cfgt.psz
        xy0, cvalid = shi_tomasi_corners(pyr0[0].img[psz:-psz, psz:-psz],
                                         max_corners=num_matches, border=psz)
        xy1, ok = lk_forward_backward(pyr0, pyr1, xy0, psz=self.cfg.lk_psz,
                                      num_levels=cfgt.num_levels)
        fc = torch.tensor(self.fc, dtype=self.dtype, device=self.device)
        cc = torch.tensor(self.cc, dtype=self.dtype, device=self.device)
        idx = sample_indices(xy0.shape[0], 256, generator=generator)
        res = initialize_two_view(idx, (xy0 - cc) / fc, (xy1 - cc) / fc, cvalid & ok)
        G1 = lie.se3_exp(res.pose1)
        c1 = lie.camera_center(G1) * scale
        t1 = -lie.matvec(G1[:, :3], c1)
        pose1 = lie.se3_log(torch.cat([G1[:, :3], t1[:, None]], dim=1))
        valid = res.valid.cpu().numpy()
        lms = res.landmarks.cpu().numpy()[valid] * scale
        self.bootstrap(img0, img1, np.zeros(6), pose1.cpu().numpy(), lms,
                       obs0=xy0.cpu().numpy()[valid])
        return int(valid.sum())

    def bootstrap(self, img0, img1, pose0, pose1, points3d, valid=None, obs0=None):
        """Initialise with two known poses and landmark seeds (from GT,
        stereo, or two-view SfM done by the caller).

        ``obs0`` optionally carries the measured pixel positions of the
        seeds in frame 0; without it their frame-0 observations are
        their reprojections.  Frame-1 observations are always measured
        (LK from frame 0).
        """
        L = self.cfg.max_landmarks
        pts = np.zeros((L, 3), np.float32)
        msk = np.zeros((L,), bool)
        n = min(len(points3d), L)
        pts[:n] = np.asarray(points3d)[:n]
        msk[:n] = True if valid is None else np.asarray(valid)[:n]

        img0_t = self._tensor(img0)
        state = make_empty_state(self.cfg, (img0_t.shape[-1], img0_t.shape[-2]),
                                 self.dtype, self.device)
        state = state._replace(landmarks=self._tensor(pts),
                               lm_valid=torch.as_tensor(msk, device=self.device))
        pose0 = self._tensor(pose0)
        pose1 = self._tensor(pose1)

        # ---- keyframe 0 (slot 0) ----
        fx, fy, cx, cy, swo, sho = self.cam.level(0)
        if obs0 is not None:
            uv0 = np.zeros((L, 2), np.float32)
            uv0[:n] = np.asarray(obs0)[:n]
            uv0 = self._tensor(uv0)
        else:
            uv0 = pose_ops.project_points(lie.se3_exp(pose0), state.landmarks,
                                          fx, fy, cx, cy)
            uv0 = torch.where(torch.isfinite(uv0), uv0, torch.full_like(uv0, -1.0))
        mask0 = state.lm_valid & pose_ops.in_frustum(uv0, swo, sho)
        state = state._replace(
            kf_poses=_row_set(state.kf_poses, 0, pose0),
            kf_valid=_row_set(state.kf_valid, 0, True),
            kf_valid_host=(True,) + (False,) * (self.cfg.window - 1),
            kf_obs=_row_set(state.kf_obs, 0, uv0),
            kf_obs_mask=_row_set(state.kf_obs_mask, 0, mask0),
            kf_pyr=_update_pyr(state.kf_pyr, 0, self._pyr(img0_t)),
            kf_ptr=0, cur_pose=pose0, frame_idx=1)
        self.state = state
        self._append_centers(pose0)

        # ---- keyframe 1: measured promote with the given pose ----
        self.state, _ = _promote_step(self.state, self._tensor(img1), pose1,
                                      self.cam, self.cfg)
        self._append_centers(self.state.cur_pose)
        self._frame_idx = 2

    def process_frame(self, img) -> np.ndarray:
        """Track one new frame; returns the (6,) pose estimate."""
        img = self._tensor(img)
        if self._frame_idx % self.cfg.keyframe_stride == 0:
            self.state, pose = _keyframe_step(self.state, img, self.cam, self.cfg)
        else:
            self.state, pose = _track_step(self.state, img, self.cam, self.cfg)
        self._frame_idx += 1
        self._append_centers(pose)
        return pose.cpu().numpy()

    def run_frames(self, images) -> np.ndarray:
        """Process a chunk of frames, keyframe period by keyframe period,
        with no host sync until the end.  ``images``: (T, H, W) with T a
        multiple of ``keyframe_stride``, the first frame a keyframe
        frame.  Returns the (T, 6) poses."""
        stride = self.cfg.keyframe_stride
        T = images.shape[0]
        if T % stride != 0:
            raise ValueError(f"chunk length {T} not a multiple of {stride}")
        if self._frame_idx % stride != 0:
            raise ValueError("chunk start must align with the keyframe cadence")
        frames = self._tensor(images).reshape(T // stride, stride, *images.shape[1:])
        self.state, poses = _run_periods(self.state, frames, self.cam, self.cfg)
        self._frame_idx += T
        self._append_centers(poses)
        return poses.cpu().numpy()
