"""The monocular visual-odometry engine (port of
``invcompcamtrack_tpu/vo/engine.py``): one stream (``VisualOdometry``)
or S streams advanced together (``VisualOdometryBatch``).

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

- **One body, a leading stream axis.**  The steps take a state whose
  tensors carry a leading axis of S independent streams, and S frames at
  a time: the counterpart of ``jax.vmap`` over the JAX steps (the JAX
  ``VisualOdometryBatch``).  One set of launches advances every stream:
  the gathers read stacks of per-stream planes (``ops/patch_gather.py``),
  and every reduction, gate and accept/reject is per stream.
  ``VisualOdometry`` runs the body at S = 1, and its ``state`` shows that
  stream with the JAX module's shapes (``stream_state``).
- **The keyframe ring.**  ``kf_ptr`` (the newest slot) and the ring's
  occupancy are host values (``VOState.kf_ptr``, ``kf_valid_host``),
  shared by the streams, whose cadence is one: the next slot is
  ``(kf_ptr + 1) % K`` and the founding partner slot (the oldest valid
  one) depends on the occupancy only, never on the data.  So slots are
  Python ints, and the pyramid stacks are slot-major, ``(K, S, H_s,
  W_s)``: one slot's S planes are a contiguous stack that the kernels
  read as it is, and promotion writes the new pyramids into their slot
  in place (the stacks, about 75 MB per stream at 1280x720, are never
  copied).  The write happens after every read of the step, so a step
  consumes the state it was given (its pyramid stacks) and returns the
  next one.
- **The BA gate** (``lax.cond`` in the JAX module) is a select: the
  window BA always runs and ``torch.where(do_ba, ...)`` keeps or drops
  its result per stream, as the JAX engine under ``vmap`` does.
- ``lax.top_k`` is ``torch.topk``; the ``vmap``s over the K poses are
  batched ``se3_exp``; ``jax.jacfwd`` is ``torch.func.jacfwd`` (under
  ``torch.func.vmap`` for the information-weighted priors);
  ``jnp.linalg.cholesky`` is ``torch.linalg.cholesky_ex`` with a failed
  factor set to NaN, which takes the same isotropic fallback.
- ``run_frames`` loops over keyframe periods where the JAX module scans,
  and pulls the chunk's poses back to the host once.

Kernels on this path: the tracker's K1 and K2 (``solver/icgn.py``), the
sparse LK's K6 and K7 (``match/lk.py``) and, with
``odo_info_weighted=True``, K5 (``image/patch.py::extract_patches``); K1,
K5, K6 and K7 read the S streams' planes as one stack.

The multi-device window BA: with ``VOConfig.ba_mesh`` (a ``DeviceMesh``)
the window BA runs landmark-sharded over its ``ba_mesh_axis``
(``ba/distributed.py``), with ``ba_temporal_mesh`` the joint phase runs
keyframe-sharded over its ``ba_temporal_axis`` (``ba/temporal.py``).
Every rank of the world runs the whole engine on the same frames; only
the BA inside it is sharded, and its all-reduced results leave every
rank with the same state, so the ranks take the same host decisions.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from invcompcamtrack_torch.ba.distributed import ba_solve_sharded
from invcompcamtrack_torch.ba.temporal import TemporalBAProblem, temporal_ba_solve
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
from invcompcamtrack_torch.parallel.comm import axis_size
from invcompcamtrack_torch.sfm.triangulate import triangulate_dlt, triangulate_gn
from invcompcamtrack_torch.solver.icgn import cam_level_padding, track_pose


@dataclasses.dataclass
class VOConfig:
    """The JAX module's ``VOConfig``: same fields and defaults (see there
    for the measurements behind each default).  Its meshes are
    ``torch.distributed.device_mesh.DeviceMesh``es here."""

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
    ba_mesh: object = None       # DeviceMesh: run the window BA landmark-
    #   sharded over `ba_mesh_axis` (ba/distributed.py, the same ba_solve);
    #   max_landmarks must divide evenly
    ba_mesh_axis: str = "model"
    ba_temporal_mesh: object = None  # DeviceMesh: run the JOINT window-BA
    #   phase keyframe-sharded over `ba_temporal_axis` (ba/temporal.py);
    #   `window` must divide evenly.  The chain uses the isotropic
    #   odo_sigma_t/odo_sigma_r weights: odo_info_weighted is ignored on
    #   this path (warned at engine construction)
    ba_temporal_axis: str = "seq"
    ba_temporal_cg_iters: int = 48  # PCG iterations on the distributed
    #                                 reduced camera system per LM step


class VOState(NamedTuple):
    """Full engine state: fixed-shape device tensors and the ring's host
    mirror.  In the engine's steps every tensor has a leading axis of S
    streams, after the slot axis for the pyramid stacks; a state of one
    stream (``stream_state``, ``VisualOdometry.state``) has none, the
    JAX module's shapes, given here."""

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
    kf_pyr: Tuple[PyramidLevel, ...]  # per level: fields (K, H_s, W_s); in the
    #                                   steps (K, S, H_s, W_s), slot-major
    kf_ptr: int                # newest keyframe slot (host)
    cur_pose: torch.Tensor     # (6,)
    frame_idx: int             # (host)
    kf_valid_host: Tuple[bool, ...]  # host mirror of kf_valid


def _check_meshes(cfg: VOConfig) -> None:
    """The BA meshes are DeviceMeshes, and the sharded axes divide the
    landmark table and the window."""
    for name, axis, n_rows in (("ba_mesh", cfg.ba_mesh_axis, cfg.max_landmarks),
                               ("ba_temporal_mesh", cfg.ba_temporal_axis, cfg.window)):
        mesh = getattr(cfg, name)
        if mesh is None:
            continue
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"VOConfig.{name} must be a torch DeviceMesh, "
                            f"got {type(mesh).__name__}")
        n = axis_size(mesh, axis)
        if n_rows % n != 0:
            raise ValueError(f"VOConfig.{name}: {n_rows} rows not divisible by "
                             f"{axis} axis size {n}")


# ---------------------------------------------------------------------------
# state helpers: the stream axis and the pyramid ring

_HOST = ("kf_ptr", "frame_idx", "kf_valid_host")


def _stream_dim(field: str) -> int:
    return 1 if field == "kf_pyr" else 0


def _map_state(fn, state: VOState) -> VOState:
    """fn(tensor, stream axis) on every device tensor of ``state``."""
    out = {}
    for k, v in state._asdict().items():
        if k in _HOST:
            out[k] = v
        elif k == "kf_pyr":
            out[k] = tuple(PyramidLevel(*(fn(a, 1) for a in lvl)) for lvl in v)
        else:
            out[k] = fn(v, 0)
    return VOState(**out)


def stream_state(states: VOState, s: int) -> VOState:
    """Stream s of a state with a stream axis, as views with the JAX
    module's shapes."""
    return _map_state(lambda a, d: a.select(d, s), states)


def with_stream_axis(state: VOState) -> VOState:
    """A one-stream state (the JAX module's shapes) as the steps take it:
    views with a stream axis of 1."""
    return _map_state(lambda a, d: a.unsqueeze(d), state)


def stack_states(states) -> VOState:
    """States with a stream axis, one after the other along it, copied
    (a step writes its ring in place).  Their host mirrors must agree:
    the streams share one keyframe cadence."""
    first = states[0]
    for st in states[1:]:
        if any(getattr(st, k) != getattr(first, k) for k in _HOST):
            raise ValueError(
                "the streams' keyframe rings differ (kf_ptr, frame_idx, "
                "kf_valid_host): they must share one keyframe cadence")
    out = {}
    for k in first._fields:
        if k in _HOST:
            out[k] = getattr(first, k)
        elif k == "kf_pyr":
            out[k] = tuple(
                PyramidLevel(*(torch.cat(parts, dim=1) for parts in zip(*lvls)))
                for lvls in zip(*(st.kf_pyr for st in states)))
        else:
            out[k] = torch.cat([getattr(st, k) for st in states], dim=0)
    return VOState(**out)


def _index_pyr(kf_pyr, slot: int) -> Pyramid:
    """One slot's pyramids: per level the (S, H, W) stack, a contiguous
    view into the (K, S, ...) ring."""
    return tuple(PyramidLevel(*(a[slot] for a in lvl)) for lvl in kf_pyr)


def _update_pyr(kf_pyr, slot: int, pyr: Pyramid):
    """Write the streams' pyramids into slot of the (K, S, ...) stacks,
    in place."""
    for stack, lvl in zip(kf_pyr, pyr):
        for a, b in zip(stack, lvl):
            a[slot].copy_(b)
    return kf_pyr


def _row_set(arr: torch.Tensor, slot: int, row) -> torch.Tensor:
    """arr (S, K, ...) with every stream's slot row set."""
    out = arr.clone()
    out[:, slot] = row
    return out


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (..., C, D) at row indices idx (..., n) -> (..., n, D)."""
    return torch.gather(a, -2, idx.long()[..., None].expand(idx.shape + a.shape[-1:]))


def _camera_centers(poses: torch.Tensor) -> torch.Tensor:
    return lie.camera_center(lie.se3_exp(poses))


# ---------------------------------------------------------------------------
# device steps (every tensor with a leading stream axis S)


def _track_frame(state: VOState, pyr: Pyramid, cam: CameraPyramid,
                 cfgt: ICGNParams, want_info: bool = False,
                 px_sigma: float = 0.3):
    """IC-GN track the new frames against the newest keyframe's map (the
    init pose is the reference image's pose, reference:
    odometer.cpp:241-255) -> (S, 6).

    With ``want_info``, also returns the tracker's (S, 6, 6) Fisher
    information: the finest-scale GN Hessian divided by the photometric
    residual variance at the final pose, scaled by ``px_sigma^2`` into
    the BA's unit-noise-pixel convention.
    """
    fx, fy, cx, cy, swo, sho = cam.level(0)
    ref_pyr = _index_pyr(state.kf_pyr, state.kf_ptr)
    pose_ref = state.kf_poses[:, state.kf_ptr]
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
    cnt = torch.clamp(torch.sum(ok, dim=-1) * (cfgt.psz * cfgt.psz), min=1)
    sigma2_img = torch.sum(d * d, dim=(-3, -2, -1)) / cnt
    # floor: exact synthetic renders can converge to ~0 residual; 1e-4 of
    # the image's dynamic range squared keeps the information finite
    rng_img = torch.clamp(torch.amax(torch.abs(ref_pyr[0].img), dim=(-2, -1)), min=1.0)
    sigma2_img = torch.maximum(sigma2_img, (1e-4 * rng_img) ** 2)
    info = aux.hessian * (px_sigma ** 2) / sigma2_img[..., None, None]
    info = torch.where(torch.isfinite(info), info, torch.zeros_like(info))
    return p_new, info


class _ReobsOut(NamedTuple):
    """Stage boundary: re-observation results (promote part 1)."""

    xy_meas: torch.Tensor   # (S, L, 2) measured LK positions in the new kf
    reobs: torch.Tensor     # (S, L) bool: landmark successfully re-observed
    lm_fail: torch.Tensor   # (S, L) int32 updated failure counters
    lm_valid: torch.Tensor  # (S, L) bool after lifecycle retirement


class _TriOut(NamedTuple):
    """Stage boundary: triangulation results (promote part 2)."""

    landmarks: torch.Tensor     # (S, L, 3) with new seeds scattered in
    lm_valid: torch.Tensor      # (S, L) bool
    lm_fail: torch.Tensor       # (S, L) int32
    old_slot: int               # founding partner keyframe slot (host)
    old_obs: torch.Tensor       # (S, L, 2) partner row incl. founding obs
    old_obs_mask: torch.Tensor  # (S, L)
    new_obs: torch.Tensor       # (S, L, 2) new keyframe's observation row
    new_obs_mask: torch.Tensor  # (S, L)
    n_seeded: torch.Tensor      # (S,) int32: landmarks newly triangulated


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
    G_prev = lie.se3_exp(state.kf_poses[:, prev])
    G_new = lie.se3_exp(p_new)

    proj_prev = pose_ops.project_points(G_prev, state.landmarks, fx, fy, cx, cy)
    proj_new = pose_ops.project_points(G_new, state.landmarks, fx, fy, cx, cy)
    proj_prev = torch.where(torch.isfinite(proj_prev), proj_prev, torch.zeros_like(proj_prev))
    proj_new_s = torch.where(torch.isfinite(proj_new), proj_new, torch.zeros_like(proj_new))
    start = torch.where(state.kf_obs_mask[:, prev][..., None], state.kf_obs[:, prev],
                        proj_prev)
    xy_meas, lk_ok = lk_forward_backward(prev_pyr, pyr, start, init_xy=proj_new_s,
                                         psz=cfg.lk_psz, num_levels=cfgt.num_levels)
    vis_new = (pose_ops.in_frustum(proj_new_s, swo, sho)
               & torch.all(torch.isfinite(proj_new), dim=-1))
    reproj_ok = torch.linalg.norm(xy_meas - proj_new_s, dim=-1) < cfg.reobs_gate_px
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
    G_old = lie.se3_exp(state.kf_poses[:, old_slot])

    psz = cfgt.psz
    xy0, cvalid = shi_tomasi_corners(old_pyr[0].img[..., psz:-psz, psz:-psz],
                                     max_corners=cfg.corners_per_kf, border=psz)
    xy1, lk_okc = lk_forward_backward(old_pyr, pyr, xy0, psz=cfg.lk_psz,
                                      num_levels=cfgt.num_levels)
    parallax = torch.linalg.norm(xy1 - xy0, dim=-1)
    good = cvalid & lk_okc & (parallax > cfg.min_parallax_px)

    c_old = lie.camera_center(G_old)
    c_new = lie.camera_center(G_new)
    P0 = pose_ops.projection_matrix(fc2, cc2, G_old[..., :3], c_old)
    P1 = pose_ops.projection_matrix(fc2, cc2, G_new[..., :3], c_new)
    lead, C = xy0.shape[:-2], xy0.shape[-2]
    P = torch.stack([P0, P1], dim=-3)[..., None, :, :, :].expand(lead + (C, 2, 3, 4))
    obs2 = torch.stack([xy0, xy1], dim=-2)
    X_new, _ = triangulate_dlt(P, obs2, R0=G_old[..., None, :, :3], c0=c_old[..., None, :])
    X_new, _ = triangulate_gn(P, obs2, torch.nan_to_num(X_new), num_iters=3)
    depth_ok = ((pose_ops.transform_points(G_new, X_new)[..., 2] > 0.05)
                & (pose_ops.transform_points(G_old, X_new)[..., 2] > 0.05)
                & torch.all(torch.isfinite(X_new), dim=-1))
    # ray-angle gate: depth is only observable with enough baseline
    r0 = X_new - c_old[..., None, :]
    r1 = X_new - c_new[..., None, :]
    cosang = torch.sum(r0 * r1, dim=-1) / torch.clamp(
        torch.linalg.norm(r0, dim=-1) * torch.linalg.norm(r1, dim=-1), min=1e-12)
    ang_ok = cosang < math.cos(math.radians(cfg.min_tri_angle_deg))
    good = good & depth_ok & ang_ok

    landmarks, lm_valid, seeded, take = _fill_slots(state.landmarks, ro.lm_valid,
                                                    X_new, good)
    lm_fail = torch.where(seeded, torch.zeros_like(ro.lm_fail), ro.lm_fail)

    # seeded slots get their two MEASURED founding observations
    take_c = torch.clamp(take, 0, C - 1)
    old_obs = torch.where(seeded[..., None], _take_rows(xy0, take_c),
                          state.kf_obs[:, old_slot])
    old_obs_mask = state.kf_obs_mask[:, old_slot] | seeded
    new_obs = torch.where(seeded[..., None], _take_rows(xy1, take_c), ro.xy_meas)
    new_obs_mask = ro.reobs | seeded
    return _TriOut(landmarks=landmarks, lm_valid=lm_valid, lm_fail=lm_fail,
                   old_slot=old_slot, old_obs=old_obs, old_obs_mask=old_obs_mask,
                   new_obs=new_obs, new_obs_mask=new_obs_mask,
                   n_seeded=torch.sum(seeded, dim=-1).to(torch.int32))


def _info_sqrt(cfg: VOConfig, kf_rel, kf_poses, kf_rel_info) -> torch.Tensor:
    """(..., K, 6, 6) square roots S (W = S^T S) of each odometry factor's
    information in the residual coordinates: the isotropic prior plus the
    tracker's measured information mapped through the inverse residual
    Jacobian A = dr_u/dp_k, W_r = A^-T W_p A^-1 (the JAX module's
    ``_fsqrt``, batched over the factors and the streams)."""
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

    jac = torch.func.jacfwd(r_of_pk)
    for _ in range(kf_poses.dim() - 1):
        jac = torch.func.vmap(jac)
    A = jac(kf_poses, kf_rel, torch.roll(kf_poses, 1, dims=-2)).to(dt)   # (...,K,6,6)
    Ainv = torch.linalg.solve_ex(A + 1e-8 * I6, I6.expand_as(A), check_errors=False)[0]
    Wp_s = 0.5 * (kf_rel_info + kf_rel_info.transpose(-1, -2))
    W_r = Ainv.transpose(-1, -2) @ Wp_s @ Ainv
    W_r = 0.5 * (W_r + W_r.transpose(-1, -2))
    # the isotropic term is the correlated-error floor; the photometric
    # term adds stiffness along the well-measured axes
    tr_p = torch.diagonal(Wp_s, dim1=-2, dim2=-1).sum(-1)
    W = W_iso + torch.where((tr_p > 0)[..., None, None], W_r, torch.zeros_like(W_r))
    ridge = 1e-6 * torch.diagonal(W, dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-12
    Lc, info = torch.linalg.cholesky_ex(W + ridge[..., None, None] * I6, check_errors=False)
    # a failed factor is NaN (as jnp.linalg.cholesky's), which takes the
    # isotropic fallback below
    Lc = torch.where((info == 0)[..., None, None], Lc, torch.full_like(Lc, float("nan")))
    S = Lc.transpose(-1, -2)
    finite = torch.isfinite(S).flatten(-2).all(-1)
    return torch.where(finite[..., None, None], S, torch.sqrt(W_iso).expand_as(S))


def _joint_ba_temporal(cfg: VOConfig, prob: BAProblem, kf_rel, kf_rel_valid, kf_valid,
                       new_slot: int, motion_only):
    """The engine's joint window-BA phase on the keyframe-sharded temporal
    solver (``ba/temporal.py``), each stream in turn.

    The ring window is rolled to chronological order (oldest keyframe at
    row 0), so ring-adjacent odometry measurements become array-adjacent
    chain factors.  The measured relative group ``rel_{k->k+1}`` is
    linearised into the chain's coefficient-space convention at the
    current pose, ``odom[k] = log(rel_{k->k+1} exp(p_k)) - p_k``, with
    the weights 1/odo_sigma_t^2 and 1/odo_sigma_r^2 per coefficient.
    """
    S = prob.poses.shape[0]
    K = prob.poses.shape[-2]
    shift = -(new_slot + 1)
    dt, dev = prob.poses.dtype, prob.poses.device

    def roll(a, dim):
        return torch.roll(a, shift, dims=dim)

    poses_c, obs_c, mask_c = roll(prob.poses, -2), roll(prob.obs, -3), roll(prob.mask, -2)
    fixed_c = roll(prob.fixed_pose_mask, -1)
    rel_c, relv_c, kfv_c = roll(kf_rel, -3), roll(kf_rel_valid, -1), roll(kf_valid, -1)

    # chain factor k couples chronological rows k -> k+1; its measured
    # relative group lives at rolled row k+1
    rel_next = torch.roll(rel_c, -1, dims=-3)
    odom = lie.se3_log(lie.se3_compose(rel_next, lie.se3_exp(poses_c))) - poses_c
    f_valid = (torch.roll(relv_c, -1, dims=-1) & kfv_c & torch.roll(kfv_c, -1, dims=-1)
               & (torch.arange(K, device=dev) < K - 1))
    w6 = torch.cat([torch.full((3,), (1.0 / cfg.odo_sigma_t) ** 2, dtype=dt, device=dev),
                    torch.full((3,), (1.0 / cfg.odo_sigma_r) ** 2, dtype=dt, device=dev)])
    w = torch.where(f_valid[..., None], w6, torch.zeros_like(w6))
    if not cfg.odo_prior:
        w = torch.zeros_like(w)

    out = []
    for s in range(S):
        tprob = TemporalBAProblem(
            poses=poses_c[s], landmarks=prob.landmarks[s], obs=obs_c[s], mask=mask_c[s],
            fx=prob.fx, fy=prob.fy, cx=prob.cx, cy=prob.cy, fixed_pose_mask=fixed_c[s],
            odom=odom[s], odom_weight=w[s])
        mo = motion_only if isinstance(motion_only, bool) else motion_only[s]
        out.append(temporal_ba_solve(
            tprob, cfg.ba_temporal_mesh, axis=cfg.ba_temporal_axis, num_iters=cfg.ba_iters,
            huber_delta=cfg.huber_px, cg_iters=cfg.ba_temporal_cg_iters, motion_only=mo))
    p_c = torch.stack([o[0] for o in out])
    lms = torch.stack([o[1] for o in out])
    e, e0 = (torch.stack([o[2][i] for o in out]) for i in (0, 1))
    return torch.roll(p_c, new_slot + 1, dims=-2), lms, (e, e0)


def _promote_commit(state: VOState, pyr: Pyramid, p_new,
                    cam: CameraPyramid, cfg: VOConfig,
                    tri: _TriOut, rel_info=None) -> VOState:
    """Promote parts 3-4: ring write, gross-outlier gating, windowed BA,
    post-BA retirement."""
    K = cfg.window
    fx, fy, cx, cy, _, _ = cam.level(0)
    prev = state.kf_ptr
    new_slot = (prev + 1) % K
    dt, dev = p_new.dtype, p_new.device
    G_prev = lie.se3_exp(state.kf_poses[:, prev])
    G_new = lie.se3_exp(p_new)
    slots_all = torch.arange(K, device=dev)
    landmarks, lm_valid, lm_fail = tri.landmarks, tri.lm_valid, tri.lm_fail
    old_slot = tri.old_slot

    # ---- (3) ring write: evict new_slot, record the keyframe ----
    kf_obs = _row_set(state.kf_obs, old_slot, tri.old_obs)
    kf_obs[:, new_slot] = tri.new_obs
    kf_obs_mask = _row_set(state.kf_obs_mask, old_slot, tri.old_obs_mask)
    kf_obs_mask[:, new_slot] = tri.new_obs_mask
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
    observed_any = torch.any(kf_obs_mask & kf_valid[..., None], dim=-2)
    lm_valid = lm_valid & observed_any

    # ---- (4) windowed BA on the measured observation grid ----
    if cfg.ba_mode == "structure":
        fixed = torch.ones_like(kf_valid)
    else:
        # the two OLDEST valid keyframes anchor the window; every newer
        # pose floats (invalid slots count as fixed)
        ages = torch.where(kf_valid, (new_slot - slots_all) % K, -1)
        oldest2 = torch.topk(ages, 2, dim=-1)[0][..., -1:]
        fixed = (~kf_valid) | (ages >= oldest2)
    mask = kf_obs_mask & kf_valid[..., None] & lm_valid[..., None, :]
    prob = BAProblem(poses=kf_poses, landmarks=landmarks, obs=kf_obs, mask=mask,
                     fx=fx, fy=fy, cx=cx, cy=cy, fixed_pose_mask=fixed)
    # hard residual gate: a measurement grossly inconsistent with the
    # current state is a correspondence failure; it leaves the window
    res0, _ = ba_residuals(prob)
    obs_ok = torch.linalg.norm(res0, dim=-1) < cfg.ba_obs_gate_px
    kf_obs_mask = kf_obs_mask & (obs_ok | ~mask)
    mask = mask & obs_ok
    prob = prob._replace(mask=mask)
    do_ba = ((torch.sum(kf_valid, dim=-1) >= cfg.min_kf_for_ba)
             & (torch.sum(lm_valid, dim=-1) >= cfg.min_lm_for_ba))

    # observability statistic of the polish gate: the live map's mean
    # triangulation angle between the partner and the new keyframe
    c_old_g = lie.camera_center(lie.se3_exp(kf_poses[:, old_slot]))
    c_new_g = lie.camera_center(G_new)
    r0g = landmarks - c_old_g[..., None, :]
    r1g = landmarks - c_new_g[..., None, :]
    cosg = torch.sum(r0g * r1g, dim=-1) / torch.clamp(
        torch.linalg.norm(r0g, dim=-1) * torch.linalg.norm(r1g, dim=-1), min=1e-12)
    ang = torch.arccos(torch.clamp(cosg, -1.0, 1.0))
    mean_parallax = (torch.sum(torch.where(lm_valid, ang, torch.zeros_like(ang)), dim=-1)
                     / torch.clamp(torch.sum(lm_valid, dim=-1), min=1))
    # motion-direction statistic of the forwardness gate: the window's
    # displacement-weighted translation fraction along the optical axis
    G_k = lie.se3_exp(kf_poses)
    kf_centers = lie.camera_center(G_k)                              # (S, K, 3)
    dc = kf_centers - torch.roll(kf_centers, 1, dims=-2)
    dc_cam = lie.matvec(G_k[..., :3], dc)
    step_len = torch.linalg.norm(dc, dim=-1)
    f_ok = (kf_valid & torch.roll(kf_valid, 1, dims=-1) & (slots_all != (new_slot + 1) % K))
    wsum = torch.sum(torch.where(f_ok, step_len, torch.zeros_like(step_len)), dim=-1)
    forwardness = torch.sum(torch.where(f_ok, torch.abs(dc_cam[..., 2]),
                                        torch.zeros_like(step_len)), dim=-1) / torch.clamp(
        wsum, min=1e-12)
    polish_on = ((mean_parallax < math.radians(cfg.polish_max_parallax_deg))
                 & (forwardness >= cfg.polish_min_forwardness))

    odo = None
    if cfg.ba_mode in ("full", "hybrid") and cfg.odo_prior:
        # factor k constrains ring slots (k-1)%K -> k; the wrap-around
        # factor into the OLDEST slot is stale and masked out
        pred_valid = torch.roll(kf_valid, 1, dims=-1)
        oldest = (new_slot + 1) % K
        info_sqrt = (_info_sqrt(cfg, kf_rel, kf_poses, kf_rel_info)
                     if cfg.odo_info_weighted else None)
        odo = OdoFactors(
            rel=kf_rel,
            mask=kf_rel_valid & kf_valid & pred_valid & (slots_all != oldest),
            w_t=torch.tensor(1.0 / cfg.odo_sigma_t, dtype=dt, device=dev),
            w_r=torch.tensor(1.0 / cfg.odo_sigma_r, dtype=dt, device=dev),
            info_sqrt=info_sqrt)

    if cfg.ba_mesh is not None:
        # landmark-sharded window BA over the configured mesh: the same
        # ba_solve with all-reduced pose reductions (ba/distributed.py);
        # everything else in the step runs alike on every rank
        def _ba(pr, **kw):
            return ba_solve_sharded(pr, cfg.ba_mesh, axis=cfg.ba_mesh_axis, **kw)
    else:
        _ba = ba_solve

    # ---- the BA, always run; do_ba selects its result below ----
    poses, lms = prob.poses, prob.landmarks
    if cfg.ba_mode in ("structure", "hybrid"):
        # structure phase: all poses fixed, refine the map only
        n_s = cfg.ba_struct_iters if cfg.ba_mode == "hybrid" else cfg.ba_iters
        _, lms, (es, es0) = _ba(
            prob._replace(fixed_pose_mask=torch.ones_like(kf_valid)),
            num_iters=n_s, huber_delta=cfg.huber_px, lm_step_clip=cfg.ba_lm_step_clip,
            per_landmark_accept=True, damp_min=1e-5, lm_eig_floor=cfg.ba_lm_eig_floor)
        if cfg.ba_debug:
            print(f"BA kf={state.frame_idx} struct {es0.tolist()} -> {es.tolist()}")
    if cfg.ba_mode in ("full", "hybrid"):
        # joint phase, odometry priors fused.  It starts from the RAW
        # window landmarks (docs/parity.md deviation 9); a motion-only
        # polish starts from the refined ones.
        mo = cfg.ba_mode == "hybrid" and cfg.ba_joint_motion_only
        joint_prob = prob._replace(landmarks=lms) if mo else prob
        if cfg.ba_mode == "hybrid" and not mo and cfg.polish_joint_turnover >= 0.0:
            # turnover routing: a MATURE map keeps the refined landmarks
            # and polishes motion-only against them; a YOUNG map runs
            # joint-from-raw.  `mo` becomes a device-side gate per stream.
            turnover = tri.n_seeded.to(lms.dtype) / torch.clamp(
                torch.sum(lm_valid, dim=-1).to(lms.dtype), min=1.0)
            mo = turnover <= cfg.polish_joint_turnover
            joint_prob = prob._replace(
                landmarks=torch.where(mo[..., None, None], lms, prob.landmarks))
        if cfg.ba_temporal_mesh is not None:
            # the long-window path: the keyframe-sharded solve
            poses_j, lms_j, (ej, ej0) = _joint_ba_temporal(
                cfg, joint_prob, kf_rel, kf_rel_valid, kf_valid, new_slot, mo)
        else:
            poses_j, lms_j, (ej, ej0) = _ba(
                joint_prob, num_iters=cfg.ba_iters, huber_delta=cfg.huber_px,
                lm_step_clip=cfg.ba_lm_step_clip, per_landmark_accept=False,
                damp_min=1e-5, lm_eig_floor=cfg.ba_lm_eig_floor, odo=odo, motion_only=mo)
        if cfg.ba_mode == "hybrid":
            # observability gate (polish_max_parallax_deg)
            poses = torch.where(polish_on[..., None, None], poses_j, poses)
            lms = torch.where(polish_on[..., None, None], lms_j, lms)
        else:
            poses, lms = poses_j, lms_j
        if cfg.ba_debug:
            dpose = (poses - prob.poses).abs().flatten(-2).amax(-1)
            print(f"BA kf={state.frame_idx} joint {ej0.tolist()} -> {ej.tolist()} "
                  f"dpose={dpose.tolist()}")

    kf_poses = torch.where(do_ba[..., None, None], poses, kf_poses)
    landmarks = torch.where(do_ba[..., None, None], lms, landmarks)
    cur_pose = kf_poses[:, new_slot]
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
    """One non-keyframe frame per stream, img (S, H, W): pyramid + track."""
    pyr = build_pyramid(img, cfg.tracker.num_levels, cfg.tracker.psz)
    p_new = _track_frame(state, pyr, cam, cfg.tracker)
    return state._replace(cur_pose=p_new, frame_idx=state.frame_idx + 1), p_new


def _keyframe_step(state: VOState, img, cam: CameraPyramid, cfg: VOConfig):
    """One keyframe frame per stream, img (S, H, W): pyramid + track +
    promote + BA."""
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
    """Promote frames with externally given poses (S, 6) (bootstrap path)."""
    pyr = build_pyramid(img, cfg.tracker.num_levels, cfg.tracker.psz)
    state = _promote(state, pyr, pose, cam, cfg)
    state = state._replace(frame_idx=state.frame_idx + 1)
    return state, state.cur_pose


def _run_periods(state: VOState, frames, cam: CameraPyramid, cfg: VOConfig):
    """Keyframe periods in turn: frames (P, stride, S, H, W), index 0 of
    each period the keyframe frame -> (state, (S, P * stride, 6) poses)."""
    ps = []
    for imgs in frames:
        state, p0 = _keyframe_step(state, imgs[0], cam, cfg)
        ps.append(p0)
        for j in range(1, cfg.keyframe_stride):
            state, pj = _track_step(state, imgs[j], cam, cfg)
            ps.append(pj)
    return state, torch.stack(ps, dim=-2)


def _fill_slots(landmarks, lm_valid, candidates, cand_valid):
    """Scatter valid candidates into free landmark slots (prefix-sum slot
    assignment, as in the track table), per stream of any leading axes.

    Returns (landmarks, lm_valid, seeded (..., L) bool, take (..., L)
    int32, the candidate index written into each seeded slot, -1
    elsewhere).  The JAX module's out-of-range scatter (``mode="drop"``)
    is a scatter into ``max(L, C) + 1`` entries of which only the first L
    are read.
    """
    L = landmarks.shape[-2]
    C = candidates.shape[-2]
    lead = lm_valid.shape[:-1]
    dev = landmarks.device
    free = ~lm_valid
    slot_rank = torch.cumsum(free.to(torch.int32), -1) - 1
    cand_rank = torch.cumsum(cand_valid.to(torch.int32), -1) - 1
    n = max(L, C) + 1
    scatter_idx = torch.where(cand_valid, cand_rank, n - 1).long()
    cand_for_rank = torch.full(lead + (n,), -1, dtype=torch.int32, device=dev)
    cand_for_rank = cand_for_rank.scatter(
        -1, scatter_idx, torch.arange(C, dtype=torch.int32, device=dev).expand(lead + (C,)))
    take = torch.gather(cand_for_rank, -1, torch.clamp(slot_rank, 0, L - 1).long())
    seeded = free & (take >= 0)
    take = torch.where(seeded, take, torch.full_like(take, -1))
    seed_X = _take_rows(candidates, torch.clamp(take, 0, C - 1))
    landmarks = torch.where(seeded[..., None], seed_X.to(landmarks.dtype), landmarks)
    return landmarks, lm_valid | seeded, seeded, take


def make_empty_state(cfg: VOConfig, wh, dtype=torch.float32, device=None) -> VOState:
    """A zeroed fixed-shape state of one stream, as the steps take it
    (stream axis 1), for image size ``wh`` = (W, H), on the card unless
    ``device`` says otherwise."""
    dev = resolve(device)
    L = cfg.max_landmarks
    K = cfg.window
    S = 1
    cfgt = cfg.tracker
    zero_img = torch.zeros((int(wh[1]), int(wh[0])), dtype=dtype, device=dev)
    pyr0 = build_pyramid(zero_img, cfgt.num_levels, cfgt.psz)
    kf_pyr = tuple(PyramidLevel(*(torch.zeros((K, S) + a.shape, dtype=a.dtype, device=dev)
                                  for a in lvl)) for lvl in pyr0)
    return VOState(
        landmarks=torch.zeros((S, L, 3), dtype=dtype, device=dev),
        lm_valid=torch.zeros((S, L), dtype=torch.bool, device=dev),
        lm_fail=torch.zeros((S, L), dtype=torch.int32, device=dev),
        kf_poses=torch.zeros((S, K, 6), dtype=dtype, device=dev),
        kf_valid=torch.zeros((S, K), dtype=torch.bool, device=dev),
        kf_obs=torch.zeros((S, K, L, 2), dtype=dtype, device=dev),
        kf_obs_mask=torch.zeros((S, K, L), dtype=torch.bool, device=dev),
        kf_rel=torch.eye(3, 4, dtype=dtype, device=dev).repeat(S, K, 1, 1),
        kf_rel_valid=torch.zeros((S, K), dtype=torch.bool, device=dev),
        kf_rel_info=torch.zeros((S, K, 6, 6), dtype=dtype, device=dev),
        kf_pyr=kf_pyr,
        kf_ptr=0,
        cur_pose=torch.zeros((S, 6), dtype=dtype, device=dev),
        frame_idx=0,
        kf_valid_host=(False,) * K,
    )


def _check_chunk(T: int, frame_idx: int, stride: int) -> None:
    if T % stride != 0:
        raise ValueError(f"chunk length {T} not a multiple of {stride}")
    if frame_idx % stride != 0:
        raise ValueError("chunk start must align with the keyframe cadence")


# ---------------------------------------------------------------------------


class VisualOdometry:
    """Stateful host facade: one eager device step per frame, or a loop
    of them per chunk (:meth:`run_frames`).  Runs on the card unless
    ``device`` says otherwise; frames may be numpy arrays or tensors.

    ``states`` is the steps' state, one stream; ``state`` shows it with
    the JAX module's shapes (views: a step consumes them too), and
    setting ``state`` (such a state, e.g. from
    ``convert.vo_state_from_numpy``) also sets the frame index."""

    def __init__(self, cam: CameraPyramid, fc, cc, cfg: VOConfig | None = None,
                 dtype=torch.float32, device=None):
        self.cfg = cfg or VOConfig()
        _check_meshes(self.cfg)
        if self.cfg.odo_info_weighted and self.cfg.ba_temporal_mesh is not None:
            # the temporal chain carries isotropic per-coefficient weights
            # only, as in the JAX module: warn instead of dropping silently
            warnings.warn(
                "odo_info_weighted is ignored on the ba_temporal_mesh path: the "
                "temporal chain uses the isotropic odo_sigma_t/odo_sigma_r weights "
                "(per-factor (K, 6) information weighting is not implemented there)",
                RuntimeWarning, stacklevel=2)
        self.device = resolve(device)
        self.cam = cam.to(self.device)
        self.fc = fc
        self.cc = cc
        self.dtype = dtype
        self.states: Optional[VOState] = None
        self.trajectory: list[np.ndarray] = []
        self._frame_idx = 0  # host mirror for the keyframe cadence

    # ---------- state views ----------

    @property
    def state(self) -> Optional[VOState]:
        return None if self.states is None else stream_state(self.states, 0)

    @state.setter
    def state(self, state: VOState) -> None:
        self.states = with_stream_axis(state)
        self._frame_idx = state.frame_idx

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
        return np.asarray(self.states.kf_valid_host)

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
        return self.states.kf_ptr

    # ---------- internals ----------

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.dtype)
        # in the engine's own precision, as jnp.asarray(a, dtype): a float64
        # engine keeps a float64 pose whole
        host = np.float64 if self.dtype == torch.float64 else np.float32
        return torch.as_tensor(np.asarray(a, host), device=self.device).to(self.dtype)

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
        state = state._replace(landmarks=self._tensor(pts)[None],
                               lm_valid=torch.as_tensor(msk, device=self.device)[None])
        pose0 = self._tensor(pose0)[None]
        pose1 = self._tensor(pose1)[None]

        # ---- keyframe 0 (slot 0) ----
        fx, fy, cx, cy, swo, sho = self.cam.level(0)
        if obs0 is not None:
            uv0 = np.zeros((L, 2), np.float32)
            uv0[:n] = np.asarray(obs0)[:n]
            uv0 = self._tensor(uv0)[None]
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
            kf_pyr=_update_pyr(state.kf_pyr, 0, self._pyr(img0_t[None])),
            kf_ptr=0, cur_pose=pose0, frame_idx=1)
        self.states = state
        self._append_centers(pose0)

        # ---- keyframe 1: measured promote with the given pose ----
        self.states, _ = _promote_step(self.states, self._tensor(img1)[None], pose1,
                                       self.cam, self.cfg)
        self._append_centers(self.states.cur_pose)
        self._frame_idx = 2

    def process_frame(self, img) -> np.ndarray:
        """Track one new frame; returns the (6,) pose estimate."""
        img = self._tensor(img)[None]
        if self._frame_idx % self.cfg.keyframe_stride == 0:
            self.states, pose = _keyframe_step(self.states, img, self.cam, self.cfg)
        else:
            self.states, pose = _track_step(self.states, img, self.cam, self.cfg)
        self._frame_idx += 1
        self._append_centers(pose)
        return pose[0].cpu().numpy()

    def run_frames(self, images) -> np.ndarray:
        """Process a chunk of frames, keyframe period by keyframe period,
        with no host sync until the end.  ``images``: (T, H, W) with T a
        multiple of ``keyframe_stride``, the first frame a keyframe
        frame.  Returns the (T, 6) poses."""
        stride = self.cfg.keyframe_stride
        T = images.shape[0]
        _check_chunk(T, self._frame_idx, stride)
        frames = self._tensor(images).reshape(T // stride, stride, 1, *images.shape[1:])
        self.states, poses = _run_periods(self.states, frames, self.cam, self.cfg)
        self._frame_idx += T
        self._append_centers(poses)
        return poses[0].cpu().numpy()


class VisualOdometryBatch:
    """S independent VO streams advanced by one sequence of launches: the
    engine's steps on a state with a stream axis of S, where the JAX
    module runs one ``vmap``ped program.  The throughput mode: the
    launches of a step, which bound the one-stream engine, serve S
    streams.

    All streams share one camera and config, and one keyframe cadence;
    their states are stacked (copied) along the stream axis, so the
    engines keep theirs.  Both branches of the BA gate run and a select
    keeps one per stream, as ``lax.cond`` under ``vmap`` does.
    ``tracker.gather_split`` (the JAX module forces it where the TPU's
    fast memory would not hold two planes per stream) is accepted and
    changes nothing.
    """

    def __init__(self, engines: "list[VisualOdometry]"):
        if not engines:
            raise ValueError("need at least one bootstrapped engine")
        first = engines[0]
        for e in engines:
            if e.cfg is not first.cfg and e.cfg != first.cfg:
                raise ValueError("streams must share one VOConfig")
            if e.states is None:
                raise ValueError("bootstrap every engine first")
            if (e.device, e.dtype) != (first.device, first.dtype):
                raise ValueError("streams must share one device and dtype")
            if e.states.kf_pyr[0].img.shape != first.states.kf_pyr[0].img.shape:
                raise ValueError("streams must share one image size")
            if e._frame_idx != first._frame_idx:
                raise ValueError("streams must share one frame index")
        self.engines = engines
        self.cfg = first.cfg
        self.cam = first.cam
        self.states = stack_states([e.states for e in engines])
        self._frame_idx = first._frame_idx

    @property
    def n_streams(self) -> int:
        return len(self.engines)

    def run_frames(self, images) -> np.ndarray:
        """images: (S, T, H, W), T a multiple of keyframe_stride and the
        cadence aligned (the contract of VisualOdometry.run_frames).  One
        sequence of launches advances every stream; returns (S, T, 6)."""
        stride = self.cfg.keyframe_stride
        S, T = images.shape[:2]
        if S != self.n_streams:
            raise ValueError(f"{S} image streams != {self.n_streams}")
        _check_chunk(T, self._frame_idx, stride)
        frames = self.engines[0]._tensor(images).transpose(0, 1).contiguous()
        frames = frames.reshape(T // stride, stride, S, *images.shape[2:])
        self.states, poses = _run_periods(self.states, frames, self.cam, self.cfg)
        self._frame_idx += T
        return poses.cpu().numpy()

    def state_of(self, s: int) -> VOState:
        """Stream s's state with the JAX module's shapes (views)."""
        return stream_state(self.states, s)
