"""Temporal (sequence-parallel) bundle adjustment: the keyframe axis
sharded over ranks (port of ``invcompcamtrack_tpu/ba/temporal.py``).

``ba/distributed.py`` shards the LANDMARK axis; this module shards the
TEMPORAL axis: a trajectory of K keyframes is cut into contiguous
segments over the ``seq`` mesh axis.

How the coupling travels:

- Reprojection factors couple poses only through landmarks.  With poses
  and observations sharded (K axis) and the landmarks replicated, every
  cross-segment interaction is an all-reduce of landmark-indexed
  partials: ``H_xx`` (L, 3, 3) and ``b_x`` (L, 3) once per GN step, and
  one (L, 3) per CG matvec on the reduced camera system.
- Odometry-chain factors (relative-pose priors between consecutive
  keyframes, in coefficient space) couple neighbour poses directly.  The
  factor at a segment boundary needs the neighbour rank's edge pose: a
  ring shift of one (6,) vector per direction per matvec
  (``parallel/comm.py::ring_shifts``, the JAX module's ``lax.ppermute``).
  On a ring of one rank both edges are chain ends (zeros) and nothing is
  sent.

The JAX module's ``shard_map`` body is :func:`_temporal_spmd`; every rank
of the world runs it on its slice of the replicated problem, and its
``lax.scan`` loops are Python loops.  Costs, CG scalars and the landmark
updates are all-reduced, so every rank takes the same accept/reject and
holds the same landmarks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from invcompcamtrack_torch.ba.distributed import gather_rows, shard_slice
from invcompcamtrack_torch.ba.window import BAProblem, _jacobians, _solve, huber_weights
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.parallel.comm import axis_size, psum, ring_shifts
from invcompcamtrack_torch.sfm.triangulate import sym3x3_inverse


class TemporalBAProblem(NamedTuple):
    poses: torch.Tensor        # (K, 6) se(3) coeffs, x_cam = R X + t
    landmarks: torch.Tensor    # (L, 3)
    obs: torch.Tensor          # (K, L, 2) pixel observations
    mask: torch.Tensor         # (K, L) bool
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    fixed_pose_mask: torch.Tensor  # (K,) bool: True = pose held fixed
    odom: torch.Tensor         # (K, 6) chain measurement: odom[k] ~
    #                           poses[k+1] - poses[k]; row K-1 unused
    odom_weight: torch.Tensor  # (), (K,), or (K, 6): 0 disables the
    #                           chain factor (row k weights the k -> k+1
    #                           factor; a (K, 6) weight gives translation
    #                           and rotation coefficients distinct sigmas)


class _Ring(NamedTuple):
    """The keyframe axis as this rank sees it."""

    group: object   # the axis's process group
    idx: int        # this rank's segment
    n: int          # number of segments


def _project(poses, landmarks, fx, fy, cx, cy):
    """(Kd, L, 2) pinhole projections of every landmark in every pose."""
    G = lie.se3_exp(poses)
    Xc = lie.matvec(G[:, None, :, :3], landmarks[None]) + G[:, None, :, 3]
    return torch.stack([Xc[..., 0] / Xc[..., 2] * fx + cx,
                        Xc[..., 1] / Xc[..., 2] * fy + cy], dim=-1)


def _neighbor_edges(x_local, ring: _Ring):
    """Halo exchange of segment-edge pose vectors.

    x_local: (Kd, 6) this rank's rows.  Returns (right_first, left_last):
    the RIGHT neighbour's first row and the LEFT neighbour's last row,
    each (6,), zeros at the chain ends (on a ring of one rank both).
    """
    zero = torch.zeros_like(x_local[0])
    if ring.n == 1:
        return zero, zero
    # my first row travels left (so each rank receives its RIGHT
    # neighbour's first row); my last row travels right
    right_first, left_last = ring_shifts([(x_local[0], -1), (x_local[-1], 1)], ring.group)
    if ring.idx == ring.n - 1:
        right_first = zero
    if ring.idx == 0:
        left_last = zero
    return right_first, left_last


def _prev_factor_weight(w_local, ring: _Ring):
    """w_{k-1} per local row ((Kd, 6) per-coefficient weights): a local
    shift, the boundary row from the left neighbour's last factor weight
    through the ring halo."""
    _, w_left = _neighbor_edges(w_local, ring)
    return torch.cat([w_left[None], w_local[:-1]], dim=0)


def _chain_matvec(x, free_f, w_local, w_prev, ring: _Ring):
    """H_chain x for the odometry chain, with ring halos.

    x: (Kd, 6) local slice of the pose update.  Factor k (local row k,
    per-coefficient weight w_local[k]) couples rows k and k+1; the last
    local factor couples into the right neighbour's first row, and the
    left neighbour's last factor (weight ``w_prev[0]``) into local row 0.
    A FIXED neighbour contributes dx = 0 to the coupling, but its
    incident factor still stiffens the free side's diagonal.
    """
    xm = x * free_f[:, None]
    right_first, left_last = _neighbor_edges(xm, ring)
    x_next = torch.cat([xm[1:], right_first[None]], dim=0)
    x_prev = torch.cat([left_last[None], xm[:-1]], dim=0)
    # factor k: + w_k (x_k - x_{k+1}) on row k; factor k-1:
    # + w_{k-1} (x_k - x_{k-1}) on row k
    y = w_local * (xm - x_next) + w_prev * (xm - x_prev)
    return y * free_f[:, None]


def _chain_residual(poses_local, odom_local, ring: _Ring):
    """e[k] = poses[k+1] - poses[k] - odom[k] per local factor (Kd, 6);
    the last rank's last row is padded with zeros (no factor K-1)."""
    right_first, _ = _neighbor_edges(poses_local, ring)
    nxt = torch.cat([poses_local[1:], right_first[None]], dim=0)
    return nxt - poses_local - odom_local


def _chain_weight_mask(w, free_f, ring: _Ring):
    """Per-local-row, per-coefficient factor weight (Kd, 6) from a scalar,
    (Kd,) or (Kd, 6) weight; zero on the final chain row (factor K-1
    does not exist)."""
    Kd = free_f.shape[0]
    w = torch.as_tensor(w, dtype=free_f.dtype, device=free_f.device)
    if w.dim() == 1:
        w = w[:, None]
    row_w = torch.broadcast_to(w, (Kd, 6))
    if ring.idx == ring.n - 1:
        is_last_row = (torch.arange(Kd, device=free_f.device) == Kd - 1)[:, None]
        row_w = torch.where(is_last_row, torch.zeros_like(row_w), row_w)
    return row_w


def _residuals(poses_l, lms, obs, mask, intr):
    """Masked residuals obs - proj (Kd, L, 2): exactly zero where masked,
    a large sentinel where an observed projection is not finite."""
    proj = _project(poses_l, lms, *intr)
    m = mask[..., None]
    raw = torch.where(m, obs - proj, torch.zeros_like(proj))
    return torch.where(torch.isfinite(raw), raw,
                       torch.where(m, torch.full_like(raw, 1e6), torch.zeros_like(raw)))


def _temporal_spmd(poses, landmarks, obs, mask, fixed, odom, odom_w, intr, ring: _Ring,
                   *, num_iters, damp_init, damp_up, damp_down, huber_delta, cg_iters,
                   motion_only):
    """The JAX module's shard_map body: everything pose-indexed is this
    rank's (Kd, ...) slice; the landmarks are replicated."""
    fx, fy, cx, cy = intr
    dtype, dev = poses.dtype, poses.device
    free_f = (~fixed).to(dtype)
    g = ring.group
    w_row = _chain_weight_mask(odom_w, free_f, ring)
    # the chain's incoming weights depend on the weights alone: one halo
    w_prev = _prev_factor_weight(w_row, ring)
    cnt = torch.clamp(psum(torch.sum(mask), g), min=1)

    def cost(poses_l, lms):
        res = _residuals(poses_l, lms, obs, mask, intr)
        if huber_delta is None:
            c_loc = torch.sum(res * res)
        else:
            rn = torch.sqrt(torch.sum(res * res, dim=-1) + 1e-24)
            rho = torch.where(rn <= huber_delta, rn * rn,
                              huber_delta * (2.0 * rn - huber_delta))
            c_loc = torch.sum(torch.where(mask, rho, torch.zeros_like(rho)))
        e = _chain_residual(poses_l, odom, ring)
        c_loc = c_loc + torch.sum(w_row * e * e)
        return psum(c_loc, g) / (2.0 * cnt)

    def gn_step(poses_l, lms, damp):
        res = _residuals(poses_l, lms, obs, mask, intr)
        Jp, Jx = _jacobians(BAProblem(poses=poses_l, landmarks=lms, obs=obs, mask=mask,
                                      fx=fx, fy=fy, cx=cx, cy=cy, fixed_pose_mask=fixed))
        if motion_only is True:
            # landmarks frozen (the engine's hybrid pose polish): zero
            # landmark Jacobians make W = 0 and the landmark step exactly 0
            Jx = torch.zeros_like(Jx)
        elif not isinstance(motion_only, bool):
            # a device-side gate (the engine's turnover routing)
            Jx = torch.where(motion_only, torch.zeros_like(Jx), Jx)
        if huber_delta is not None:
            sw = torch.sqrt(huber_weights(res, mask, huber_delta))
            res = res * sw[..., None]
            Jp = Jp * sw[..., None, None]
            Jx = Jx * sw[..., None, None]
        Jp = Jp * free_f[:, None, None, None]

        # normal-equation blocks; the landmark blocks sum over segments
        Hpp = torch.einsum("klri,klrj->kij", Jp, Jp)
        Hxx = psum(torch.einsum("klri,klrj->lij", Jx, Jx), g)
        Hpx = torch.einsum("klri,klrj->klij", Jp, Jx)
        bp = torch.einsum("klri,klr->ki", Jp, res)
        bx = psum(torch.einsum("klri,klr->li", Jx, res), g)

        eye6 = torch.eye(6, dtype=dtype, device=dev)
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        Hpp = Hpp + damp * eye6 * torch.clamp(
            torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-8)[..., None, :] * eye6
        Hxx = Hxx + damp * eye3 * torch.clamp(
            torch.diagonal(Hxx, dim1=-2, dim2=-1), min=1e-8)[..., None, :] * eye3
        Hxx_inv = sym3x3_inverse(Hxx)

        W = torch.einsum("klij,ljm->klim", Hpx, Hxx_inv)
        rhs = bp - torch.einsum("klim,lm->ki", W, bx)

        # chain rhs: J^T res with res_k = -e_k; d(pred)/dp_k = -I,
        # d/dp_{k+1} = +I  =>  rhs_k += w e_k, rhs_{k+1} -= w_k e_k
        # (the incoming factor through the halo)
        e = _chain_residual(poses_l, odom, ring)
        we = w_row * e
        _, left_last_we = _neighbor_edges(we, ring)
        we_prev = torch.cat([left_last_we[None], we[:-1]], dim=0)
        rhs = (rhs + we - we_prev) * free_f[:, None]

        # matrix-free PCG on the distributed reduced system
        def matvec(x):
            x = x * free_f[:, None]
            t = psum(torch.einsum("klim,ki->lm", Hpx, x), g)
            y = torch.einsum("klim,lm->ki", W, t)
            out = torch.einsum("kij,kj->ki", Hpp, x) - y
            out = out + _chain_matvec(x, free_f, w_row, w_prev, ring)
            # identity rows keep fixed poses invertible, their step 0
            return out * free_f[:, None] + x * (1.0 - free_f)[:, None]

        # block-diagonal preconditioner: S_kk plus the chain's diagonal
        S_kk = Hpp - torch.einsum("klim,kljm->kij", W, Hpx)
        chain_diag = (w_row + w_prev) * free_f[:, None] + fixed.to(dtype)[:, None]
        S_kk = S_kk + eye6 * chain_diag[:, None, :]

        def prec(r):
            return _solve(S_kk, r[..., None])[..., 0]

        def pdot(a, b):
            return psum(torch.sum(a * b), g)

        x = torch.zeros_like(rhs)
        r = rhs - matvec(x)
        p = prec(r)
        rz = pdot(r, p)
        zero = torch.zeros_like(rz)
        for _ in range(cg_iters):
            Ap = matvec(p)
            denom = pdot(p, Ap)
            alpha = torch.where(torch.abs(denom) > 1e-30, rz / denom, zero)
            alpha = torch.where(rz > 1e-12, alpha, zero)
            x = x + alpha * p
            r = r - alpha * Ap
            z = prec(r)
            rz_new = pdot(r, z)
            beta = torch.where(rz > 1e-30, rz_new / rz, zero)
            p = z + beta * p
            rz = rz_new
        dpose = x * free_f[:, None]

        # landmark back-substitution (all-reduced: the same on every rank)
        t = bx - psum(torch.einsum("klij,ki->lj", Hpx, dpose), g)
        dlm = torch.einsum("lij,lj->li", Hxx_inv, t)
        return dpose, dlm

    err0 = cost(poses, landmarks)
    err = err0
    damp = torch.tensor(damp_init, dtype=dtype, device=dev)
    for _ in range(num_iters):
        dpose, dlm = gn_step(poses, landmarks, damp)
        cand_p, cand_x = poses + dpose, landmarks + dlm
        err_new = cost(cand_p, cand_x)
        ok = err_new < err
        poses = torch.where(ok, cand_p, poses)
        landmarks = torch.where(ok, cand_x, landmarks)
        damp = torch.where(ok, damp / damp_down, damp * damp_up)
        err = torch.where(ok, err_new, err)
    return poses, landmarks, err, err0


def temporal_ba_solve(prob: TemporalBAProblem, mesh, axis: str = "seq",
                      num_iters: int = 10, damp_init: float = 1e-3,
                      damp_up: float = 10.0, damp_down: float = 10.0,
                      huber_delta: float | None = None, cg_iters: int = 32,
                      motion_only=False):
    """Levenberg-Marquardt BA with the keyframe axis sharded over the
    ranks of ``mesh`` axis ``axis``; every rank calls it with the same
    problem.  K must divide evenly by the axis size.  ``motion_only``: a
    bool, or a 0-d bool tensor (a device-side gate).  Returns (poses (K,
    6), landmarks, (err, err0)), the same on every rank.
    """
    K = prob.poses.shape[0]
    rows = shard_slice(K, mesh, axis)
    group = mesh.get_group(axis)
    ring = _Ring(group=group, idx=mesh.get_local_rank(axis), n=axis_size(mesh, axis))
    odom_w = torch.as_tensor(prob.odom_weight, dtype=prob.poses.dtype,
                             device=prob.poses.device)
    # a scalar weight is replicated; per-factor (K,)/(K, 6) weights ride
    # the keyframe axis like the factors they weight
    w_loc = odom_w if odom_w.dim() == 0 else odom_w[rows]
    poses, lms, err, err0 = _temporal_spmd(
        prob.poses[rows], prob.landmarks, prob.obs[rows], prob.mask[rows],
        prob.fixed_pose_mask[rows], prob.odom[rows], w_loc,
        (prob.fx, prob.fy, prob.cx, prob.cy), ring,
        num_iters=num_iters, damp_init=damp_init, damp_up=damp_up,
        damp_down=damp_down, huber_delta=huber_delta, cg_iters=cg_iters,
        motion_only=motion_only)
    return gather_rows(poses, K, rows, group, dim=0), lms, (err, err0)
