"""Sliding-window bundle adjustment by Schur-complement reduction (port
of ``invcompcamtrack_tpu/ba/window.py``).

- The observation set is a dense ``(K poses, L landmarks)`` grid with a
  boolean mask (fixed shapes; missing observations contribute zeros).
- Per-observation Jacobians come from forward-mode AD of the projection
  and se(3) code the tracker uses: ``torch.func.jacfwd`` under two
  ``torch.func.vmap``s, where the JAX module takes ``jax.jacfwd`` under
  two ``jax.vmap``s.
- The landmark blocks ``H_ll`` are L 3x3 systems inverted in closed form
  (cofactors, or the truncated Cardano pseudo-inverse of
  ``ops/linalg.py``); the reduced camera system is a dense (6K, 6K)
  solve, or matrix-free preconditioned CG for long windows.
- Levenberg damping with accept/reject on the device (``torch.where``,
  no host sync); the gauge is fixed by ``fixed_pose_mask``.

The JAX module's ``lax.scan`` loops (CG, the LM iterations) are fixed
Python loops.  Its ``psum_axis`` (the landmark-sharded path) belongs to
the multi-device slice: only ``None`` is accepted.  Dense and
preconditioner solves use ``torch.linalg.solve_ex``, which, like
``jnp.linalg.solve``, returns non-finite values for a singular system
instead of raising (and so never syncs with the host).

Every function takes problems with leading axes, ``poses (..., K, 6)``,
``landmarks (..., L, 3)`` and so on: independent windows (the streams of
the multi-stream VO engine), each solved as its own problem would be, as
``jax.vmap`` over the JAX module solves them.  Every reduction (costs,
counts, the accept/reject, the damping, the CG scalars) is per window.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.ops.linalg import sym3x3_trunc_pinv
from invcompcamtrack_torch.sfm.triangulate import sym3x3_inverse


class BAProblem(NamedTuple):
    poses: torch.Tensor        # (..., K, 6) se(3) coeffs, x_cam = R X + t
    landmarks: torch.Tensor    # (..., L, 3)
    obs: torch.Tensor          # (..., K, L, 2) pixel observations
    mask: torch.Tensor         # (..., K, L) bool
    fx: torch.Tensor           # scalars (shared intrinsics)
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    fixed_pose_mask: torch.Tensor  # (..., K) bool: True = pose held fixed


class OdoFactors(NamedTuple):
    """Relative-pose (odometry) prior factors between ring-consecutive
    poses: factor k constrains poses ``(k-1) % K -> k`` (ring slot
    order).  With them, joint BA fuses the photometric odometer's
    measurement instead of replacing it."""

    rel: torch.Tensor    # (..., K, 3, 4) measured relative group G_k G_{k-1}^{-1}
    mask: torch.Tensor   # (..., K) bool: factor k active
    w_t: torch.Tensor    # scalar: pixel-equivalent weight per unit translation
    w_r: torch.Tensor    # scalar: pixel-equivalent weight per radian
    info_sqrt: torch.Tensor | None = None  # optional (..., K, 6, 6) square
    #   root of each factor's full information matrix in the residual
    #   coordinates; when set it replaces the isotropic w_t/w_r weighting


def _no_psum(psum_axis) -> None:
    if psum_axis is not None:
        raise NotImplementedError(
            "psum_axis (the landmark-sharded window BA) belongs to the port's "
            "multi-device slice; only psum_axis=None is supported")


def _per_window(fn, n: int, in_dims):
    """``fn`` of one window, mapped over ``n`` leading window axes."""
    for _ in range(n):
        fn = torch.func.vmap(fn, in_dims=in_dims)
    return fn


def odo_residuals(poses: torch.Tensor, odo: OdoFactors) -> torch.Tensor:
    """(..., K, 6) weighted relative-pose discrepancy residuals.

    Discrepancy D = (G_k G_{k-1}^{-1}) rel_k^{-1}; the residual is its
    first-order se(3) coordinate [t_D, vex(R_D - R_D^T)/2], a polynomial
    in the pose entries (AD-safe where the log map is not).
    """
    G = lie.se3_exp(poses)
    Gp = torch.roll(G, 1, dims=-3)
    G_rel = lie.se3_compose(G, lie.se3_inverse(Gp))
    D = lie.se3_compose(G_rel, lie.se3_inverse(odo.rel))
    R = D[..., :3]
    rw = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                            R[..., 0, 2] - R[..., 2, 0],
                            R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    if odo.info_sqrt is None:
        r = torch.cat([D[..., 3] * odo.w_t, rw * odo.w_r], dim=-1)
    else:
        ru = torch.cat([D[..., 3], rw], dim=-1)
        r = torch.einsum("...kij,...kj->...ki", odo.info_sqrt, ru)
    return torch.where(odo.mask[..., None], r, torch.zeros_like(r))


def _odo_system_one(poses, rel, mask, info_sqrt, w_t, w_r, fixed):
    """One window's odometry GN system (H (6K, 6K), b (K, 6), cost)."""
    K = poses.shape[-2]
    odo = OdoFactors(rel=rel, mask=mask, w_t=w_t, w_r=w_r, info_sqrt=info_sqrt)

    def rfun(ps):
        return odo_residuals(ps, odo).reshape(-1)

    r = rfun(poses)
    J = torch.func.jacfwd(rfun)(poses).to(poses.dtype)     # (6K, K, 6)
    J = torch.where(fixed[None, :, None], torch.zeros_like(J), J).reshape(6 * K, 6 * K)
    H = J.transpose(-1, -2) @ J
    # (a sum, not a matrix-vector product, whose summation path would
    # depend on the number of windows)
    b = -torch.sum(J * r[:, None], dim=0).reshape(K, 6)
    return H, b, torch.sum(r * r)


def _odo_system(poses: torch.Tensor, odo: OdoFactors, fixed: torch.Tensor):
    """GN system of the odometry factors: (H (..., 6K, 6K), b (..., K, 6),
    cost (...)), b = J^T (-r); fixed poses' columns are zeroed."""
    has_info = odo.info_sqrt is not None
    fn = _per_window(_odo_system_one, poses.dim() - 2,
                     (0, 0, 0, 0 if has_info else None, None, None, 0))
    return fn(poses, odo.rel, odo.mask, odo.info_sqrt, odo.w_t, odo.w_r, fixed)


def _project_one(p, X, fx, fy, cx, cy):
    G = lie.se3_exp(p)
    Xc = lie.matvec(G[:, :3], X) + G[:, 3]
    return torch.stack([Xc[0] / Xc[2] * fx + cx, Xc[1] / Xc[2] * fy + cy])


def _project_all(prob: BAProblem) -> torch.Tensor:
    """(..., K, L, 2) projections of every landmark into every pose."""
    G = lie.se3_exp(prob.poses)                                    # (...,K,3,4)
    Xc = (lie.matvec(G[..., :, None, :, :3], prob.landmarks[..., None, :, :])
          + G[..., :, None, :, 3])
    return torch.stack([Xc[..., 0] / Xc[..., 2] * prob.fx + prob.cx,
                        Xc[..., 1] / Xc[..., 2] * prob.fy + prob.cy], dim=-1)


def ba_residuals(prob: BAProblem, huber_delta: float | None = None,
                 psum_axis: str | None = None):
    """(..., K, L, 2) masked residuals obs - proj and the mean cost (...).

    With ``huber_delta`` the cost is the Huber loss of each
    observation's residual norm; the residual tensor is unweighted.
    """
    _no_psum(psum_axis)
    proj = _project_all(prob)
    m = prob.mask[..., None]
    # masked entries are exactly zero even where proj is inf/NaN; an
    # observed entry whose projection is not finite gets a large
    # sentinel residual (a state that throws a tracked landmark behind
    # the camera must read as costly)
    raw = torch.where(m, prob.obs - proj, torch.zeros_like(proj))
    res = torch.where(torch.isfinite(raw), raw,
                      torch.where(m, torch.full_like(raw, 1e6), torch.zeros_like(raw)))
    cnt = torch.clamp(torch.sum(prob.mask, dim=(-2, -1)), min=1)
    if huber_delta is None:
        return res, torch.sum(res * res, dim=(-3, -2, -1)) / (2.0 * cnt)
    rn = torch.sqrt(torch.sum(res * res, dim=-1) + 1e-24)
    rho = torch.where(rn <= huber_delta, rn * rn, huber_delta * (2.0 * rn - huber_delta))
    return res, (torch.sum(torch.where(prob.mask, rho, torch.zeros_like(rho)), dim=(-2, -1))
                 / (2.0 * cnt))


def huber_weights(res: torch.Tensor, mask: torch.Tensor, delta: float) -> torch.Tensor:
    """(..., K, L) IRLS weights w = min(1, delta/|r|) of the Huber loss."""
    rn = torch.sqrt(torch.sum(res * res, dim=-1) + 1e-24)
    return torch.where(rn <= delta, torch.ones_like(rn), delta / rn) * mask


def _per_landmark_cost(res, mask, huber_delta):
    """(..., L) robust cost of each landmark's observations."""
    rn2 = torch.sum(res * res, dim=-1)
    if huber_delta is None:
        rho = rn2
    else:
        rn = torch.sqrt(rn2 + 1e-24)
        rho = torch.where(rn <= huber_delta, rn2, huber_delta * (2.0 * rn - huber_delta))
    return torch.sum(torch.where(mask, rho, torch.zeros_like(rho)), dim=-2)


def _jacobians(prob: BAProblem):
    """J_p: (..., K, L, 2, 6); J_x: (..., K, L, 2, 3), forward-mode AD,
    masked."""

    def f(p, X):
        return _project_one(p, X, prob.fx, prob.fy, prob.cx, prob.cy)

    jac = torch.func.jacfwd(f, argnums=(0, 1))
    grid = torch.func.vmap(torch.func.vmap(jac, in_dims=(None, 0)), in_dims=(0, None))
    jp, jx = _per_window(grid, prob.poses.dim() - 2, (0, 0))(prob.poses, prob.landmarks)
    dt = prob.poses.dtype
    jp, jx = jp.to(dt), jx.to(dt)
    # where(), not *: masked entries with non-finite Jacobians (empty
    # slots, points behind the camera) become exactly 0
    m = prob.mask[..., None, None]
    jp = torch.where(m & torch.isfinite(jp), jp, torch.zeros_like(jp))
    jx = torch.where(m & torch.isfinite(jx), jx, torch.zeros_like(jx))
    return jp, jx


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A x = b without an error check (a singular A gives non-finite x,
    as ``jnp.linalg.solve`` does)."""
    return torch.linalg.solve_ex(A, b, check_errors=False)[0]


# The products with a vector below are broadcast products and sums, not
# einsums: ``torch.einsum`` groups a window axis of size 1 with other
# axes, so it sums one window in another order than several, and a
# stream's BA would then depend on how many streams run beside it.
def _w_times(W: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_l W[k, l] v[l]: W (..., K, L, 6, 3), v (..., L, 3) -> (..., K, 6)."""
    return torch.sum(W * v[..., None, :, None, :], dim=(-3, -1))


def _diag_blocks(H: torch.Tensor, K: int) -> torch.Tensor:
    """The K diagonal (6, 6) blocks of H (..., 6K, 6K) -> (..., K, 6, 6)."""
    H5 = H.reshape(H.shape[:-2] + (K, 6, K, 6))
    return torch.diagonal(H5, dim1=-4, dim2=-2).movedim(-1, -3)


def schur_cg_solve(Hpp, W, Hpx, fixed, rhs, num_iters: int = 32,
                   tol: float = 1e-10, psum_axis: str | None = None,
                   H_extra: torch.Tensor | None = None):
    """Matrix-free preconditioned CG on the reduced camera system
    ``S x = rhs``, ``S = Hpp_diag + fixed*I - W Hxp^T``, without forming
    the (6K, 6K) matrix; block-diagonal (6x6) preconditioner.  Leading
    axes are independent systems, each with its own CG scalars."""
    _no_psum(psum_axis)
    K = rhs.shape[-2]
    lead = rhs.shape[:-2]
    fixed_f = fixed.to(rhs.dtype)

    def matvec(x):
        t = torch.sum(Hpx * x[..., :, None, :, None], dim=(-4, -2))   # (...,L,3)
        y = _w_times(W, t)                                     # (...,K,6)
        out = torch.sum(Hpp * x[..., None, :], dim=-1) + fixed_f[..., None] * x - y
        if H_extra is not None:
            out = out + torch.sum(H_extra * x.reshape(lead + (1, 6 * K)),
                                  dim=-1).reshape(lead + (K, 6))
        return out

    # block-diagonal preconditioner M_k = S_kk
    S_kk = (Hpp - torch.einsum("...klim,...kljm->...kij", W, Hpx)
            + fixed_f[..., None, None] * torch.eye(6, dtype=rhs.dtype, device=rhs.device))
    if H_extra is not None:
        S_kk = S_kk + _diag_blocks(H_extra, K)

    def prec(r):
        return _solve(S_kk, r[..., None])[..., 0]

    def dot(a, b):
        return torch.sum(a * b, dim=(-2, -1))

    x = torch.zeros_like(rhs)
    r = rhs - matvec(x)
    z = prec(r)
    p = z
    rz = dot(r, z)
    for _ in range(num_iters):
        Ap = matvec(p)
        denom = dot(p, Ap)
        alpha = torch.where(torch.abs(denom) > 1e-30, rz / denom, torch.zeros_like(rz))
        alpha = torch.where(rz > tol, alpha, torch.zeros_like(alpha))
        x = x + alpha[..., None, None] * p
        r = r - alpha[..., None, None] * Ap
        z = prec(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 1e-30, rz_new / rz, torch.zeros_like(rz))
        p = z + beta[..., None, None] * p
        rz = rz_new
    return x


def _schur_step(prob: BAProblem, damp, huber_delta: float | None = None,
                reduced_solver: str = "dense", cg_iters: int = 32,
                lm_eig_floor: float | None = None,
                odo: OdoFactors | None = None,
                psum_axis: str | None = None,
                motion_only=False):
    """One damped GN step by Schur elimination of the landmarks.

    ``damp``: the Levenberg parameter, one per window (shape ``...``).
    ``huber_delta``: IRLS reweighting (square-root weights folded into
    residuals and Jacobians).  ``reduced_solver``: "dense" forms and
    solves the (6K, 6K) reduced system, "cg" runs matrix-free PCG.
    ``lm_eig_floor``: eigen-directions of H_ll below ``lm_eig_floor *
    lambda_max`` get a zero update (truncated pseudo-inverse).
    ``motion_only``: landmarks frozen (H_ll^-1 = 0); a Python bool, or a
    bool tensor (one per window) that selects between the joint and the
    frozen step on the device.  Returns (dpose (..., K, 6), dlm (..., L, 3)).
    """
    _no_psum(psum_axis)
    K, L = prob.mask.shape[-2:]
    lead = prob.mask.shape[:-2]
    res, _ = ba_residuals(prob)
    Jp, Jx = _jacobians(prob)
    dt, dev = res.dtype, res.device

    if huber_delta is not None:
        sw = torch.sqrt(huber_weights(res, prob.mask, huber_delta))
        res = res * sw[..., None]
        Jp = Jp * sw[..., None, None]
        Jx = Jx * sw[..., None, None]

    # zero Jacobians of fixed poses: their update is exactly 0 and the
    # damped diagonal keeps S invertible
    Jp = torch.where(prob.fixed_pose_mask[..., :, None, None, None], torch.zeros_like(Jp), Jp)

    Hpp = torch.einsum("...klri,...klrj->...kij", Jp, Jp)        # (...,K,6,6)
    Hxx = torch.einsum("...klri,...klrj->...lij", Jx, Jx)        # (...,L,3,3)
    Hpx = torch.einsum("...klri,...klrj->...klij", Jp, Jx)       # (...,K,L,6,3)
    bp = torch.sum(Jp * res[..., None], dim=(-3, -2))            # (...,K,6)
    bx = torch.sum(Jx * res[..., None], dim=(-4, -2))            # (...,L,3)

    # Levenberg damping on both diagonals
    eyeK = torch.eye(6, dtype=dt, device=dev)
    eyeL = torch.eye(3, dtype=dt, device=dev)
    d = torch.as_tensor(damp, dtype=dt, device=dev)[..., None, None, None]
    Hpp = Hpp + d * eyeK * torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1),
                                       min=1e-8)[..., None, :] * eyeK
    Hxx = Hxx + d * eyeL * torch.clamp(torch.diagonal(Hxx, dim1=-2, dim2=-1),
                                       min=1e-8)[..., None, :] * eyeL

    if motion_only is True:
        # landmarks frozen: H_ll^-1 = 0 collapses the Schur complement to
        # the pose block (W = 0, dlm = 0)
        Hxx_inv = torch.zeros_like(Hxx)
    else:
        if lm_eig_floor is None:
            Hxx_inv = sym3x3_inverse(Hxx)
        else:
            Hxx_inv = sym3x3_trunc_pinv(Hxx, lm_eig_floor)
        if not isinstance(motion_only, bool):
            # a device-side gate (the engine's turnover routing): one
            # code path serves the joint and the frozen step
            Hxx_inv = torch.where(motion_only[..., None, None, None],
                                  torch.zeros_like(Hxx_inv), Hxx_inv)

    # Schur complement: S = Hpp - sum_l Hpx Hxx^-1 Hxp
    W = torch.einsum("...klij,...ljm->...klim", Hpx, Hxx_inv)    # (...,K,L,6,3)
    rhs = bp - _w_times(W, bx)                                   # (...,K,6)
    fixed = prob.fixed_pose_mask

    H_odo = None
    if odo is not None:
        H_odo, b_odo, _ = _odo_system(prob.poses, odo, fixed)
        rhs = rhs + b_odo

    if reduced_solver == "cg":
        dpose = schur_cg_solve(Hpp, W, Hpx, fixed, rhs, num_iters=cg_iters,
                               H_extra=H_odo)
    else:
        diagK = torch.eye(K, dtype=dt, device=dev)[:, None, :, None]
        S = (-torch.einsum("...klim,...qljm->...kiqj", W, Hpx)
             + diagK * Hpp[..., :, :, None, :])
        if H_odo is not None:
            S = S + H_odo.reshape(lead + (K, 6, K, 6))
        # keep fixed poses' rows/cols well-conditioned (their J is zero)
        boost = fixed.to(dt)[..., None, None] * eyeK
        S = S + diagK * boost[..., :, :, None, :]
        dpose = _solve(S.reshape(lead + (6 * K, 6 * K)),
                       rhs.reshape(lead + (6 * K, 1))).reshape(lead + (K, 6))
    dpose = dpose * (~fixed)[..., None]

    # back-substitute landmarks: dx = Hxx^-1 (bx - Hxp dpose)
    t = bx - torch.sum(Hpx * dpose[..., :, None, :, None], dim=(-4, -2))
    dlm = torch.sum(Hxx_inv * t[..., None, :], dim=-1)
    return dpose, dlm


def _total_cost(prob: BAProblem, odo: OdoFactors | None,
                huber_delta: float | None, psum_axis: str | None = None):
    """(residuals, cost (...)) including the odometry-prior term."""
    res, err = ba_residuals(prob, huber_delta, psum_axis)
    if odo is not None:
        cnt = torch.clamp(torch.sum(prob.mask, dim=(-2, -1)), min=1)
        r = odo_residuals(prob.poses, odo)
        err = err + torch.sum(r * r, dim=(-2, -1)) / (2.0 * cnt)
    return res, err


def ba_solve(prob: BAProblem, num_iters: int = 10, damp_init: float = 1e-3,
             damp_up: float = 10.0, damp_down: float = 10.0,
             huber_delta: float | None = None,
             reduced_solver: str = "dense", cg_iters: int = 32,
             lm_step_clip: float | None = None,
             per_landmark_accept: bool = False,
             damp_min: float = 0.0,
             lm_eig_floor: float | None = None,
             odo: OdoFactors | None = None,
             psum_axis: str | None = None,
             motion_only=False):
    """Levenberg-Marquardt loop with accept/reject on the total error.

    ``motion_only``: hold the landmarks fixed (dlm = 0 exactly); a
    Python bool or a bool tensor, one per window.  ``huber_delta``
    (pixels): Huber IRLS.  ``reduced_solver="cg"``: matrix-free PCG on the
    reduced system.  Low-parallax guards: ``lm_step_clip`` (each
    landmark's step at most that fraction of its distance to the nearest
    observing camera), ``per_landmark_accept`` (each landmark's step
    accepted on its own robust cost, at the candidate poses),
    ``damp_min`` (floor of the Levenberg parameter).  ``psum_axis``: only
    ``None``.  Leading axes of the problem are independent windows, each
    with its own cost, accept/reject and damping.

    Returns (poses, landmarks, (final cost, initial cost)).
    """
    _no_psum(psum_axis)
    _, err0 = _total_cost(prob, odo, huber_delta)
    poses, lms = prob.poses, prob.landmarks
    damp = torch.full(prob.poses.shape[:-2], damp_init, dtype=poses.dtype,
                      device=poses.device)
    err = err0
    for _ in range(num_iters):
        p0 = prob._replace(poses=poses, landmarks=lms)
        dpose, dlm = _schur_step(p0, damp, huber_delta, reduced_solver=reduced_solver,
                                 cg_iters=cg_iters, lm_eig_floor=lm_eig_floor,
                                 odo=odo, motion_only=motion_only)
        if lm_step_clip is not None:
            centers = lie.camera_center(lie.se3_exp(poses))                 # (...,K,3)
            d = torch.linalg.norm(lms[..., None, :, :] - centers[..., :, None, :], dim=-1)
            d_near = torch.amin(torch.where(prob.mask, d, torch.full_like(d, float("inf"))),
                                dim=-2)
            d_near = torch.where(torch.isfinite(d_near), d_near, torch.ones_like(d_near))
            dn = torch.linalg.norm(dlm, dim=-1)
            scale = torch.clamp(lm_step_clip * d_near / torch.clamp(dn, min=1e-12), max=1.0)
            dlm = dlm * scale[..., None]
        cand = prob._replace(poses=poses + dpose, landmarks=lms + dlm)
        res_new, err_new = _total_cost(cand, odo, huber_delta)
        ok = err_new < err
        ok_w = ok[..., None, None]
        if per_landmark_accept:
            res_old, _ = ba_residuals(prob._replace(poses=cand.poses, landmarks=lms),
                                      huber_delta)
            cl_old = _per_landmark_cost(res_old, prob.mask, huber_delta)
            cl_new = _per_landmark_cost(res_new, prob.mask, huber_delta)
            ok_l = (cl_new <= cl_old) & torch.all(torch.isfinite(cand.landmarks), dim=-1)
            poses = torch.where(ok_w, cand.poses, poses)
            lms = torch.where(ok_l[..., None], cand.landmarks, lms)
            _, err = _total_cost(prob._replace(poses=poses, landmarks=lms), odo,
                                 huber_delta)
        else:
            poses = torch.where(ok_w, cand.poses, poses)
            lms = torch.where(ok_w, cand.landmarks, lms)
            err = torch.where(ok, err_new, err)
        damp = torch.clamp(torch.where(ok, damp / damp_down, damp * damp_up), min=damp_min)
    return poses, lms, (err, err0)
