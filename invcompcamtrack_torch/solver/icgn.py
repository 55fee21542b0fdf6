"""Inverse-compositional Gauss-Newton 6-DoF pose tracking (port of
``invcompcamtrack_tpu/solver/icgn.py``).

The fused path (``window_cache=True`` and ``psz == 8``): per scale one
dual gather (K1, ``ops/patch_gather.py``, or with ``gather_prefetch=True``
its prefetch-pipelined twin K9, ``ops/patch_prefetch.py``) gives the reference patches,
their gradients and the query windows; per GN iteration one fused
resample + residual + projection (K2, ``ops/icgn_iter.py``) gives
``(gx, gy)`` per point.  The steepest-descent planes factor as
``sd_k = jx_k p_dx + jy_k p_dy``, so the Hessian is three patch moments
contracted with the Jacobian rows and ``rhs = jx gx + jy gy``; the
``(N, 6, psz*psz)`` steepest-descent tensor never exists.

The non-fused paths (any other even ``psz``, ``window_cache=False``, or
a float64 tracker)
are the JAX module's: ``extract_patches_grad`` (K6) gives the reference
patches, the steepest-descent tensor ``(..., N, 6, psz*psz)`` is built
and ``H = sd sd^T``; the query patches come per iteration from windows
cached once per scale (K7, then ``sample_from_windows``) or, with
``window_cache=False``, from the image itself (K5); ``rhs = sd pdiff``.
The contractions are ``torch.einsum`` (TF32 off), as the JAX module
leaves them to XLA.

``lax.while_loop`` becomes a fixed ``maxiter`` loop in which converged
lanes freeze (the update is masked by ``active``), so the loop needs no
host synchronisation; ``iters`` counts, on the device, the iterations
entered while any lane was active, which is what the JAX loop runs.

Pyramids whose levels are stacks of S planes ``(S, Hp, Wp)`` give S
independent problems, problem s on pair s with ``X (S, ..., N, 3)``: the
counterpart of ``jax.vmap`` over the JAX tracker, in one set of launches
(the multi-stream VO engine).  Everything but the gathers is per lane
already; the gathers read the stacks, and ``iters`` counts per problem.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from invcompcamtrack_torch import ICGNParams
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core import pose as pose_ops
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.image.patch import extract_patches, extract_patches_grad
from invcompcamtrack_torch.image.pyramid import Pyramid
from invcompcamtrack_torch.ops import _build, icgn_iter, patch_gather, patch_prefetch
from invcompcamtrack_torch.ops.linalg import cholesky_solve_sym
from invcompcamtrack_torch.ops.window_sample import (
    gather_windows_any,
    sample_from_windows,
    window_origin,
    window_taps,
)

# The reference seeds both norm trackers with 1e-10 so the first
# iteration always runs (reference: odometer.cpp:341-345).
_NORMDP_INIT = 1e-10


class ICGNAux(NamedTuple):
    """Per-scale diagnostics (coarse -> fine order)."""

    iters: torch.Tensor       # (S,) iterations executed per scale; (S, P)
    #                           for levels that are stacks of P planes
    normdp: torch.Tensor      # (S, ...) final |dp|_1 per scale
    valid_ref: torch.Tensor   # (S, ...) in-frustum reference points
    hessian: torch.Tensor | None = None  # (..., 6, 6) finest-scale GN
    #   normal matrix in the CALLER pose coordinates (donorm unfolded)


def sd_jacobian_rows(Xc: torch.Tensor, fx, fy):
    """Per-point pinhole Jacobian rows (jx, jy), each (..., N, 6)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zsq = z * z
    zero = torch.zeros_like(z)
    jx = torch.stack([fx / z, zero, -x / zsq * fx, -x * y / zsq * fx,
                      (1.0 + x * x / zsq) * fx, -y / z * fx], dim=-1)
    jy = torch.stack([zero, fy / z, -y / zsq * fy, -(1.0 + y * y / zsq) * fy,
                      x * y / zsq * fy, x / z * fy], dim=-1)
    return jx, jy


def steepest_descent_images(p_dx: torch.Tensor, p_dy: torch.Tensor,
                            Xc: torch.Tensor, fx, fy) -> torch.Tensor:
    """The 6 steepest-descent planes from gradient patches (..., N, psz,
    psz) and camera-frame points (..., N, 3) -> (..., N, 6, psz, psz):
    sd_k = jx_k * p_dx + jy_k * p_dy (reference: odometer.cpp:302-328)."""
    jx, jy = sd_jacobian_rows(Xc, fx, fy)
    return (jx[..., :, None, None] * p_dx[..., None, :, :]
            + jy[..., :, None, None] * p_dy[..., None, :, :])


def cam_level_padding(cfg: ICGNParams) -> int:
    """Pyramid levels are padded by psz."""
    return cfg.psz


def fused_supported(psz: int, win: int, dtype: torch.dtype = torch.float32) -> bool:
    """K1 and K2 are built for one patch and window side and compute in
    float32 (the rule of the JAX package's ``icgn_iter_pallas.supported``):
    a float64 tracker takes the non-fused path in float64, as JAX's does."""
    return psz == _build.PSZ and win == _build.WIN and dtype == torch.float32


def _outer_sum(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """sum_n a[n,k] b[n,l] m[n] over the point axis -> (..., 6, 6)."""
    return torch.matmul(a.transpose(-1, -2), b * m[..., None])


def _entry_origins(p, Xn, valid_ref, cam_level, cfg: ICGNParams) -> torch.Tensor:
    """Window origins at the scale-entry projections."""
    fx, fy, cx, cy, _, _ = cam_level
    uv_entry = pose_ops.project_points(lie.se3_exp(p), Xn, fx, fy, cx, cy)
    uv_entry = torch.where(torch.isfinite(uv_entry) & valid_ref[..., None],
                           uv_entry, torch.zeros_like(uv_entry))
    return window_origin(uv_entry, cfg.psz, cfg.window_size, cam_level_padding(cfg))


def _fused_scale(level_ref, level_new, uv_ref, Xc_safe, valid_ref, origins,
                 cam_level, cfg: ICGNParams):
    """K1 (or K9) once, then K2 per iteration -> (H, rhs_of(uv_new,
    valid_new)).  ``cfg.gather_split`` only sizes the JAX kernels' fast
    memory and changes nothing here."""
    fx, fy = cam_level[:2]
    lead, N = uv_ref.shape[:-2], uv_ref.shape[-2]
    pad, win = cam_level_padding(cfg), cfg.window_size
    # [4] ONE dual gather per scale: reference patches + gradients and
    # the query windows at the scale-entry projections; K9 where the
    # caller asks for it and its shape rule holds, else K1 (the same
    # outputs, bit for bit)
    gather = (patch_prefetch.gather_ref_grad_windows_prefetch
              if cfg.gather_prefetch and patch_prefetch.supported(cfg.psz, win)
              else patch_gather.gather_ref_grad_windows)
    p_img, p_dx, p_dy, qwin = gather(
        level_ref, level_new.img, uv_ref, origins, cfg.psz, pad, win,
        patch_norm=cfg.dopatchnorm)
    # [5]+[6] masked Jacobian rows and the Hessian from three patch moments
    jx, jy = sd_jacobian_rows(Xc_safe, fx, fy)
    vmask = valid_ref[..., None].to(p_img.dtype)
    jx = jx * vmask
    jy = jy * vmask
    a_m = torch.sum(p_dx * p_dx, dim=(-2, -1))
    b_m = torch.sum(p_dx * p_dy, dim=(-2, -1))
    c_m = torch.sum(p_dy * p_dy, dim=(-2, -1))
    H = (_outer_sum(jx, jx, a_m) + _outer_sum(jx, jy, b_m)
         + _outer_sum(jy, jx, b_m) + _outer_sum(jy, jy, c_m))

    # per-iteration planes, stored bf16 when asked (H is built above
    # from the f32 planes)
    store_dt = torch.bfloat16 if cfg.bf16_gather else p_img.dtype
    npix = cfg.novals
    ref_f = (p_img * valid_ref[..., None, None].to(p_img.dtype)
             ).reshape(-1, npix).to(store_dt).contiguous()
    pdx_f = p_dx.reshape(-1, npix).to(store_dt).contiguous()
    pdy_f = p_dy.reshape(-1, npix).to(store_dt).contiguous()
    qwin_f = qwin.reshape(-1, win * win).to(store_dt).contiguous()

    def rhs_of(uv_new, valid_new):
        # [8]+[9a] resample + residual + projection: ONE kernel
        row_w, col_w, wts = window_taps(uv_new, origins, cfg.psz, pad, win)
        g = icgn_iter.fused_resample_project(
            qwin_f, ref_f, pdx_f, pdy_f,
            row_w.reshape(-1).contiguous(), col_w.reshape(-1).contiguous(),
            wts.reshape(-1, 4).float().contiguous(),
            valid_new.reshape(-1).float().contiguous(),
            patch_norm=cfg.dopatchnorm).reshape(lead + (N, 2)).to(jx.dtype)
        # rhs = jx^T gx + jy^T gy, with gx and gy each contiguous (one copy):
        # a strided vector sends one problem's product down another
        # summation path than a batch's on the CPU, and a stream of the
        # multi-stream engine would then depend on the streams beside it
        gt = g.transpose(-1, -2).contiguous()
        return (torch.matmul(jx.transpose(-1, -2), gt[..., 0, :, None])
                + torch.matmul(jy.transpose(-1, -2), gt[..., 1, :, None]))[..., 0]

    return H, rhs_of


def _sd_scale(level_ref, level_new, uv_ref, Xc_safe, valid_ref, origins,
              cam_level, cfg: ICGNParams):
    """The steepest-descent path: K6 once (and K7 once with the window
    cache), then per iteration a resample from the windows or K5 ->
    (H, rhs_of(uv_new, valid_new))."""
    fx, fy = cam_level[:2]
    lead, N = uv_ref.shape[:-2], uv_ref.shape[-2]
    pad, npix = cam_level_padding(cfg), cfg.novals
    p_img, p_dx, p_dy = extract_patches_grad(
        level_ref.img, level_ref.dx, level_ref.dy, uv_ref, cfg.psz, pad,
        patch_norm=cfg.dopatchnorm)
    # [5] steepest-descent planes, masked (explicit zeros)
    sd = steepest_descent_images(p_dx, p_dy, Xc_safe, fx, fy)
    sd = sd * valid_ref[..., None, None, None].to(sd.dtype)
    sd_flat = sd.reshape(lead + (N, 6, npix))
    # [6] 6x6 Hessian: one contraction over (point, pixel) pairs
    H = torch.einsum("...nkp,...nlp->...kl", sd_flat, sd_flat)
    ref_flat = (p_img * valid_ref[..., None, None].to(p_img.dtype)
                ).reshape(lead + (N, npix))
    qwin = (gather_windows_any(level_new.img, origins, cfg.window_size)
            if cfg.window_cache else None)

    def rhs_of(uv_new, valid_new):
        # [8] query patches, [9a] error image and its sd projection
        if cfg.window_cache:
            q = sample_from_windows(qwin, origins, uv_new, cfg.psz, pad,
                                    patch_norm=cfg.dopatchnorm)
        else:
            q = extract_patches(level_new.img, uv_new, cfg.psz, pad,
                                patch_norm=cfg.dopatchnorm)
        pdiff = (ref_flat - q.reshape(lead + (N, npix))) * valid_new[..., None].to(q.dtype)
        return torch.einsum("...nkp,...np->...k", sd_flat, pdiff)

    return H, rhs_of


def _track_one_scale(level_ref, level_new, Xn, Xc_ref, uv_ref, p, cam_level,
                     cfg: ICGNParams, point_mask=None, scale_index: int = 0):
    fx, fy, cx, cy, swo, sho = cam_level
    lead = Xn.shape[:-2]

    valid_ref = pose_ops.in_frustum(uv_ref, swo, sho) & (Xc_ref[..., 2] > 0)
    if point_mask is not None:
        valid_ref = valid_ref & point_mask
    # NaN/inf projections would poison the bilinear weights: sample
    # invalid points at a harmless fixed position instead
    uv_ref = torch.where(valid_ref[..., None], uv_ref, torch.zeros_like(uv_ref))
    # invalid points are sanitised before the Jacobian divides by z
    Xc_safe = torch.where(valid_ref[..., None], Xc_ref, torch.ones_like(Xc_ref))

    origins = (_entry_origins(p, Xn, valid_ref, cam_level, cfg)
               if cfg.window_cache else None)
    scale = (_fused_scale if cfg.window_cache
             and fused_supported(cfg.psz, cfg.window_size, uv_ref.dtype) else _sd_scale)
    H, rhs_of = scale(level_ref, level_new, uv_ref, Xc_safe, valid_ref, origins,
                      cam_level, cfg)

    dev = p.device
    # per problem of a stack of planes (jax.vmap's count), else one count
    stacked = level_ref.img.dim() == 3
    it_count = torch.zeros((), dtype=torch.int32, device=dev)
    normdp = torch.full(lead, _NORMDP_INIT, dtype=p.dtype, device=dev)
    active = torch.ones(lead, dtype=torch.bool, device=dev)
    G_cur = lie.se3_exp(p)
    for it in range(cfg.maxiter):
        entered = (active.reshape(active.shape[0], -1).any(-1) if stacked
                   else torch.any(active))
        it_count = it_count + entered.to(torch.int32)
        # [7] project with the current pose (chirality-gated)
        uv_new, Xc_new = pose_ops.project_points(G_cur, Xn, fx, fy, cx, cy,
                                                 return_cam=True)
        valid_new = (pose_ops.in_frustum(uv_new, swo, sho) & valid_ref
                     & (Xc_new[..., 2] > 0))
        uv_new = torch.where(valid_new[..., None], uv_new, torch.zeros_like(uv_new))
        rhs = rhs_of(uv_new, valid_new)
        # [9b] 6x6 normal equations; [10] additive coefficient update
        delta = cholesky_solve_sym(H, rhs) * active[..., None].to(p.dtype)
        p = p + delta
        G_cur = lie.se3_exp(p)
        ndp_new = torch.sum(torch.abs(delta), dim=-1)
        normdp = torch.where(active, ndp_new, normdp)
        if it == 0:  # every lane is active on entry
            normdp_init = ndp_new
        active = active & ((normdp / normdp_init) > cfg.normdp_ratio)
        if cfg.verbosity >= 2 and bool(entered.any()):
            # the reference's per-iteration print; syncs only here
            print(f"Sc{scale_index:02d},It{it:02d}: {float(torch.mean(normdp))}")
    return p, (it_count, normdp, torch.sum(valid_ref, dim=-1), H)


def track_pose(pyr_ref: Pyramid, pyr_new: Pyramid, X: torch.Tensor,
               p_init: torch.Tensor, cam: CameraPyramid, cfg: ICGNParams,
               point_mask: torch.Tensor | None = None,
               return_aux: bool = False):
    """Track the 6-DoF pose aligning reference patches to the new image.

    pyr_ref/pyr_new: pyramids with >= cfg.lv_f + 1 levels, padded by psz.
    X: (..., N, 3) world points; p_init: (..., 6) se(3) pose of
    [R | t] world->cam.  Returns the refined pose (and ICGNAux).  Levels
    that are stacks of S planes take X (S, ..., N, 3), p_init (S, ..., 6)
    and point_mask (S, ..., N): problem s tracks on pair s.
    """
    dtype = p_init.dtype
    X = X.to(dtype)
    if cfg.donorm:
        Xn, mean, varval = pose_ops.normalize_points(X, mask=point_mask)
        p = pose_ops.normalize_pose(p_init, mean, varval)
    else:
        Xn, mean, varval = X, None, None
        p = p_init

    # camera-frame points at the initial pose serve every scale's
    # Jacobians (the inverse-compositional approximation)
    G0 = lie.se3_exp(p)
    Xc_ref = pose_ops.transform_points(G0, Xn)
    uv_ref = {s: pose_ops.project_points(G0, Xn, *cam.level(s)[:4])
              for s in range(cfg.lv_l, cfg.lv_f + 1)}

    iters, normdps, validcnt = [], [], []
    H_fine = None
    for s in range(cfg.lv_f, cfg.lv_l - 1, -1):  # coarse -> fine
        p, (it, ndp, vc, H_fine) = _track_one_scale(
            pyr_ref[s], pyr_new[s], Xn, Xc_ref, uv_ref[s], p, cam.level(s), cfg,
            point_mask=point_mask, scale_index=s)
        iters.append(it)
        normdps.append(ndp)
        validcnt.append(vc)

    if cfg.donorm:
        p = pose_ops.unnormalize_pose(p, mean, varval)
    if not return_aux:
        return p
    if cfg.donorm:
        # the GN Hessian lives in normalised pose coordinates
        # p_n = normalize_pose(p, mean, varval): H_u = B^T H B
        jac = torch.func.jacfwd(pose_ops.normalize_pose)
        for _ in range(p.dim() - 1):
            jac = torch.func.vmap(jac)
        # (jacfwd may carry float32 primals with float64 tangents)
        B = jac(p, mean, varval).to(H_fine.dtype)
        H_fine = torch.matmul(torch.matmul(B.transpose(-1, -2), H_fine), B)
    return p, ICGNAux(iters=torch.stack(iters), normdp=torch.stack(normdps),
                      valid_ref=torch.stack(validcnt), hessian=H_fine)


def track_pose_batch(pyr_ref: Pyramid, pyr_new: Pyramid, X: torch.Tensor,
                     p_init: torch.Tensor, cam: CameraPyramid, cfg: ICGNParams,
                     point_mask: torch.Tensor | None = None):
    """Batched tracking over a shared image pair: X (B, N, 3), p_init
    (B, 6), optional point_mask (B, N) -> (B, 6).  All B*N points go
    through one launch per scale (K1, or K6 and K7) and one per
    iteration (K2, or K5 without the window cache)."""
    return track_pose(pyr_ref, pyr_new, X, p_init, cam, cfg,
                      point_mask=point_mask)

