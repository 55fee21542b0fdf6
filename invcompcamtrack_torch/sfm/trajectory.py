"""Multi-step 3-D point-trajectory refinement with bending-energy
smoothing (port of ``invcompcamtrack_tpu/sfm/trajectory.py``).

A moving 3-D point observed over ``T`` time steps by ``C`` cameras per
step is refined by joint nonlinear least squares over all T positions:
reprojection residuals plus a smoothing-spline bending-energy prior
coupling the steps (behavioural spec:
``func_refine_pt3d_reprojection_sp_smoothing``, reference:
misc_src/run_3DPoint_triangulation_error_test.ipynb cell 1).  The JAX
module's quirks are kept: the stiffness matrix's end spacings are doubled
and both arms of each second difference are divided by the row's own
``h`` (``bending_stiffness``); the prior adds three residual entries,
``sp_weight * diag(X^T K X)``; ``sp_weight=None`` decouples the steps.

One LM solver runs the whole point batch: ``torch.func.vmap`` over
``torch.func.jacfwd`` where the JAX module takes ``jax.vmap(jax.jacfwd)``,
a Python loop of ``num_iters`` steps where it scans, damped normal
equations solved by ``torch.linalg.solve_ex`` (no host sync) and every
accept/reject a ``torch.where`` per point.
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.core import pose as pose_ops
from invcompcamtrack_torch.device import resolve


def bending_stiffness(T: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """(T, T) bending-energy stiffness K = D^T W^{-1} D with the
    reference's quirks (uniform unit spacing, end spacings 2, both arms
    of D divided by the row's own h); on the card unless ``device`` says
    otherwise."""
    dev = resolve(device)
    h = torch.ones((T - 2,), dtype=dtype, device=dev)
    h[0] = 2.0
    h[-1] = 2.0
    r = torch.arange(T - 2, device=dev)
    D = torch.zeros((T - 2, T), dtype=dtype, device=dev)
    D[r, r] = 1.0 / h
    D[r, r + 1] = -2.0 / h
    D[r, r + 2] = 1.0 / h
    W = (torch.diag(2.0 * h / 3.0) + torch.diag(h[1:] / 6.0, 1)
         + torch.diag(h[1:] / 6.0, -1))
    return D.T @ torch.linalg.solve_ex(W, D, check_errors=False)[0]


def _residuals(X, R, tw, obs, obs_mask, fc, cc, K_sm, sp_weight):
    """Residual vector of one trajectory.

    X: (T, 3); R: (T, C, 3, 3); tw: (T, C, 3) world camera centres;
    obs: (T, C, 2).  Returns (2*T*C + 3,).
    """
    proj = pose_ops.reproject(X[:, None, None, :], R, tw, fc, cc)[..., 0, :]  # (T, C, 2)
    r = (proj - obs) * obs_mask[..., None]
    if sp_weight is not None:
        bend = torch.sum((K_sm @ X) * X, dim=0) * sp_weight   # diag(X^T K X), (3,)
    else:
        bend = torch.zeros((3,), dtype=X.dtype, device=X.device)
    return torch.cat([r.reshape(-1), bend])


def refine_point_trajectory(R, tw, obs: torch.Tensor, X0, fc, cc, sp_weight=None,
                            obs_mask=None, num_iters: int = 25,
                            damp_init: float = 1e-4, damp_up: float = 10.0,
                            damp_down: float = 10.0) -> torch.Tensor:
    """LM refinement of moving-point trajectories.

    R: (T, C, 3, 3); tw: (T, C, 3); obs: (..., T, C, 2) measured pixels,
    a tensor on the device to run on; X0: (..., T, 3) initial
    trajectories (e.g. per-step triangulations).  R, tw, X0, fc and cc
    go to obs's device and dtype.  Returns the refined (..., T, 3)
    trajectories.  Cameras are shared across the point batch;
    observations and initialisations batch over leading dims.
    """
    def like(a):
        return torch.as_tensor(a, dtype=obs.dtype, device=obs.device)

    R, tw, X0, fc, cc = (like(a) for a in (R, tw, X0, fc, cc))
    T = X0.shape[-2]
    lead = X0.shape[:-2]
    if obs_mask is None:
        obs_mask = torch.ones(obs.shape[:-1], dtype=torch.bool, device=obs.device)
    K_sm = bending_stiffness(T, obs.dtype, obs.device)

    x = X0.reshape(-1, 3 * T)
    o = obs.reshape((-1,) + tuple(obs.shape[-3:]))
    om = obs_mask.reshape((-1,) + tuple(obs_mask.shape[-2:]))

    def res_fn(xflat, o1, om1):
        return _residuals(xflat.reshape(T, 3), R, tw, o1, om1, fc, cc, K_sm, sp_weight)

    res_b = torch.func.vmap(res_fn)
    jac_b = torch.func.vmap(torch.func.jacfwd(res_fn))

    damp = torch.full((x.shape[0],), damp_init, dtype=x.dtype, device=x.device)
    err = torch.sum(res_b(x, o, om) ** 2, dim=-1)
    for _ in range(num_iters):
        r = res_b(x, o, om)
        J = jac_b(x, o, om)                                  # (B, M, 3T)
        H = torch.einsum("bki,bkj->bij", J, J)
        diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-10)
        H = H + damp[:, None, None] * torch.diag_embed(diag)
        g = -torch.einsum("bki,bk->bi", J, r)
        dx = torch.linalg.solve_ex(H, g[..., None], check_errors=False)[0][..., 0]
        cand = x + dx
        err_new = torch.sum(res_b(cand, o, om) ** 2, dim=-1)
        ok = err_new < err
        x = torch.where(ok[:, None], cand, x)
        damp = torch.where(ok, damp / damp_down, damp * damp_up)
        err = torch.where(ok, err_new, err)
    return x.reshape(lead + (T, 3))
