"""Pose-graph optimisation over relative SE(3) constraints (port of
``invcompcamtrack_tpu/ba/pose_graph.py``).

K node poses (se(3) coefficients, world -> cam) and E edges measuring the
relative pose ``G_ij = G_j . G_i^{-1}`` (cam_i -> cam_j).  Residual per
edge: ``log(G_meas^{-1} . G_j . G_i^{-1})`` (6,).  Damped Gauss-Newton
with forward-mode Jacobians (``torch.func.vmap(torch.func.jacfwd)``);
the (6K, 6K) system is dense and assembled by ``index_put_`` with
accumulation where the JAX module scatter-adds; the scan is a Python loop
of ``num_iters`` steps, the solve ``torch.linalg.solve_ex`` (no host
sync), the accept/reject a ``torch.where``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from invcompcamtrack_torch.core import lie


class PoseGraph(NamedTuple):
    poses: torch.Tensor        # (K, 6)
    edges_i: torch.Tensor      # (E,) int source node
    edges_j: torch.Tensor      # (E,) int target node
    edges_meas: torch.Tensor   # (E, 6) measured relative pose log
    edges_weight: torch.Tensor  # (E,) scalar information weight
    fixed_mask: torch.Tensor   # (K,) bool, True = anchored


def relative_pose(p_i: torch.Tensor, p_j: torch.Tensor) -> torch.Tensor:
    """log(G_j . G_i^{-1}), the edge measurement convention."""
    G = lie.se3_compose(lie.se3_exp(p_j), lie.se3_inverse(lie.se3_exp(p_i)))
    return lie.se3_log(G)


def _edge_residual(p_i, p_j, meas):
    G_rel = lie.se3_compose(lie.se3_exp(p_j), lie.se3_inverse(lie.se3_exp(p_i)))
    G_err = lie.se3_compose(lie.se3_inverse(lie.se3_exp(meas)), G_rel)
    return lie.se3_log(G_err)


def graph_residuals(g: PoseGraph) -> torch.Tensor:
    """(E, 6) residuals, each times sqrt(weight)."""
    ei, ej = g.edges_i.long(), g.edges_j.long()
    r = _edge_residual(g.poses[ei], g.poses[ej], g.edges_meas)
    return r * torch.sqrt(g.edges_weight)[:, None]


def optimize_pose_graph(g: PoseGraph, num_iters: int = 10,
                        damp_init: float = 1e-4, damp_fct: float = 10.0):
    """Damped GN; returns (poses, (err, err0)) with err the mean squared
    residual."""
    K = g.poses.shape[0]
    dt, dev = g.poses.dtype, g.poses.device
    ei, ej = g.edges_i.long(), g.edges_j.long()
    jac_fn = torch.func.vmap(torch.func.jacfwd(_edge_residual, argnums=(0, 1)))
    w = torch.sqrt(g.edges_weight)[:, None, None]
    free_i = (~g.fixed_mask[ei])[:, None, None]
    free_j = (~g.fixed_mask[ej])[:, None, None]
    a6 = torch.arange(6, device=dev)
    rows, cols = a6[None, :, None], a6[None, None, :]

    def block_index(a, b):
        """H's (K, 6, K, 6) index of block (a_e, b_e) of every edge."""
        return (a[:, None, None], rows, b[:, None, None], cols)

    def build_system(poses):
        r = graph_residuals(g._replace(poses=poses))
        Ji, Jj = (J.to(dt) for J in jac_fn(poses[ei], poses[ej], g.edges_meas))  # (E, 6, 6)
        # weighted, with the columns of fixed nodes zeroed
        Ji = Ji * w * free_i
        Jj = Jj * w * free_j
        Hii = torch.einsum("eri,erj->eij", Ji, Ji)
        Hjj = torch.einsum("eri,erj->eij", Jj, Jj)
        Hij = torch.einsum("eri,erj->eij", Ji, Jj)
        bi = torch.einsum("eri,er->ei", Ji, r)
        bj = torch.einsum("eri,er->ei", Jj, r)
        H = torch.zeros((K, 6, K, 6), dtype=dt, device=dev)
        H.index_put_(block_index(ei, ei), Hii, accumulate=True)
        H.index_put_(block_index(ej, ej), Hjj, accumulate=True)
        H.index_put_(block_index(ei, ej), Hij, accumulate=True)
        H.index_put_(block_index(ej, ei), Hij.transpose(-1, -2), accumulate=True)
        b = torch.zeros((K, 6), dtype=dt, device=dev)
        b.index_put_((ei,), bi, accumulate=True)
        b.index_put_((ej,), bj, accumulate=True)
        return H.reshape(6 * K, 6 * K), b.reshape(-1), torch.mean(r * r)

    # anchor the fixed nodes + damping
    fixed_diag = torch.repeat_interleave(g.fixed_mask.to(dt), 6)
    _, _, err0 = build_system(g.poses)
    poses, damp, err = g.poses, torch.tensor(damp_init, dtype=dt, device=dev), err0
    for _ in range(num_iters):
        H, b, _ = build_system(poses)
        A = H + torch.diag(damp * torch.clamp(torch.diagonal(H), min=1e-9) + fixed_diag)
        delta = torch.linalg.solve_ex(A, b[:, None], check_errors=False)[0].reshape(K, 6)
        delta = delta * (~g.fixed_mask)[:, None]
        cand = poses - delta
        _, _, err_new = build_system(cand)
        ok = err_new < err
        poses = torch.where(ok, cand, poses)
        damp = torch.where(ok, damp / damp_fct, damp * damp_fct)
        err = torch.where(ok, err_new, err)
    return poses, (err, err0)
