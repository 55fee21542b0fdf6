"""Landmark-sharded distributed bundle adjustment (port of
``invcompcamtrack_tpu/ba/distributed.py``).

The landmark axis is partitioned over a mesh axis (default ``"model"``):
every pose-indexed contraction over landmarks (H_pp, b_p, the Schur
products) is a local partial all-reduced over the axis's process group.
The reduced camera system is solved redundantly on every rank (it is
tiny) and the landmarks back-substitute locally.  It is the same
``ba_solve`` the one-device engine uses, with ``psum_axis`` set to the
group, so it carries every solver option.

The JAX module runs ``ba_solve`` inside ``shard_map``; here every rank
of the world calls this function on the same (replicated) problem,
takes its contiguous shard of the landmarks, observations and mask, and
returns the same replicated result: the poses every rank computed alike,
and the landmark table gathered from the shards.
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.ba.window import BAProblem, OdoFactors, ba_solve
from invcompcamtrack_torch.parallel.comm import axis_size, psum


def shard_slice(n_total: int, mesh, axis: str) -> slice:
    """This rank's contiguous block of ``n_total`` rows along ``axis``
    (``P(axis)``); ``n_total`` must divide by the axis size."""
    n = axis_size(mesh, axis)
    if n_total % n != 0:
        raise ValueError(f"{n_total} rows not divisible by {axis} axis size {n}")
    d = n_total // n
    i = mesh.get_local_rank(axis)
    return slice(i * d, (i + 1) * d)


def gather_rows(local: torch.Tensor, n_total: int, rows: slice, group,
                dim: int) -> torch.Tensor:
    """The shards of every rank put back into one replicated tensor with
    ``n_total`` rows along ``dim``: an all-reduce of a zero-filled
    tensor holding this rank's rows (gloo all-reduces CUDA tensors, where
    its all_gather does not)."""
    shape = list(local.shape)
    shape[dim] = n_total
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    full.narrow(dim, rows.start, rows.stop - rows.start).copy_(local)
    return psum(full, group)


def ba_solve_sharded(prob: BAProblem, mesh, num_iters: int = 10,
                     damp_init: float = 1e-3, damp_up: float = 10.0,
                     damp_down: float = 10.0, axis: str = "model",
                     huber_delta: float | None = None,
                     reduced_solver: str = "dense", cg_iters: int = 32,
                     lm_step_clip: float | None = None,
                     per_landmark_accept: bool = False,
                     damp_min: float = 0.0,
                     lm_eig_floor: float | None = None,
                     odo: OdoFactors | None = None,
                     motion_only=False):
    """Distributed LM loop.  The landmark count L of ``prob`` must divide
    by the size of ``mesh`` axis ``axis``; observations and mask shard
    with the landmarks.  Accepts every ``ba_solve`` option (same
    defaults), and problems with leading window axes as ``ba_solve``
    does.  Every rank calls it with the same problem.

    Returns (poses, landmarks (..., L, 3), (err, err0)) like ``ba_solve``,
    the same on every rank.
    """
    L = prob.landmarks.shape[-2]
    rows = shard_slice(L, mesh, axis)
    group = mesh.get_group(axis)
    local = prob._replace(landmarks=prob.landmarks[..., rows, :],
                          obs=prob.obs[..., rows, :], mask=prob.mask[..., rows])
    poses, lms, (err, err0) = ba_solve(
        local, num_iters=num_iters, damp_init=damp_init, damp_up=damp_up,
        damp_down=damp_down, huber_delta=huber_delta,
        reduced_solver=reduced_solver, cg_iters=cg_iters,
        lm_step_clip=lm_step_clip, per_landmark_accept=per_landmark_accept,
        damp_min=damp_min, lm_eig_floor=lm_eig_floor, odo=odo,
        psum_axis=group, motion_only=motion_only)
    return poses, gather_rows(lms, L, rows, group, dim=-2), (err, err0)
