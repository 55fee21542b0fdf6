"""Temporal (keyframe-sharded) BA at scale with the PyTorch port, the
counterpart of ``examples/run_temporal_scale.py``.

    python examples/run_temporal_scale_torch.py --world 1,2,4 --out temporal_scale.json
    python examples/run_temporal_scale_torch.py --device cpu --K 8 --L 64 --world 2

Builds a K=32-keyframe / L=2048-landmark window (0.3 px observation
noise, 5 % 40 px gross outliers, drifting initial poses, odometry-chain
priors) in which each landmark is seen by a consecutive band of 8
keyframes, and solves it two ways:

- one device: the engine's ``ba_solve`` with the CG reduced solver;
- ``temporal_ba_solve`` with the keyframe axis sharded over a world of
  1, 2 or 4 ranks (``--world``), spawned here as gloo ranks that share
  the one device: on the card gloo all-reduces the CUDA tensors and the
  ring halos go through host copies.

Prints one JSON line per solve (pose error against the truth, final and
initial cost, milliseconds per solve by the host clock around a
synchronised run) and writes them with the device's name to ``--out``.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from invcompcamtrack_torch.ba.temporal import TemporalBAProblem, temporal_ba_solve
from invcompcamtrack_torch.ba.window import BAProblem, OdoFactors, ba_residuals, ba_solve
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.device import resolve
from invcompcamtrack_torch.parallel.model import temporal_ba_psum_bytes
from invcompcamtrack_torch.parallel.runtime import initialize_distributed, spawn_world

K, L = 32, 2048
BAND = 8          # keyframes observing each landmark (sliding coverage)
CG_ITERS = 64
NUM_ITERS = 8


def build_problem(device=None, K: int = K, L: int = L, band_len: int = BAND):
    """The seeded long window on ``device``: (BAProblem, true poses (K, 6),
    odometry factors for ``ba_solve``, the TemporalBAProblem of the same
    window with its linearised chain)."""
    dev = resolve(device)
    rng = np.random.default_rng(3)
    f32 = torch.float32
    # forward trajectory with gentle sway; landmarks spread along it
    poses_gt = np.zeros((K, 6), np.float32)
    for k in range(1, K):
        poses_gt[k] = poses_gt[k - 1] + np.r_[
            0.01 * np.sin(k * 0.3), 0.005, 0.25, rng.normal(size=3) * 2e-3].astype(np.float32)
    pg = torch.tensor(poses_gt, device=dev)
    centers = lie.camera_center(lie.se3_exp(pg)).cpu().numpy()
    # landmark l belongs to band b = l * (K - band_len) // L: visible to
    # keyframes [b, b + band_len); placed ahead of its band's cameras
    band = (np.arange(L) * max(K - band_len, 1) // L).astype(np.int32)
    lms_gt = (centers[band] + rng.normal(size=(L, 3)) * [2.0, 2.0, 1.0]
              + [0, 0, 8.0]).astype(np.float32)
    kf_idx = np.arange(K)[:, None]
    mask = (kf_idx >= band[None, :]) & (kf_idx < band[None, :] + band_len)

    def t(a, dt=f32):
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)

    prob0 = BAProblem(poses=pg, landmarks=t(lms_gt), obs=torch.zeros((K, L, 2), device=dev),
                      mask=t(mask, torch.bool), fx=t(520.0), fy=t(525.0), cx=t(320.0),
                      cy=t(240.0), fixed_pose_mask=t(np.arange(K) < 2, torch.bool))
    res0, _ = ba_residuals(prob0)
    obs = -res0  # exact projections
    # drop observations that fall outside a 640x480 frame
    inb = (obs[..., 0] > 0) & (obs[..., 0] < 640) & (obs[..., 1] > 0) & (obs[..., 1] < 480)
    mask_t = prob0.mask & inb
    obs = obs + t(rng.normal(size=obs.shape) * 0.3)
    outlier = t(rng.uniform(size=(K, L)) < 0.05, torch.bool)
    obs = torch.where(outlier[..., None], obs + t(rng.normal(size=obs.shape) * 40.0), obs)

    # drifting initial poses (random-walk odometry error) + noisy map
    drift = np.cumsum(np.c_[rng.normal(size=(K, 3)) * 4e-3, rng.normal(size=(K, 3)) * 1e-3],
                      axis=0)
    drift[:2] = 0.0
    prob = prob0._replace(poses=t(poses_gt + drift),
                          landmarks=t(lms_gt + rng.normal(size=(L, 3)) * 0.05),
                          obs=obs, mask=mask_t)

    # odometry chain measurements from the truth
    G = lie.se3_exp(pg)
    rel = lie.se3_compose(G, lie.se3_inverse(torch.roll(G, 1, dims=0)))
    odo = OdoFactors(rel=rel, mask=t(np.arange(K) >= 1, torch.bool), w_t=t(100.0),
                     w_r=t(1000.0))
    rel_next = torch.roll(rel, -1, dims=0)
    odom = lie.se3_log(lie.se3_compose(rel_next, lie.se3_exp(prob.poses))) - prob.poses
    w6 = torch.cat([torch.full((3,), 1e4, device=dev), torch.full((3,), 1e6, device=dev)])
    w = torch.where((torch.arange(K, device=dev) < K - 1)[:, None], w6, torch.zeros_like(w6))
    tprob = TemporalBAProblem(poses=prob.poses, landmarks=prob.landmarks, obs=prob.obs,
                              mask=prob.mask, fx=prob.fx, fy=prob.fy, cx=prob.cx, cy=prob.cy,
                              fixed_pose_mask=prob.fixed_pose_mask, odom=odom, odom_weight=w)
    return prob, pg, odo, tprob


def solve_replicated(prob, odo, cg_iters: int = CG_ITERS, num_iters: int = NUM_ITERS):
    """The engine's single-device joint solve (CG reduced solver)."""
    return ba_solve(prob, num_iters=num_iters, huber_delta=1.5, reduced_solver="cg",
                    cg_iters=cg_iters, lm_step_clip=0.1, damp_min=1e-5, lm_eig_floor=5e-3,
                    odo=odo)


def solve_temporal(tprob, mesh, cg_iters: int = CG_ITERS, num_iters: int = NUM_ITERS):
    return temporal_ba_solve(tprob, mesh, num_iters=num_iters, huber_delta=1.5,
                             cg_iters=cg_iters)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev, reps: int):
    out = fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) / reps * 1e3


def _row(solver, n, out, pg, ms, bytes_):
    poses, _, (err, err0) = out
    return {"solver": solver, "ranks": n,
            "max_pose_err": float((poses - pg)[2:].abs().max()),
            "err": float(err), "err0": float(err0), "solve_ms": ms, "link_bytes": bytes_}


def _rank(rank: int, n: int, init: str, args):
    """One rank of a temporal world: build the same seeded problem, solve,
    and return the row and the (poses, landmarks)."""
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve(args.device)
    initialize_distributed(coordinator=init, num_processes=n, process_id=rank,
                           backend="gloo", retries=1)
    mesh = init_device_mesh(dev.type, (n,), mesh_dim_names=("seq",))
    _, pg, _, tprob = build_problem(dev, args.K, args.L, args.band)
    out, ms = _timed(lambda: solve_temporal(tprob, mesh, args.cg_iters, args.iters), dev,
                     args.reps)
    row = _row("temporal_ba_solve (keyframe-sharded)", n, out, pg, ms,
               temporal_ba_psum_bytes(args.L, args.iters, args.cg_iters))
    torch.distributed.destroy_process_group()
    return row, [a.cpu().numpy() for a in out[:2]]


def run_world(n: int, args, tmp: pathlib.Path, timeout_s: float = 600.0):
    """Spawn an n-rank gloo world on the device; returns rank 0's row and
    its (poses, landmarks)."""
    return spawn_world(_rank, n, tmp / f"world{n}", timeout_s, args=(args,))[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--world", default="1,2,4", help="comma-separated rank counts")
    ap.add_argument("--K", type=int, default=K)
    ap.add_argument("--L", type=int, default=L)
    ap.add_argument("--band", type=int, default=BAND)
    ap.add_argument("--cg-iters", type=int, default=CG_ITERS)
    ap.add_argument("--iters", type=int, default=NUM_ITERS)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="JSON file for the rows")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    args.device = str(dev)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    prob, pg, odo, _ = build_problem(dev, args.K, args.L, args.band)
    n_obs = int(prob.mask.sum())
    pe_in = float((prob.poses - pg)[2:].abs().max())
    print(f"window: K={args.K} keyframes, L={args.L} landmarks, {n_obs} observations, "
          f"band={args.band}; max initial pose err {pe_in:.4f}; device {kind}")
    out, ms = _timed(lambda: solve_replicated(prob, odo, args.cg_iters, args.iters), dev,
                     args.reps)
    rows = [_row("ba_solve (cg), one device", 1, out, pg, ms, 0)]
    print(json.dumps(rows[-1]))
    with tempfile.TemporaryDirectory() as tmp:
        for n in (int(w) for w in args.world.split(",")):
            row, _ = run_world(n, args, pathlib.Path(tmp))
            rows.append(row)
            print(json.dumps(row))
    result = {"metric": "temporal_ba_scale", "device": kind, "K": args.K, "L": args.L,
              "band": args.band, "n_obs": n_obs, "max_initial_pose_err": pe_in, "rows": rows}
    print(json.dumps(result))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    return result


if __name__ == "__main__":
    main()
