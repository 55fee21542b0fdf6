"""The accuracy suite with the PyTorch/CUDA port: long-sequence ATE/RPE of
the VO engine, the counterpart of ``examples/run_accuracy_suite.py``
(reference: misc_src/pose_tracking_acc.txt:1-57).

Long analytic-GT synthetic sequences (exact rendering of a textured
world plane, ``vo/synthetic.py``) with three motion profiles shaped after
the target workloads:

- forward:  dominant forward motion + gentle yaw (KITTI-style),
- lateral:  sustained lateral drive (map-turnover regime),
- handheld: oscillatory 6-DoF motion (EuRoC-style).

By default 1280x720 at fc (1000, 1200), 200 frames, through the engine in
32-frame ``run_frames`` chunks.  Writes ACCURACY_SUITE_torch.md (the JAX
suite writes ACCURACY.md, over the accuracy log's own; this twin does
not).  Runs on the card unless ``--device cpu`` is given.

Departures from the JAX suite, both deliberate:

- Each profile's scene and path come from ``default_rng(zlib.crc32(
  profile))``.  The JAX suite seeds with ``hash(profile) % 2**31``, and
  Python salts ``str`` hashes per process (``PYTHONHASHSEED``), so its
  scenes and paths change from run to run and no run of it can be
  repeated or matched.
- Poses and centres come from the port's ``core/lie.py`` in float64
  (the JAX suite's come from its float64 test oracle).

Usage: python examples/run_accuracy_suite_torch.py [--frames 200]
       [--out ACCURACY_SUITE_torch.md] [--device cpu]
"""

import argparse
import pathlib
import sys
import time
import zlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from invcompcamtrack_torch.config import ICGNParams
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.device import card_line, resolve
from invcompcamtrack_torch.vo import synthetic
from invcompcamtrack_torch.vo.engine import VisualOdometry, VOConfig
from invcompcamtrack_torch.vo.metrics import ate_rmse, rpe_trans

PROFILES = [("forward", False), ("forward", True), ("lateral", False), ("handheld", False)]


def _exp(p):
    return lie.se3_exp(torch.as_tensor(np.asarray(p), dtype=torch.float64)).numpy()


def make_path(profile: str, n_frames: int, rng):
    poses = [np.zeros(6)]
    for i in range(1, n_frames):
        if profile == "forward":
            d = np.r_[0.002, 0.001 * np.sin(i * 0.1), 0.02,
                      0.0, 0.0006 * np.sin(i * 0.05), 0.0]
        elif profile == "lateral":
            d = np.r_[0.02, 0.0, 0.004, 0.0, 0.0008, 0.0002]
        else:  # handheld
            d = np.r_[0.012 * np.sin(i * 0.21), 0.01 * np.cos(i * 0.17),
                      0.008 * np.sin(i * 0.13) + 0.004,
                      0.001 * np.sin(i * 0.11), 0.0012 * np.cos(i * 0.19),
                      0.0008 * np.sin(i * 0.23)]
        poses.append(poses[-1] + d + np.r_[rng.normal(size=3) * 5e-4,
                                           rng.normal(size=3) * 1e-4])
    return np.stack(poses)


def profile_seed(profile: str) -> int:
    """A seed that is the same in every process (see the docstring)."""
    return zlib.crc32(profile.encode())


def make_sequence(profile: str, n_frames: int, wh=(1280, 720), fc=(1000.0, 1200.0)):
    """(scene, true poses, float32 frames, rng) of one profile; the rng is
    left where the seeds are drawn from."""
    rng = np.random.default_rng(profile_seed(profile))
    scene = synthetic.make_scene(rng, wh=wh, fc=fc, z0=8.0, freq_range=(0.5, 6.0))
    poses_gt = make_path(profile, n_frames, rng)
    frames = np.stack([synthetic.render(scene, _exp(p)) for p in poses_gt]).astype(np.float32)
    return scene, poses_gt, frames, rng


def run_sequence(profile: str, n_frames: int, self_init: bool, wh=(1280, 720),
                 fc=(1000.0, 1200.0), chunk=32, device=None):
    dev = resolve(device)
    print(f"[{profile}] rendering {n_frames} frames ...", flush=True)
    scene, poses_gt, frames, rng = make_sequence(profile, n_frames, wh, fc)

    tracker = ICGNParams(lv_f=4, lv_l=0, psz=8, maxiter=10)
    cfg = VOConfig(tracker=tracker, max_landmarks=512, window=5,
                   keyframe_stride=2, corners_per_kf=512, min_parallax_px=1.0)
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh,
                               tracker.num_levels, tracker.psz, device=dev)
    vo = VisualOdometry(cam, scene.fc, scene.cc, cfg, device=dev)

    if self_init:
        n_seeds = vo.bootstrap_from_images(frames[0], frames[1])
        print(f"[{profile}] self-init: {n_seeds} seeds", flush=True)
    else:
        seeds = synthetic.sample_plane_points(scene, rng, 400, margin=24)
        vo.bootstrap(frames[0], frames[1], poses_gt[0], poses_gt[1], seeds)

    t0 = time.perf_counter()
    i = 2
    while i + chunk <= n_frames:
        vo.run_frames(frames[i:i + chunk])
        i += chunk
    while i < n_frames:
        vo.process_frame(frames[i])
        i += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    traj = torch.from_numpy(np.stack(vo.trajectory).astype(np.float64))
    centers_gt = np.stack([-_exp(p)[:, :3].T @ _exp(p)[:, 3] for p in poses_gt])
    gt = torch.from_numpy(centers_gt)
    with_scale = self_init  # monocular scale is free when self-initialised
    ate = float(ate_rmse(traj, gt, with_scale=with_scale))
    rpe = float(rpe_trans(traj, gt))
    path_len = float(np.sum(np.linalg.norm(np.diff(centers_gt, axis=0), axis=1)))
    return {
        "profile": profile,
        "init": "self (2-view)" if self_init else "GT 2-frame",
        "frames": n_frames,
        "ate_rmse": ate,
        "ate_pct_of_path": 100.0 * ate / path_len,
        "rpe_trans": rpe,
        "path_len": path_len,
        "fps": (n_frames - 2) / dt,
    }


def table_lines(rows):
    """The JAX suite's table."""
    lines = [
        "| sequence | init | frames | ATE RMSE | ATE % of path | RPE trans | fps |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['profile']} | {r['init']} | {r['frames']} "
            f"| {r['ate_rmse']:.5f} | {r['ate_pct_of_path']:.3f}% "
            f"| {r['rpe_trans']:.5f} | {r['fps']:.1f} |"
        )
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--out", default="ACCURACY_SUITE_torch.md")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    card = card_line(dev)
    print(card, flush=True)

    rows = []
    for profile, self_init in PROFILES:
        r = run_sequence(profile, args.frames, self_init, device=dev)
        rows.append(r)
        print(f"[{profile}] ATE {r['ate_rmse']:.5f} "
              f"({r['ate_pct_of_path']:.3f}% of path) RPE {r['rpe_trans']:.5f} "
              f"@ {r['fps']:.1f} fps on {card}", flush=True)

    lines = [
        "# ACCURACY_SUITE — VO accuracy suite of the PyTorch/CUDA port",
        "",
        "The counterpart of `examples/run_accuracy_suite.py`, itself the",
        "new-framework analogue of the reference's frozen accuracy log",
        "(reference: misc_src/pose_tracking_acc.txt:1-57).",
        "",
        "KITTI seq 00 / EuRoC MH_01 raw data is not at hand, so the suite",
        "runs long analytic-ground-truth synthetic sequences (exact",
        "plane-scene rendering, `vo/synthetic.py`) with motion profiles",
        "shaped after those workloads.",
        "Sequences: 1280x720, fc=(1000,1200), "
        f"{args.frames} frames, engine config = bench config",
        "(lv_f=4, psz=8, maxiter=10, 512 landmarks, window 5, stride 2).",
        "Each profile's scene and path come from `default_rng(zlib.crc32(",
        "profile))`, a seed that is the same in every process (the JAX suite's",
        "`hash(profile)` changes from process to process), so its rows are",
        "not the JAX suite's sequences.",
        "",
        f"Device: **{card}**; the engine runs in 32-frame chunks",
        "(`VisualOdometry.run_frames`); fps counts every tracked frame over",
        "the whole run, the first chunk included.",
        "",
        *table_lines(rows),
        "",
        "Units are normalised world units (scene depth ~8).  ATE for the",
        "self-initialised run is scale-aligned (monocular scale is free);",
        "GT-initialised runs are compared without scale alignment.",
    ]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
