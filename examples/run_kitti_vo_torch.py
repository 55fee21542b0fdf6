"""Example: monocular VO on a KITTI odometry sequence (BASELINE config 4)
with the PyTorch/CUDA port, the counterpart of ``examples/run_kitti_vo.py``.

    python examples/run_kitti_vo_torch.py /path/to/kitti_odometry 00 --frames 200

With a dataset root it reads sequences/NN through the port's copy of
``vo/datasets.py``, bootstraps from the first two frames (essential
matrix; monocular scale fixed from the GT baseline when poses are
available, else unit), runs the engine and prints the scale-aligned
ATE-RMSE against the GT trajectory.  Without a root it falls back to a
synthetic 320x240 sequence of up to 20 frames, so the pipeline always
runs end to end.  Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from invcompcamtrack_torch import ICGNParams
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.device import resolve
from invcompcamtrack_torch.utils.image import load_gray
from invcompcamtrack_torch.utils.metrics import MetricsLogger
from invcompcamtrack_torch.vo.engine import VisualOdometry, VOConfig
from invcompcamtrack_torch.vo.metrics import ate_rmse, rpe_trans


def run_sequence(frames, fc, cc, wh, centers_gt=None, scale=1.0, log_path=None,
                 device=None):
    """Bootstrap from frames 0-1, track the rest; returns the (T, 3)
    camera centres and the scale-aligned ATE (None without GT)."""
    dev = resolve(device)
    tracker = ICGNParams(lv_f=3, lv_l=0, psz=8, maxiter=8)
    cfg = VOConfig(tracker=tracker, max_landmarks=512, window=5,
                   keyframe_stride=2, corners_per_kf=512, min_parallax_px=0.5)
    cam = CameraPyramid.create(fc, cc, wh, tracker.num_levels, tracker.psz, device=dev)
    vo = VisualOdometry(cam, fc, cc, cfg, device=dev)
    metrics = MetricsLogger(log_path)

    n_seeds = vo.bootstrap_from_images(frames[0], frames[1], scale=scale)
    print(f"bootstrap: {n_seeds} landmark seeds")
    t_prev = time.perf_counter()
    for i in range(2, len(frames)):
        vo.process_frame(frames[i])
        now = time.perf_counter()
        metrics.record(frame=i, landmarks=int(vo.lm_valid.sum()),
                       step_ms=round((now - t_prev) * 1e3, 1))
        t_prev = now

    traj = np.stack(vo.trajectory)
    ate = None
    if centers_gt is not None:
        gt = torch.tensor(centers_gt[: len(traj)], dtype=torch.float64)
        est = torch.tensor(traj, dtype=torch.float64)
        ate = float(ate_rmse(est, gt, with_scale=True))
        rpe = float(rpe_trans(est, gt))
        extent = float(np.linalg.norm(gt.numpy() - gt.numpy().mean(0), axis=1).max())
        print(f"frames {len(traj)} | ATE-RMSE {ate:.4f} "
              f"({100 * ate / max(extent, 1e-9):.2f}% of extent {extent:.2f}) "
              f"| RPE {rpe:.4f}")
    s = metrics.summary("step_ms")
    if s:
        print(f"step time ms: mean {s['mean']:.1f} (min {s['min']:.1f}, "
              f"max {s['max']:.1f})")
    metrics.close()
    return traj, ate


def synthetic_sequence(n_frames):
    """The JAX example's fallback: a 320x240 textured plane, forward and
    lateral steps with small random rotations."""
    from invcompcamtrack_torch.vo import synthetic

    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, wh=(320, 240), fc=(300.0, 302.0),
                                 freq_range=(0.8, 8.0))

    def exp(p):
        return lie.se3_exp(torch.tensor(p, dtype=torch.float32)).double().numpy()

    poses = [np.zeros(6)]
    for _ in range(1, min(n_frames, 20)):
        poses.append(poses[-1] + np.r_[0.015, 0.006, -0.02, rng.normal(size=3) * 0.001])
    frames = [synthetic.render(scene, exp(p)) for p in poses]
    centers = np.stack([-exp(p)[:, :3].T @ exp(p)[:, 3] for p in poses])
    return scene, frames, centers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=None)
    ap.add_argument("sequence", nargs="?", default="00")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args(argv)

    if args.root:
        from invcompcamtrack_torch.vo.datasets import kitti_gt_centers, load_kitti_sequence

        seq = load_kitti_sequence(args.root, args.sequence)
        frames = [load_gray(p) for p in seq.image_paths[: args.frames]]
        wh = (frames[0].shape[1], frames[0].shape[0])
        centers = kitti_gt_centers(seq.poses_gt) if seq.poses_gt is not None else None
        scale = 1.0
        if centers is not None:
            scale = float(np.linalg.norm(centers[1] - centers[0]))
        return run_sequence(frames, seq.fc, seq.cc, wh, centers, scale, args.log,
                            args.device)
    print("no dataset given: running the synthetic fallback sequence")
    scene, frames, centers = synthetic_sequence(args.frames)
    scale = float(np.linalg.norm(centers[1] - centers[0]))
    return run_sequence(frames, scene.fc, scene.cc, scene.wh, centers, scale, args.log,
                        args.device)


if __name__ == "__main__":
    main()
