"""NVM-model sequence replay through the byte-level CLI protocol (port of
``invcompcamtrack_tpu/vo/replay.py``).

The reference's full-sequence oracle driver (reference:
run_odometer_test.m:21-39,197-244): load an NVM SfM model, normalise the
cloud and camera centres to zero mean and unit max-std, then track the
camera frame to frame by writing the binary point+camera protocol,
invoking the pair tracker (the port's ``cli/track_pair.py``, which speaks
the same argv and file protocol) and chaining its pose into the next
pair, and report each frame's camera-centre error against the model's
own cameras.  The tracker runs on the card unless ``device`` says
otherwise; per frame pair it launches K1 x (levels) and K2 x (levels x
maxiter).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Sequence

import numpy as np
import torch

from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.utils import io
from invcompcamtrack_torch.utils.rotation import dcm2quat, quat2dcm


def _exp_np(p) -> np.ndarray:
    return lie.se3_exp(torch.as_tensor(np.asarray(p), dtype=torch.float64)).numpy()


def normalize_model(points: np.ndarray, centers: np.ndarray):
    """Zero-mean / unit-max-std normalisation of cloud and camera centres
    (reference: run_odometer_test.m:31-39: ``mm = mean(XYZ)``,
    ``maxvar = sqrt(max(var(XYZ)))``)."""
    mm = points.mean(axis=0)
    maxvar = np.sqrt(points.var(axis=0, ddof=0).max())
    return (points - mm) / maxvar, (centers - mm) / maxvar, mm, maxvar


def write_nvm(path, focals, quats, centers, names, points, colors=None) -> None:
    """Minimal NVM_V3 writer (the counterpart of ``utils.io.read_nvm``),
    so that synthetic scenarios become real model files."""
    points = np.asarray(points)
    if colors is None:
        colors = np.full_like(points, 128.0)
    lines = ["NVM_V3", "", str(len(names))]
    for k, name in enumerate(names):
        q = quats[k]
        c = centers[k]
        lines.append(
            f"{name} {focals[k]:.10g} "
            f"{q[0]:.10g} {q[1]:.10g} {q[2]:.10g} {q[3]:.10g} "
            f"{c[0]:.10g} {c[1]:.10g} {c[2]:.10g} 0 0")
    lines.append("")
    lines.append(str(len(points)))
    for p, col in zip(points, colors):
        lines.append(f"{p[0]:.10g} {p[1]:.10g} {p[2]:.10g} "
                     f"{int(col[0])} {int(col[1])} {int(col[2])} 0")
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def model_poses(model: io.NVMModel) -> np.ndarray:
    """NVM cameras -> (C, 6) se(3) coefficient poses of [R | -R c]
    (NVM stores world -> cam quaternions (wxyz) and camera centres)."""
    poses = []
    for q, c in zip(model.quats, model.centers):
        R = quat2dcm(q)
        t = -R @ np.asarray(c)
        G = np.concatenate([R, t[:, None]], axis=1)
        poses.append(lie.se3_log(torch.as_tensor(G, dtype=torch.float64)).numpy())
    return np.stack(poses)


def replay_sequence(nvm_path, image_paths: Sequence, workdir,
                    fc, cc, wh, lv_f: int = 4, lv_l: int = 0, psz: int = 8,
                    maxiter: int = 10, normdp_ratio: float = 0.01,
                    donorm: int = 1, dopatchnorm: int = 1,
                    subsample: int = 10, verbose: bool = False, device=None):
    """Frame-to-frame replay of an NVM scenario via the CLI protocol.

    Per pair (reference: run_odometer_test.m:197-244): project the cloud
    at the current estimate, drop out-of-frame points (1-based bounds),
    keep every ``subsample``-th, write the binary protocol, invoke the
    pair-tracker CLI byte-level, read the 6-double result, chain.

    Returns (poses_est (F, 6), center_err (F,)) in normalised units.
    """
    from invcompcamtrack_torch.cli import track_pair as cli_pair

    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    model = io.read_nvm(nvm_path)
    pts_n, centers_n, _, _ = normalize_model(model.points, model.centers)
    model_n = dataclasses.replace(model, points=pts_n, centers=centers_n)
    poses_gt = model_poses(model_n)

    F = len(image_paths)
    if F > len(poses_gt):
        raise ValueError("more images than model cameras")

    poses_est = [poses_gt[0]]
    for fr in range(F - 1):
        p_init = poses_est[fr]
        G = _exp_np(p_init)
        # project the cloud at the current estimate; 1-based in-frame filter
        Xc = pts_n @ G[:, :3].T + G[:, 3]
        uv = Xc[:, :2] / Xc[:, 2:3] * np.asarray(fc) + np.asarray(cc)
        keep = ((uv[:, 0] >= 1) & (uv[:, 1] >= 1)
                & (uv[:, 0] <= wh[0]) & (uv[:, 1] <= wh[1])
                & (Xc[:, 2] > 0))
        X_s = pts_n[keep][::subsample]
        uv_s = uv[keep][::subsample]

        infile = workdir / "pair_in.bin"
        outfile = workdir / "pair_out.bin"
        io.write_pointcam(infile, io.PointCamFile(
            pose=np.asarray(p_init, np.float64),
            fc=np.asarray(fc, np.float32),
            cc=np.asarray(cc, np.float32),
            wh=np.asarray(wh, np.uint32),
            pt3d=X_s, pt2d=uv_s.astype(np.float32),
        ))
        rc = cli_pair.main([
            str(image_paths[fr]), str(image_paths[fr + 1]),
            str(infile), str(outfile),
            str(lv_f), str(lv_l), str(psz), str(maxiter),
            str(normdp_ratio), str(donorm), str(dopatchnorm),
            str(len(X_s)), "0",
        ], device=device)
        if rc != 0:
            raise RuntimeError(f"tracker CLI failed at frame {fr}")
        p_res = io.read_pose_result(str(outfile))
        poses_est.append(p_res)
        if verbose:
            d_init = np.linalg.norm(poses_gt[fr + 1] - p_init)
            d_res = np.linalg.norm(poses_gt[fr + 1] - p_res)
            print(f"frame {fr + 1}: |p_GT-p_init| {d_init:.4g} -> "
                  f"|p_GT-p_res| {d_res:.4g}")

    poses_est = np.stack(poses_est)
    centers_est = np.stack([-_exp_np(p)[:, :3].T @ _exp_np(p)[:, 3] for p in poses_est])
    err = np.linalg.norm(centers_est - centers_n[:F], axis=1)
    return poses_est, err


def make_synthetic_nvm_scenario(rng, outdir, n_frames: int = 5,
                                wh=(256, 192), fc=(240.0, 245.0),
                                n_points: int = 400, step: float = 0.02):
    """Materialise a synthetic NVM model and rendered frames on disk:
    plane-scene images, a plane-sampled cloud, a smooth true camera path.
    Returns (nvm_path, image_paths, fc, cc, wh)."""
    from invcompcamtrack_torch.utils import image as img_io
    from invcompcamtrack_torch.vo import synthetic

    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    scene = synthetic.make_scene(rng, wh=wh, fc=fc)
    poses = [np.zeros(6)]
    for i in range(1, n_frames):
        poses.append(poses[-1] + np.r_[step, 0.3 * step * np.sin(i), 0.4 * step,
                                       rng.normal(size=3) * 0.002])

    names, quats, centers, focals, img_paths = [], [], [], [], []
    for i, p in enumerate(poses):
        G = _exp_np(p)
        img = synthetic.render(scene, G)
        path = outdir / f"frame_{i:04d}.png"
        img_io.save_gray(path, img)
        img_paths.append(path)
        names.append(path.name)
        quats.append(dcm2quat(G[:, :3]))
        centers.append(-G[:, :3].T @ G[:, 3])
        focals.append(float(fc[0]))

    X = synthetic.sample_plane_points(scene, rng, n_points, margin=12)
    nvm_path = outdir / "model.nvm"
    write_nvm(nvm_path, focals, quats, centers, names, X)
    return nvm_path, img_paths, scene.fc, scene.cc, scene.wh
