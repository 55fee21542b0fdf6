"""Example: the stereo + flow tracking chain on the PyTorch port (the
counterpart of ``examples/run_stereo_track.py``; the reference's KITTI
stereo workload, reference: run_test_OF_track.py).  Per frame:

LK stereo matching -> disparity triangulation -> temporal LK tracks with
4-way consistency -> F-matrix RANSAC static/dynamic split -> PnP RANSAC
pose.

Runs on a synthetic rectified stereo sequence and prints each frame's
pose error against the truth.  The sparse LK runs K6 and K7 on the card.
The RANSAC samples come from CPU generators seeded with the frame
(``sfm/epipolar.py::sample_indices``), where the JAX example draws them
from ``jax.random`` keys, so the two examples see other samples.

Usage: python examples/run_stereo_track_torch.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.device import resolve
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.match.features import shi_tomasi_corners
from invcompcamtrack_torch.match.lk import track_points_lk
from invcompcamtrack_torch.sfm.epipolar import fit_fundamental_ransac, sample_indices
from invcompcamtrack_torch.sfm.ransac import fit_camera_ransac, reprojection_errors
from invcompcamtrack_torch.sfm.stereo import disparity_to_points, stereo_flow_consistency
from invcompcamtrack_torch.vo import synthetic


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def run(device=None):
    """The example's chain on ``device`` (the card unless given).  Returns
    one row per frame pair: (frame, tracks, centre error, mean reprojection
    error in px), the last three None where too few tracks were
    consistent."""
    dev = resolve(device)
    rng = np.random.default_rng(0)
    W, H = 320, 240
    scene = synthetic.make_scene(rng, wh=(W, H), fc=(300.0, 300.0), z0=8.0,
                                 freq_range=(0.5, 6.0))
    fc, cc = scene.fc, scene.cc
    baseline = 0.3

    def exp(p):
        return lie.se3_exp(torch.tensor(p, dtype=torch.float32)).double().numpy()

    def render_pair(p):
        G_l = exp(p)
        # right camera: shifted by the baseline along the rig x-axis
        R = G_l[:, :3]
        c_r = -R.T @ G_l[:, 3] + R.T @ np.array([baseline, 0, 0])
        G_r = np.concatenate([R, (-R @ c_r)[:, None]], axis=1)
        return synthetic.render(scene, G_l), synthetic.render(scene, G_r)

    n_frames = 5
    poses_gt = [np.zeros(6)]
    for _ in range(1, n_frames):
        poses_gt.append(poses_gt[-1] + np.r_[0.01, 0.004, 0.004,
                                             rng.normal(size=3) * 0.002])

    L, pad = 3, 8

    def pyr(img):
        return build_pyramid(torch.tensor(img, dtype=torch.float32, device=dev), L, pad)

    pyrs = [tuple(pyr(im) for im in render_pair(p)) for p in poses_gt]
    fc_t = torch.tensor(fc, dtype=torch.float32, device=dev)
    cc_t = torch.tensor(cc, dtype=torch.float32, device=dev)

    rows = []
    for t in range(n_frames - 1):
        pl_t, pr_t = pyrs[t]
        pl_n, pr_n = pyrs[t + 1]
        xy_l0, cval = shi_tomasi_corners(pl_t[0].img[pad:-pad, pad:-pad],
                                         max_corners=256, border=16)
        # stereo match: seeded with the nominal disparity at scene depth
        nominal_disp = fc[0] * baseline / 8.0
        seed = xy_l0 - torch.tensor([nominal_disp, 0.0], device=dev)
        xy_r0, ok_s = track_points_lk(pl_t, pr_t, xy_l0, psz=8, padding=pad,
                                      init_xy=seed)
        xy_l1, ok_t = track_points_lk(pl_t, pl_n, xy_l0, psz=8, padding=pad)
        xy_r1, ok_r = track_points_lk(pr_t, pr_n, xy_r0, psz=8, padding=pad)
        cons = stereo_flow_consistency(xy_l0, xy_r0, xy_l1, xy_r1)
        good = cval & ok_s & ok_t & ok_r & cons

        # static/dynamic split by F-RANSAC on the temporal left pairs
        n = xy_l0.shape[0]
        fres = fit_fundamental_ransac(sample_indices(n, 128, generator=_gen(t)),
                                      xy_l0, xy_l1, thresh=1.5)
        good = good & fres.inliers

        disp = xy_l0[:, 0] - xy_r0[:, 0]
        X_t = disparity_to_points(xy_l0, disp, fc[0], fc[1], cc[0], cc[1], baseline)
        # X_t is in frame-t camera coords; lift it to the world with the
        # true pose t (the reference chains PnP the same way)
        G_t = torch.tensor(exp(poses_gt[t]), dtype=torch.float32, device=dev)
        Xw = (X_t - G_t[:, 3]) @ G_t[:, :3]
        good = good & torch.all(torch.isfinite(Xw), dim=1) & (disp > 1.0)
        idx = torch.nonzero(good)[:, 0]
        if len(idx) < 10:
            print(f"frame {t+1}: too few consistent tracks ({len(idx)})")
            rows.append((t + 1, int(len(idx)), None, None))
            continue

        res = fit_camera_ransac(sample_indices(len(idx), 128, k=6, generator=_gen(100 + t)),
                                xy_l1[idx], Xw[idx], fc_t, cc_t, inl_thresh=2.0)
        best = torch.argmax(torch.where(res.valid, res.num_inliers,
                                        torch.full_like(res.num_inliers, -1)))
        G_est = res.G[best]
        idx = idx[res.inliers[best]]
        G_gt = exp(poses_gt[t + 1])
        G_np = G_est.double().cpu().numpy()
        c_est = -G_np[:, :3].T @ G_np[:, 3]
        c_gt = -G_gt[:, :3].T @ G_gt[:, 3]
        err = reprojection_errors(G_est, Xw[idx], xy_l1[idx], fc_t, cc_t)
        c_err, reproj = float(np.linalg.norm(c_est - c_gt)), float(torch.mean(err))
        print(f"frame {t+1}: tracks {len(idx):3d} | center err {c_err:.4f} | mean "
              f"reproj {reproj:.2f} px")
        rows.append((t + 1, int(len(idx)), c_err, reproj))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
