"""Dataset readers: KITTI odometry and EuRoC MAV (the port's own copy of
``invcompcamtrack_tpu/vo/datasets.py``, a numpy module that imports no
JAX; a test holds the two equal).

Host-side readers producing numpy arrays + file paths; image loading
goes through the native prefetcher (utils/native.py) when the files are
PNM, PIL otherwise.  The reference parses KITTI calibration ad hoc
(reference: run_test_OF_track.py:27-34); here both benchmark layouts are
first-class so the headline ATE configs (BASELINE.json configs 4/5) run
against real data when present.

KITTI odometry layout:
  sequences/NN/{calib.txt, times.txt, image_0/*.png, image_1/*.png}
  poses/NN.txt  (3x4 row-major world poses of camera 0)

EuRoC MAV layout:
  mav0/cam0/{data.csv, sensor.yaml, data/*.png}
  mav0/state_groundtruth_estimate0/data.csv
"""

from __future__ import annotations

import csv
import dataclasses
import pathlib
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class KittiSequence:
    image_paths: List[str]           # left grayscale (image_0)
    image_paths_right: List[str]     # right grayscale (image_1), may be empty
    times: np.ndarray                # (T,)
    P0: np.ndarray                   # (3, 4) projection matrices
    P1: np.ndarray
    poses_gt: Optional[np.ndarray]   # (T, 3, 4) world poses of cam0 or None

    @property
    def fc(self):
        return (float(self.P0[0, 0]), float(self.P0[1, 1]))

    @property
    def cc(self):
        return (float(self.P0[0, 2]), float(self.P0[1, 2]))

    @property
    def baseline(self) -> float:
        """Stereo baseline from P1's -fx*B translation term."""
        return float(-self.P1[0, 3] / self.P1[0, 0])


def read_kitti_calib(path) -> dict:
    out = {}
    for line in pathlib.Path(path).read_text().splitlines():
        if ":" not in line:
            continue
        key, vals = line.split(":", 1)
        arr = np.fromstring(vals, sep=" ")
        if arr.size == 12:
            out[key.strip()] = arr.reshape(3, 4)
        elif arr.size:
            out[key.strip()] = arr
    return out


def load_kitti_sequence(root, sequence: str) -> KittiSequence:
    root = pathlib.Path(root)
    seq = root / "sequences" / sequence
    calib = read_kitti_calib(seq / "calib.txt")
    times = np.asarray(
        [float(x) for x in (seq / "times.txt").read_text().split()]
    )
    imgs0 = sorted(str(p) for p in (seq / "image_0").glob("*.png"))
    img1_dir = seq / "image_1"
    imgs1 = sorted(str(p) for p in img1_dir.glob("*.png")) if img1_dir.exists() else []
    poses_file = root / "poses" / f"{sequence}.txt"
    poses = None
    if poses_file.exists():
        rows = np.loadtxt(poses_file)
        poses = rows.reshape(-1, 3, 4)
    return KittiSequence(
        image_paths=imgs0, image_paths_right=imgs1, times=times,
        P0=calib["P0"], P1=calib.get("P1", calib["P0"]), poses_gt=poses,
    )


def kitti_gt_centers(poses_gt: np.ndarray) -> np.ndarray:
    """KITTI pose rows are cam-to-world [R|t]: the camera center IS t."""
    return poses_gt[:, :, 3]


@dataclasses.dataclass
class EurocSequence:
    image_paths: List[str]
    timestamps: np.ndarray           # (T,) seconds
    gt_times: Optional[np.ndarray]
    gt_positions: Optional[np.ndarray]   # (G, 3)
    gt_quaternions: Optional[np.ndarray]  # (G, 4) wxyz


def load_euroc_sequence(root) -> EurocSequence:
    root = pathlib.Path(root)
    cam = root / "mav0" / "cam0"
    ts, paths = [], []
    with open(cam / "data.csv", newline="") as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts.append(float(row[0]) * 1e-9)
            paths.append(str(cam / "data" / row[1].strip()))
    gt_dir = root / "mav0" / "state_groundtruth_estimate0"
    gt_t, gt_p, gt_q = None, None, None
    if (gt_dir / "data.csv").exists():
        t_l, p_l, q_l = [], [], []
        with open(gt_dir / "data.csv", newline="") as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                t_l.append(float(row[0]) * 1e-9)
                p_l.append([float(x) for x in row[1:4]])
                q_l.append([float(x) for x in row[4:8]])
        gt_t = np.asarray(t_l)
        gt_p = np.asarray(p_l)
        gt_q = np.asarray(q_l)
    return EurocSequence(paths, np.asarray(ts), gt_t, gt_p, gt_q)
