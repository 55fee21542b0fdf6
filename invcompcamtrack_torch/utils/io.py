"""File formats and interop protocols (the port's own copy of
``invcompcamtrack_tpu/utils/io.py``; numpy only, held equal to it by
``tests/test_torch_import.py``).

Everything the reference reads/writes, re-implemented from the formats'
behavior so reference scenarios replay byte-for-byte:

- ``.flo`` optical-flow files (reference: func_OF_util.py:40-57),
- ``.pfm`` depth/disparity files (reference: func_OF_util.py:60-84),
- the binary point+camera protocol of the single-pair tracker
  (reference: run_io_reprojection_test.cpp:54-97, written by
  run_io_test.m:83-93),
- the text protocol of the n-pose verification tracker
  (reference: run_track_nposes.cpp:39-131, written by
  func_ransac_fitcameras_odom.m:94-112),
- VisualSFM ``.nvm`` models (consumed by reference:
  run_odometer_test.m:21-23 via readnvm),
- compressed track archives (reference: classoftrack.py:133-134).

Pure numpy/host code — IO never runs on device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

FLO_MAGIC = 202021.25
MAXPTREAD = 10000  # reference stride (run_io_reprojection_test.cpp:40)


# ---------------- .flo / .pfm ----------------

def read_flo(path) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32 (little-endian)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, "<f4", 1)[0]
        if magic != np.float32(FLO_MAGIC):
            raise ValueError(f"not a .flo file: magic {magic}")
        w = int(np.fromfile(f, "<i4", 1)[0])
        h = int(np.fromfile(f, "<i4", 1)[0])
        data = np.fromfile(f, "<f4", 2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path, flow: np.ndarray) -> None:
    flow = np.asarray(flow, "<f4")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([FLO_MAGIC], "<f4").tofile(f)
        np.asarray([w, h], "<i4").tofile(f)
        flow.astype("<f4").tofile(f)


def read_pfm(path) -> np.ndarray:
    """Grayscale .pfm -> (H, W) float32; rows flipped like the reference
    (bottom-up storage)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"Pf":
            raise ValueError(f"not a grayscale .pfm: {magic!r}")
        w, h = (int(x) for x in f.readline().split())
        scale = float(f.readline())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.fromfile(f, dtype, w * h)
    return data.reshape(h, w)[::-1, :].astype(np.float32)


def write_pfm(path, img: np.ndarray, little_endian: bool = True) -> None:
    img = np.asarray(img, np.float32)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write((b"-1.0\n" if little_endian else b"1.0\n"))
        img[::-1, :].astype("<f4" if little_endian else ">f4").tofile(f)


# ---------------- single-pair tracker binary protocol ----------------

@dataclasses.dataclass
class PointCamFile:
    pose: np.ndarray      # (6,) float64 se(3) coeffs
    fc: np.ndarray        # (2,) float32
    cc: np.ndarray        # (2,) float32
    wh: np.ndarray        # (2,) uint32
    pt3d: np.ndarray      # (N, 3) float64
    pt2d: np.ndarray      # (N, 2) float32


def write_pointcam(path, data: PointCamFile) -> None:
    """Reference layout: 6xf64 pose, 2xf32 fc, 2xf32 cc, 2xu32 wh, u64 N,
    XYZ at stride MAXPTREAD doubles, xy at stride MAXPTREAD floats
    (reference: run_io_reprojection_test.cpp:54-79).

    NOTE the historical quirk faithfully reproduced: run_io_test.m:87
    writes the pose as float32 but the C++ reads 6 float64 — the
    *reader's* convention (float64) is authoritative here.
    """
    n = data.pt3d.shape[0]
    if n > MAXPTREAD:
        raise ValueError(f"too many points: {n} > {MAXPTREAD}")
    with open(path, "wb") as f:
        np.asarray(data.pose, "<f8").tofile(f)
        np.asarray(data.fc, "<f4").tofile(f)
        np.asarray(data.cc, "<f4").tofile(f)
        np.asarray(data.wh, "<u4").tofile(f)
        np.asarray([n], "<u8").tofile(f)
        np.asarray(data.pt3d[:, 0], "<f8").tofile(f)
        np.asarray(data.pt3d[:, 1], "<f8").tofile(f)
        np.asarray(data.pt3d[:, 2], "<f8").tofile(f)
        np.asarray(data.pt2d[:, 0], "<f4").tofile(f)
        np.asarray(data.pt2d[:, 1], "<f4").tofile(f)


def read_pointcam(path) -> PointCamFile:
    with open(path, "rb") as f:
        pose = np.fromfile(f, "<f8", 6)
        fc = np.fromfile(f, "<f4", 2)
        cc = np.fromfile(f, "<f4", 2)
        wh = np.fromfile(f, "<u4", 2)
        n = int(np.fromfile(f, "<u8", 1)[0])
        x = np.fromfile(f, "<f8", n)
        y = np.fromfile(f, "<f8", n)
        z = np.fromfile(f, "<f8", n)
        u = np.fromfile(f, "<f4", n)
        v = np.fromfile(f, "<f4", n)
    return PointCamFile(pose, fc, cc, wh, np.stack([x, y, z], 1), np.stack([u, v], 1))


def write_pose_result(path, pose: np.ndarray) -> None:
    """6 float64 (reference: run_io_reprojection_test.cpp:83-97)."""
    np.asarray(pose, "<f8").tofile(path)


def read_pose_result(path) -> np.ndarray:
    return np.fromfile(path, "<f8", 6)


# ---------------- n-pose tracker text protocol ----------------

@dataclasses.dataclass
class NPosesInput:
    params: dict          # lv_f lv_l psz maxiter normdp_ratio donorm dopatchnorm maxpttrack verbosity
    fc: np.ndarray
    cc: np.ndarray
    wh: np.ndarray
    fb_frames: tuple
    filenames: List[str]
    pt2d: np.ndarray      # (N, 2)
    pt3d: np.ndarray      # (N, 3)
    poses: np.ndarray     # (S, 6)
    inlier_ids: List[np.ndarray]  # 1-based ids per sample


_PARAM_KEYS = ("lv_f", "lv_l", "psz", "maxiter", "normdp_ratio", "donorm",
               "dopatchnorm", "maxpttrack", "verbosity")


def write_nposes_input(path, data: NPosesInput) -> None:
    """(reference: func_ransac_fitcameras_odom.m:94-112 writes;
    run_track_nposes.cpp:39-103 reads)."""
    with open(path, "w") as f:
        f.write(" ".join(f"{data.params[k]:.17g}" for k in _PARAM_KEYS) + "\n")
        f.write(" ".join(f"{float(v):.17g}" for v in [*data.fc, *data.cc]) +
                f" {int(data.wh[0])} {int(data.wh[1])}\n")
        f.write(f"{int(data.fb_frames[0])} {int(data.fb_frames[1])}\n")
        for name in data.filenames:
            f.write(name + "\n")
        n = data.pt2d.shape[0]
        f.write(f"{n}\n")
        for i in range(n):
            f.write(
                f"{data.pt2d[i,0]:.17g} {data.pt2d[i,1]:.17g} "
                f"{data.pt3d[i,0]:.17g} {data.pt3d[i,1]:.17g} {data.pt3d[i,2]:.17g}\n"
            )
        f.write(f"{len(data.poses)}\n")
        for s, pose in enumerate(data.poses):
            ids = np.asarray(data.inlier_ids[s], int)
            f.write(" ".join(f"{float(x):.17g}" for x in pose)
                    + f" {len(ids)} " + " ".join(str(i) for i in ids) + "\n")


def read_nposes_input(path) -> NPosesInput:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    it = iter(lines)
    vals = next(it).split()
    params = {}
    for k, v in zip(_PARAM_KEYS, vals):
        params[k] = float(v) if k == "normdp_ratio" else int(float(v))
    l2 = next(it).split()
    fc = np.array(l2[0:2], float)
    cc = np.array(l2[2:4], float)
    wh = np.array(l2[4:6], int)
    fb = tuple(int(x) for x in next(it).split())
    filenames = [next(it).strip() for _ in range(fb[0] + fb[1] + 1)]
    n = int(next(it))
    rows = np.array([[float(x) for x in next(it).split()] for _ in range(n)])
    pt2d, pt3d = rows[:, 0:2], rows[:, 2:5]
    s = int(next(it))
    poses, ids = [], []
    for _ in range(s):
        row = next(it).split()
        poses.append([float(x) for x in row[:6]])
        k = int(row[6])
        ids.append(np.array([int(x) for x in row[7:7 + k]]))
    return NPosesInput(params, fc, cc, wh, fb, filenames, pt2d, pt3d,
                       np.array(poses), ids)


def write_nposes_result(path, pose_tracks: np.ndarray, correlations: Sequence[np.ndarray]) -> None:
    """(reference: run_track_nposes.cpp:106-131): per sample, one line per
    image with 6 pose values (8 sig digits), then one line of per-point
    correlations (3 sig digits)."""
    with open(path, "w") as f:
        for s in range(pose_tracks.shape[0]):
            for j in range(pose_tracks.shape[1]):
                f.write(" ".join(f"{v:.8g}" for v in pose_tracks[s, j]) + " \n")
            f.write(" ".join(f"{v:.3g}" for v in correlations[s]) + " \n")


def read_nposes_result(path, num_images: int):
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    tracks, corrs = [], []
    i = 0
    while i < len(lines):
        tracks.append([[float(v) for v in lines[i + j]] for j in range(num_images)])
        corrs.append(np.array([float(v) for v in lines[i + num_images]]))
        i += num_images + 1
    return np.asarray(tracks), corrs


# ---------------- NVM (VisualSFM) models ----------------

@dataclasses.dataclass
class NVMModel:
    focals: np.ndarray      # (C,)
    quats: np.ndarray       # (C, 4) wxyz
    centers: np.ndarray     # (C, 3)
    distortion: np.ndarray  # (C,) radial r
    names: List[str]
    points: np.ndarray      # (P, 3)
    colors: np.ndarray      # (P, 3)
    measurements: List[np.ndarray]  # per point: (M, 4) [img, feat, x, y]


def read_nvm(path) -> NVMModel:
    """Minimal NVM_V3 parser (the format readnvm consumes;
    reference: run_odometer_test.m:21-23)."""
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    if not tokens[i].startswith("NVM_V3"):
        raise ValueError("not an NVM_V3 file")
    i += 1
    # optional 'FixedK' calibration block
    if tokens[i] == "FixedK":
        i += 6
    ncam = int(tokens[i]); i += 1
    names, fo, qu, ce, di = [], [], [], [], []
    for _ in range(ncam):
        names.append(tokens[i]); i += 1
        fo.append(float(tokens[i])); i += 1
        qu.append([float(tokens[i + k]) for k in range(4)]); i += 4
        ce.append([float(tokens[i + k]) for k in range(3)]); i += 3
        di.append(float(tokens[i])); i += 2  # radial + trailing 0
    npt = int(tokens[i]); i += 1
    pts, cols, meas = [], [], []
    for _ in range(npt):
        pts.append([float(tokens[i + k]) for k in range(3)]); i += 3
        cols.append([float(tokens[i + k]) for k in range(3)]); i += 3
        m = int(tokens[i]); i += 1
        rows = []
        for _ in range(m):
            rows.append([float(tokens[i]), float(tokens[i + 1]),
                         float(tokens[i + 2]), float(tokens[i + 3])])
            i += 4
        meas.append(np.asarray(rows))
    return NVMModel(np.asarray(fo), np.asarray(qu), np.asarray(ce),
                    np.asarray(di), names, np.asarray(pts), np.asarray(cols), meas)


# ---------------- track archives ----------------

def save_tracks(path, xy: np.ndarray, alive: np.ndarray) -> None:
    """np.savez_compressed like the reference (classoftrack.py:133-134)."""
    np.savez_compressed(path, x=xy, alive=alive)


def load_tracks(path):
    z = np.load(path, allow_pickle=False)
    return z["x"], z["alive"]
