"""Android IMU/GPS stream parsing + inertial dead-reckoning.

Host-side port of the reference's sensor-fusion lab
(reference: misc_src/run_csv_parse.py):

- CSV stream parser: rows are ``time, [sensor_id, values...]...`` with
  3-value sensors {1 gps, 3 accel, 4 gyro, 5, 6, 7, 81 orient, 82
  lin-acc, 83 gravity, 84 rot-vec} and 1-value sensors {8, 85, 86}
  (reference: :14-108); all-zero / inf / NaN rows dropped,
- GPS (lat, lon, alt) -> cartesian with the reference's exact spherical
  mapping, centered on the middle sample (reference: :141-146),
- orientation from rot-vec / integrated gyro (utils/rotation.py),
- linear acceleration rotated into the world frame and double-integrated
  with exact splines to displacement (reference: :178-195).

The port's own copy of ``invcompcamtrack_tpu/utils/sensors.py``: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import dataclasses

import numpy as np

from invcompcamtrack_torch.utils import rotation as rot
from invcompcamtrack_torch.utils.splines import double_integrate

_VEC3_IDS = {1, 3, 4, 5, 6, 7, 81, 82, 83, 84}
_VEC1_IDS = {8, 85, 86}


@dataclasses.dataclass
class SensorStreams:
    gps: tuple       # (t, (n,3) lat/lon/alt)
    accel: tuple
    gyro: tuple
    orient: tuple
    linacc: tuple
    rotvec: tuple
    gravity: tuple


def _clean(t, v):
    t = np.asarray(t, float)
    v = np.asarray(v, float)
    if t.size:
        bad = (
            np.all(v == 0.0, axis=1) | np.all(np.isinf(v), axis=1)
            | np.all(np.isnan(v), axis=1)
        )
        t, v = t[~bad], v[~bad]
    return (t, v)


def parse_imu_gps_csv(path) -> SensorStreams:
    streams = {k: ([], []) for k in (1, 3, 4, 81, 82, 83, 84)}
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            t = float(row[0])
            pt = 1
            while pt < len(row):
                sid = int(row[pt])
                if sid in _VEC3_IDS:
                    val = [float(row[pt + 1]), float(row[pt + 2]), float(row[pt + 3])]
                    pt += 4
                elif sid in _VEC1_IDS:
                    val = [float(row[pt + 1])]
                    pt += 2
                else:
                    raise ValueError(f"unknown sensor id {sid} in {path}")
                if sid in streams:
                    streams[sid][0].append(t)
                    streams[sid][1].append(val)
    c = {k: _clean(*streams[k]) for k in streams}
    return SensorStreams(gps=c[1], accel=c[3], gyro=c[4], orient=c[81],
                         linacc=c[82], rotvec=c[84], gravity=c[83])


EARTH_RADIUS_M = 6371000.0


def gps_to_cartesian(latlonalt: np.ndarray) -> np.ndarray:
    """The reference's spherical mapping, re-centered on the middle
    sample (reference: run_csv_parse.py:141-146)."""
    lat = np.radians(latlonalt[:, 0])
    lon = np.radians(latlonalt[:, 1])
    r = latlonalt[:, 2] + EARTH_RADIUS_M
    xyz = np.stack(
        [np.sin(lat) * np.sin(lon) * r, np.sin(lat) * r,
         np.sin(lat) * np.cos(lon) * r], axis=1
    )
    return xyz - xyz[latlonalt.shape[0] // 2]


def dead_reckon(streams: SensorStreams, use_rotvec: bool = True):
    """Orientation track + double-integrated displacement
    (reference: run_csv_parse.py:155-195).

    Returns (t, R (T,3,3), displacement (T,3)).
    """
    t_lin, a_lin = streams.linacc
    if use_rotvec and streams.rotvec[0].size:
        t_r, rv = streams.rotvec
        R_src = np.stack([rot.android_rotvec_to_dcm(v, True) for v in rv])
        R = rot.interpolate_orientations(t_r, R_src, t_lin)
    else:
        t_g, w = streams.gyro
        R_src = rot.integrate_gyro(t_g, w, orthonormalize=True)
        R = rot.interpolate_orientations(t_g, R_src, t_lin)

    # rotate linear acceleration into the world frame (R^{-1} a)
    a_world = np.einsum("tji,tj->ti", R, a_lin)
    disp = double_integrate(t_lin, a_world)
    return t_lin, R, disp
