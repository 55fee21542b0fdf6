"""Rotation representations + gyroscope integration.

Host-side numpy re-implementations of the reference's quaternion / DCM /
rotation-vector toolbox and Android-convention gyro integration
(reference: misc_src/func_util_geom.py:58-186,
misc_src/run_csv_parse.py:158-166).  Conventions preserved:

- quaternions are wxyz with w >= 0,
- ``dcm2quat`` uses the symmetric-eigenvector (Davenport K-matrix)
  method; ``quat2dcm`` the direct quadratic form,
- the Android rotation-vector layout is (x, y, z[, w]) with w
  reconstructed as sqrt(1 - |v|^2) when absent,
- gyro integration forms per-step axis-angle quaternion deltas and
  right-multiplies (body-frame rates), with optional SVD
  re-orthonormalization.

The port's own copy of ``invcompcamtrack_tpu/utils/rotation.py``: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def quat2dcm(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> rotation matrix (reference:
    func_util_geom.py:84-100)."""
    q = np.asarray(q, float)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z],
    ])


def dcm2quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion via the Davenport K-matrix
    eigenvector (reference: func_util_geom.py:58-81)."""
    m = np.asarray(R, float)
    K = np.array([
        [m[0, 0] - m[1, 1] - m[2, 2], 0.0, 0.0, 0.0],
        [m[0, 1] + m[1, 0], m[1, 1] - m[0, 0] - m[2, 2], 0.0, 0.0],
        [m[0, 2] + m[2, 0], m[1, 2] + m[2, 1], m[2, 2] - m[0, 0] - m[1, 1], 0.0],
        [m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1],
         m[0, 0] + m[1, 1] + m[2, 2]],
    ]) / 3.0
    K = (K + K.T) - np.diag(np.diag(K))  # symmetrize lower-triangular form
    w, V = np.linalg.eigh(K)
    q = V[[3, 0, 1, 2], np.argmax(w)]
    return -q if q[0] < 0 else q


def skew(x: np.ndarray) -> np.ndarray:
    """Cross-product matrix [x]× of a 3-vector."""
    x = np.asarray(x, float)
    return np.array([
        [0.0, -x[2], x[1]],
        [x[2], 0.0, -x[0]],
        [-x[1], x[0], 0.0],
    ])


def rodrigues(x: np.ndarray) -> np.ndarray:
    """Axis-angle -> rotation (reference: func_util_geom.py:104-116)."""
    x = np.asarray(x, float)
    a = np.linalg.norm(x)
    if a == 0:
        return np.eye(3)
    C = skew(x)
    return np.eye(3) + np.sin(a) / a * C + (1 - np.cos(a)) / a**2 * (C @ C)


def android_rotvec_to_dcm(rv: np.ndarray, orthonormalize: bool = False) -> np.ndarray:
    """Android rotation vector (x, y, z[, w]) -> rotation matrix.

    Semantics follow the Android SDK convention the reference adopts
    (behavioral spec: func_util_geom.py:146-186): a 3-component input
    reconstructs the scalar part as ``q0 = 1 - |v|^2`` — *without* the
    sqrt, an SDK quirk kept for parity — and the quadratic form is
    applied to the possibly-non-unit quaternion as-is, so the result is
    only approximately orthonormal; ``orthonormalize=True`` applies the
    SVD cleanup used at the reference's call sites.

    Implemented via the skew-form identity
    ``R = I + 2 q0 [v]x + 2 [v]x^2``, which expands to exactly the
    SDK's elementwise quadratic form.
    """
    rv = np.asarray(rv, float)
    v = rv[:3]
    q0 = rv[3] if rv.shape[0] == 4 else max(0.0, 1.0 - float(v @ v))
    C = skew(v)
    R = np.eye(3) + 2.0 * q0 * C + 2.0 * (C @ C)
    if orthonormalize:
        U, _, Vt = np.linalg.svd(R)
        R = U @ Vt
    return R


def integrate_gyro(timestamps: np.ndarray, rates: np.ndarray,
                   orthonormalize: bool = True) -> np.ndarray:
    """Integrate body-frame angular rates into an orientation sequence
    (behavioral spec: func_android_rotM_from_gyroscope,
    func_util_geom.py:118-144).  Returns (T, 3, 3) with R[0] = I.

    Per-step axis-angle deltas are built vectorized as unit wxyz
    quaternions (for which the Android quadratic form reduces to the
    standard one), then chained by right-multiplication (body rates).
    """
    t = np.asarray(timestamps, float)
    w = np.asarray(rates, float)[: max(t.shape[0] - 1, 0)]
    half = 0.5 * np.linalg.norm(w, axis=1) * np.diff(t)
    mag = np.linalg.norm(w, axis=1, keepdims=True)
    axis = np.divide(w, mag, out=np.zeros_like(w), where=mag > 0)
    dq = np.column_stack([np.cos(half), np.sin(half)[:, None] * axis])

    out = np.zeros((t.shape[0], 3, 3))
    out[0] = np.eye(3)
    for i, q in enumerate(dq):
        R = quat2dcm(q)
        if orthonormalize:
            U, _, Vt = np.linalg.svd(R)
            R = U @ Vt
        out[i + 1] = out[i] @ R
    return out


def rotation_angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Angle between two rotations (reference: func_comp_rot,
    func_util_geom.py:9-13)."""
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def interpolate_orientations(t_src: np.ndarray, R_src: np.ndarray,
                             t_dst: np.ndarray) -> np.ndarray:
    """Resample an orientation sequence at new timestamps via
    sign-continuous per-component quaternion interpolation + SVD
    re-orthonormalization (the reference's
    func_spline_orientation_interpolate role)."""
    qs = np.stack([dcm2quat(R) for R in R_src])
    for i in range(1, len(qs)):  # hemisphere continuity
        if np.dot(qs[i], qs[i - 1]) < 0:
            qs[i] = -qs[i]
    out = np.zeros((len(t_dst), 3, 3))
    comp = np.stack([np.interp(t_dst, t_src, qs[:, k]) for k in range(4)], axis=1)
    for i, q in enumerate(comp):
        R = quat2dcm(q / max(np.linalg.norm(q), 1e-30))
        U, _, Vt = np.linalg.svd(R)
        out[i] = U @ Vt
    return out
