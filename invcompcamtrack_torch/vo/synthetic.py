"""Synthetic ground-truth scene generation (the port's own copy of
``invcompcamtrack_tpu/vo/synthetic.py``; numpy only, held equal to it by
``tests/test_torch_import.py``).

The reference validates its tracker with random clouds + random GT
cameras written through its binary protocol (reference: run_io_test.m:17-57,
run_odometer_test.m:128-146).  Here the same idea is made fully analytic:
a *textured world plane* rendered through exact ray-plane intersection, so
images at any camera pose are generated with zero resampling error and
the photometric-alignment ground truth is exact.

numpy/float64 on purpose — this is test/benchmark fixture code, not a
device path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PlaneScene(NamedTuple):
    tex_freqs: np.ndarray   # (K, 2) spatial frequencies
    tex_phases: np.ndarray  # (K,)
    tex_amps: np.ndarray    # (K,)
    z0: float               # world plane z = z0
    fc: tuple
    cc: tuple
    wh: tuple


def make_scene(rng: np.random.Generator, wh=(320, 240), fc=(300.0, 310.0),
               cc=None, z0=8.0, num_waves=24, freq_range=(2.0, 20.0)) -> PlaneScene:
    if cc is None:
        cc = (wh[0] / 2.0 + 1.5, wh[1] / 2.0 - 2.0)
    # band-limited texture: default wavelengths ~0.3 to ~3 world units so
    # an 8x8 patch at f~300, z~8 (~0.027 wu/px) sees useful gradients;
    # lower freq_range for workloads with large displacements (stereo)
    freqs = rng.uniform(freq_range[0], freq_range[1], size=(num_waves, 2)) * rng.choice(
        [-1.0, 1.0], size=(num_waves, 2)
    )
    return PlaneScene(
        tex_freqs=freqs,
        tex_phases=rng.uniform(0, 2 * np.pi, size=num_waves),
        tex_amps=rng.uniform(0.3, 1.0, size=num_waves) * (128.0 / num_waves * 3),
        z0=z0,
        fc=fc,
        cc=cc,
        wh=wh,
    )


def texture(scene: PlaneScene, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    acc = np.full(np.broadcast(x, y).shape, 128.0)
    for k in range(scene.tex_freqs.shape[0]):
        acc = acc + scene.tex_amps[k] * np.sin(
            scene.tex_freqs[k, 0] * x + scene.tex_freqs[k, 1] * y + scene.tex_phases[k]
        )
    return acc


def render(scene: PlaneScene, G: np.ndarray) -> np.ndarray:
    """Render the plane through camera [R|t] (world->cam), pinhole.

    Pixel (u, v) casts ray from camera center c = -R^T t with world
    direction R^T [ (u-cx)/fx, (v-cy)/fy, 1 ]; intersect z = z0.
    Returns (H, W) float64 image.
    """
    W, H = scene.wh
    R, t = G[:, :3], G[:, 3]
    c = -R.T @ t
    u, v = np.meshgrid(np.arange(W, dtype=float), np.arange(H, dtype=float))
    d_cam = np.stack(
        [(u - scene.cc[0]) / scene.fc[0], (v - scene.cc[1]) / scene.fc[1], np.ones_like(u)],
        axis=-1,
    )
    d_world = d_cam @ R  # = R^T d per pixel
    lam = (scene.z0 - c[2]) / d_world[..., 2]
    wx = c[0] + lam * d_world[..., 0]
    wy = c[1] + lam * d_world[..., 1]
    return texture(scene, wx, wy)


def sample_plane_points(scene: PlaneScene, rng: np.random.Generator, n: int,
                        margin: float = 20.0) -> np.ndarray:
    """n world points on the plane, uniform over the identity-camera
    frustum with a pixel margin."""
    W, H = scene.wh
    u = rng.uniform(margin, W - margin, size=n)
    v = rng.uniform(margin, H - margin, size=n)
    wx = (u - scene.cc[0]) / scene.fc[0] * scene.z0
    wy = (v - scene.cc[1]) / scene.fc[1] * scene.z0
    return np.stack([wx, wy, np.full(n, scene.z0)], axis=1)


# ---------------------------------------------------------------------------
# Multi-depth corridor scene: ground + two side walls + back wall, each an
# infinite textured plane clipped by nearest-positive-hit selection.  Gives
# genuine depth variation and occlusion boundaries (wall/ground junctions)
# while keeping exact analytic rendering at any pose — the "photorealistic-
# ish" long-sequence benchmark fixture (the reference validates against
# random clouds through its protocol, run_odometer_test.m:128-146; this is
# the dense-image analogue with non-planar structure).


class CorridorScene(NamedTuple):
    # plane k: points X with <n_k, X> = d_k; textured in its own (s, t)
    # frame spanned by (e1_k, e2_k)
    normals: np.ndarray     # (P, 3) unit normals
    offsets: np.ndarray     # (P,)
    e1: np.ndarray          # (P, 3)
    e2: np.ndarray          # (P, 3)
    tex_freqs: np.ndarray   # (P, K, 2)
    tex_phases: np.ndarray  # (P, K)
    tex_amps: np.ndarray    # (P, K)
    fc: tuple
    cc: tuple
    wh: tuple


def make_corridor(rng: np.random.Generator, wh=(640, 480), fc=(520.0, 525.0),
                  cc=None, half_width=4.0, floor_y=2.0, z_back=40.0,
                  num_waves=16, freq_range=(0.4, 5.0)) -> CorridorScene:
    """Camera at origin looks down +z along a corridor: walls at
    x = +-half_width, floor at y = floor_y (y points down), back wall at
    z = z_back."""
    if cc is None:
        cc = (wh[0] / 2.0 + 1.5, wh[1] / 2.0 - 2.0)
    normals = np.array([
        [1.0, 0.0, 0.0],   # left wall  x = -half_width
        [1.0, 0.0, 0.0],   # right wall x = +half_width
        [0.0, 1.0, 0.0],   # floor      y = +floor_y
        [0.0, 0.0, 1.0],   # back wall  z = z_back
    ])
    offsets = np.array([-half_width, half_width, floor_y, z_back])
    e1 = np.array([[0, 0, 1.0], [0, 0, 1.0], [1.0, 0, 0], [1.0, 0, 0]])
    e2 = np.array([[0, 1.0, 0], [0, 1.0, 0], [0, 0, 1.0], [0, 1.0, 0]])
    P = len(offsets)
    freqs = rng.uniform(*freq_range, size=(P, num_waves, 2)) * rng.choice(
        [-1.0, 1.0], size=(P, num_waves, 2))
    return CorridorScene(
        normals=normals, offsets=offsets, e1=e1, e2=e2,
        tex_freqs=freqs,
        tex_phases=rng.uniform(0, 2 * np.pi, size=(P, num_waves)),
        tex_amps=rng.uniform(0.3, 1.0, size=(P, num_waves))
        * (128.0 / num_waves * 3),
        fc=fc, cc=cc, wh=wh,
    )


def _corridor_hits(scene: CorridorScene, origin: np.ndarray,
                   d_world: np.ndarray):
    """Nearest positive ray-plane hit.  d_world: (..., 3).  Returns
    (lam (...,), plane index (...,), hit point (..., 3))."""
    P = scene.offsets.shape[0]
    denom = d_world @ scene.normals.T                       # (..., P)
    num = scene.offsets - origin @ scene.normals.T          # (P,)
    with np.errstate(divide="ignore", invalid="ignore"):
        lam = num / denom                                   # (..., P)
    lam = np.where((lam > 1e-6) & np.isfinite(lam), lam, np.inf)
    k = np.argmin(lam, axis=-1)                             # (...)
    lam_min = np.take_along_axis(lam, k[..., None], axis=-1)[..., 0]
    X = origin + lam_min[..., None] * d_world
    return lam_min, k, X


def render_corridor(scene: CorridorScene, G: np.ndarray) -> np.ndarray:
    """Render through camera [R|t] (world->cam), pinhole; (H, W) f64."""
    W, H = scene.wh
    R, t = G[:, :3], G[:, 3]
    c = -R.T @ t
    u, v = np.meshgrid(np.arange(W, dtype=float), np.arange(H, dtype=float))
    d_cam = np.stack([(u - scene.cc[0]) / scene.fc[0],
                      (v - scene.cc[1]) / scene.fc[1],
                      np.ones_like(u)], axis=-1)
    d_world = d_cam @ R
    _, k, X = _corridor_hits(scene, c, d_world)
    s = np.einsum("hwi,hwi->hw", X, scene.e1[k])
    tt = np.einsum("hwi,hwi->hw", X, scene.e2[k])
    img = np.full((H, W), 128.0)
    for kk in range(scene.offsets.shape[0]):
        m = k == kk
        acc = np.zeros(int(m.sum()))
        for w in range(scene.tex_freqs.shape[1]):
            acc += scene.tex_amps[kk, w] * np.sin(
                scene.tex_freqs[kk, w, 0] * s[m]
                + scene.tex_freqs[kk, w, 1] * tt[m]
                + scene.tex_phases[kk, w])
        img[m] = 128.0 + acc
    return img


def sample_corridor_points(scene: CorridorScene, rng: np.random.Generator,
                           n: int, G: np.ndarray | None = None,
                           margin: float = 20.0) -> np.ndarray:
    """n world points on the visible surfaces: cast rays through random
    pixels of camera G (identity if None), return the nearest hits."""
    W, H = scene.wh
    if G is None:
        G = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    R, t = G[:, :3], G[:, 3]
    c = -R.T @ t
    u = rng.uniform(margin, W - margin, size=n)
    v = rng.uniform(margin, H - margin, size=n)
    d_cam = np.stack([(u - scene.cc[0]) / scene.fc[0],
                      (v - scene.cc[1]) / scene.fc[1],
                      np.ones(n)], axis=-1)
    _, _, X = _corridor_hits(scene, c, d_cam @ R)
    return X


def degrade(img: np.ndarray, rng: np.random.Generator,
            noise_sigma: float = 0.0,
            exposure_gain: float = 1.0,
            exposure_bias: float = 0.0,
            blur_sigma: float = 0.0) -> np.ndarray:
    """Sensor-degradation model for robustness studies.

    The reference operates on real photographs throughout (reference:
    run_ransac_test.m:58-121, misc_src/run_test_OF_track.py); the
    exactly-rendered fixtures here are noise-free, so this applies the
    three dominant real-sensor effects in physical order:

    1. optical blur — separable Gaussian PSF of std ``blur_sigma`` px,
    2. exposure drift — ``gain * img + bias`` (auto-exposure/vignetting
       drift between frames; what ``dopatchnorm`` exists to absorb),
    3. sensor noise — additive iid Gaussian, std ``noise_sigma`` gray
       levels (read+shot noise of a mid-range sensor at gain).
    """
    out = np.asarray(img, np.float64)
    if blur_sigma > 0.0:
        rad = max(1, int(np.ceil(3.0 * blur_sigma)))
        xs = np.arange(-rad, rad + 1, dtype=np.float64)
        k = np.exp(-0.5 * (xs / blur_sigma) ** 2)
        k /= k.sum()
        pad = np.pad(out, ((rad, rad), (rad, rad)), mode="edge")
        out = np.apply_along_axis(
            lambda r: np.convolve(r, k, "valid"), 1, pad)
        out = np.apply_along_axis(
            lambda c: np.convolve(c, k, "valid"), 0, out)
    out = exposure_gain * out + exposure_bias
    if noise_sigma > 0.0:
        out = out + rng.normal(scale=noise_sigma, size=out.shape)
    return out


def degrade_sequence(imgs, rng: np.random.Generator,
                     noise_sigma: float = 0.0,
                     exposure_drift: float = 0.0,
                     blur_sigma: float = 0.0):
    """Apply per-frame degradations with a slowly DRIFTING exposure:
    gain oscillates by ``±exposure_drift`` (fractional) and bias by
    ``±16*exposure_drift`` gray levels over a ~40-frame period, so
    consecutive frames see a changing photometric transform — the
    auto-exposure behavior of real cameras."""
    out = []
    for i, img in enumerate(imgs):
        gain = 1.0 + exposure_drift * np.sin(2 * np.pi * i / 40.0)
        bias = 16.0 * exposure_drift * np.sin(2 * np.pi * i / 37.0 + 1.0)
        out.append(degrade(img, rng, noise_sigma=noise_sigma,
                           exposure_gain=gain, exposure_bias=bias,
                           blur_sigma=blur_sigma))
    return out
