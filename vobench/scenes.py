"""The benchmark's inputs, made from ``--seed``: textured planes
rendered through exact ray-plane intersection, camera paths and 2-D/3-D
correspondences with outliers.

A frozen copy of the port's ``vo/synthetic.py`` plane scene and renderer
and of the generators that ``chip_smoke.py`` (``problem_geometry``,
``ransac_problem``, phase 4e's pose steps) drove the port with, kept
here so that a change to the program leaves the inputs as they are.
Scenes are drawn with numpy's generator on the host; frames are
rendered on the device in float64 in a few large calls and
handed to the caller as float32 host arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def rng(seed: int, *stream) -> np.random.Generator:
    """numpy's generator for one stream of a run's draws: the run's seed
    (any whole number) and the stream's own indices."""
    return np.random.default_rng([seed % 2**63, *stream])


class PlaneScene(NamedTuple):
    tex_freqs: np.ndarray   # (K, 2) spatial frequencies
    tex_phases: np.ndarray  # (K,)
    tex_amps: np.ndarray    # (K,)
    z0: float               # world plane z = z0
    fc: tuple
    cc: tuple
    wh: tuple


def make_scene(rng: np.random.Generator, wh, fc, cc=None, z0=8.0, num_waves=24,
               freq_range=(2.0, 20.0)) -> PlaneScene:
    """A band-limited sum-of-sines texture on the plane z = z0."""
    if cc is None:
        cc = (wh[0] / 2.0 + 1.5, wh[1] / 2.0 - 2.0)
    freqs = rng.uniform(freq_range[0], freq_range[1], size=(num_waves, 2)) * rng.choice(
        [-1.0, 1.0], size=(num_waves, 2))
    return PlaneScene(tex_freqs=freqs, tex_phases=rng.uniform(0, 2 * np.pi, size=num_waves),
                      tex_amps=rng.uniform(0.3, 1.0, size=num_waves) * (128.0 / num_waves * 3),
                      z0=z0, fc=tuple(fc), cc=tuple(cc), wh=tuple(wh))


def se3_exp(p: np.ndarray) -> np.ndarray:
    """p (..., 6) = [t, w] -> [R | V t] (..., 3, 4), float64."""
    p = np.asarray(p, np.float64)
    t, w = p[..., :3], p[..., 3:]
    th2 = np.sum(w * w, axis=-1)[..., None, None]
    th = np.sqrt(th2)
    small = th2 < 1e-12
    ths = np.where(small, 1.0, th)
    a = np.where(small, 1.0 - th2 / 6.0, np.sin(ths) / ths)
    b = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(ths)) / (ths * ths))
    c = np.where(small, 1.0 / 6.0 - th2 / 120.0, (ths - np.sin(ths)) / (ths ** 3))
    W = np.zeros(w.shape[:-1] + (3, 3))
    W[..., 0, 1], W[..., 0, 2], W[..., 1, 2] = -w[..., 2], w[..., 1], -w[..., 0]
    W[..., 1, 0], W[..., 2, 0], W[..., 2, 1] = w[..., 2], -w[..., 1], w[..., 0]
    W2 = W @ W
    eye = np.eye(3)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    return np.concatenate([R, (V @ t[..., None])], axis=-1)


def _rays(wh, fc, cc, R, dev):
    W, H = wh
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                          torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    d_cam = torch.stack([(u - cc[0]) / fc[0], (v - cc[1]) / fc[1], torch.ones_like(u)], -1)
    return d_cam @ torch.as_tensor(R, device=dev)          # R^T d per pixel


def _waves(s, t, freqs, phases, amps, dev):
    f = torch.as_tensor(freqs, device=dev)
    ph = torch.as_tensor(phases, device=dev)
    am = torch.as_tensor(amps, device=dev)
    arg = s[..., None] * f[:, 0] + t[..., None] * f[:, 1] + ph
    return (torch.sin(arg) * am).sum(-1)


def render(scene: PlaneScene, G: np.ndarray, device) -> torch.Tensor:
    """The plane through camera [R|t] (world -> camera): (H, W) float64."""
    R, tr = G[:, :3], G[:, 3]
    c = -R.T @ tr
    d = _rays(scene.wh, scene.fc, scene.cc, R, device)
    lam = (scene.z0 - c[2]) / d[..., 2]
    return 128.0 + _waves(c[0] + lam * d[..., 0], c[1] + lam * d[..., 1], scene.tex_freqs,
                          scene.tex_phases, scene.tex_amps, device)


def sample_plane_points(scene: PlaneScene, rng: np.random.Generator, n: int,
                        margin: float = 20.0) -> np.ndarray:
    """n world points on the plane, uniform over the identity camera's
    frustum with a pixel margin."""
    W, H = scene.wh
    u = rng.uniform(margin, W - margin, size=n)
    v = rng.uniform(margin, H - margin, size=n)
    return np.stack([(u - scene.cc[0]) / scene.fc[0] * scene.z0,
                     (v - scene.cc[1]) / scene.fc[1] * scene.z0, np.full(n, scene.z0)], axis=1)


def path_clip(n: int, rng: np.random.Generator) -> np.ndarray:
    """``chip_smoke.py`` phase 4e's clip: steps of (0.01, 0.004, 0.004)
    with rotations of 0.001 rad drawn from ``rng``."""
    poses = [np.zeros(6)]
    for _ in range(1, n):
        poses.append(poses[-1] + np.r_[0.01, 0.004, 0.004, rng.normal(size=3) * 0.001])
    return np.stack(poses)


def render_many(fn, scene, Gs, device) -> np.ndarray:
    """Render each camera of ``Gs`` on ``device`` -> (n, H, W) float32 on
    the host."""
    out = [fn(scene, G, device).to(torch.float32) for G in Gs]
    return torch.stack(out).cpu().numpy()


def correspondences(scene: PlaneScene, G: np.ndarray, X: np.ndarray,
                    rng: np.random.Generator, noise_px: float, n_out: int,
                    out_px=(30.0, 120.0)) -> np.ndarray:
    """``chip_smoke.py::ransac_problem``: X (N, 3) seen through G with
    ``noise_px`` of Gaussian noise, the first ``n_out`` moved by
    ``out_px`` in each coordinate -> (N, 2) float32 pixels."""
    Xc = X @ G[:, :3].T + G[:, 3]
    uv = Xc[:, :2] / Xc[:, 2:] * np.asarray(scene.fc) + np.asarray(scene.cc)
    uv = uv + rng.normal(size=uv.shape) * noise_px
    sign = rng.choice([-1.0, 1.0], size=(n_out, 2))
    uv[:n_out] += sign * rng.uniform(out_px[0], out_px[1], size=(n_out, 2))
    return uv.astype(np.float32)


def ping_pong(i: int, n: int) -> int:
    """Frame index of step i over n frames played forward then backward
    (0, 1, ..., n-1, n-2, ..., 1, 0, 1, ...)."""
    period = 2 * (n - 1)
    k = i % period
    return k if k < n else period - k
