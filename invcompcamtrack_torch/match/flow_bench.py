"""Flow-quality benchmark: magnitude-binned EPE of the flow estimators
on analytic-ground-truth synthetic pairs (port of
``invcompcamtrack_tpu/match/flow_bench.py``).

The reference froze Sintel-subset EPE tables for its DIS / NCC / MOSSE
flow variants (reference: misc_src/run_OF_NCC_eval.py:90-130,195-211).
This harness renders plane-scene image pairs whose dense GT flow is
available in closed form (ray-plane intersection + reprojection) and
runs the same magnitude-binned evaluation (match/flow_eval.py) over:

- ``lk``:    dense pyramidal LK (match/dense_flow.py, K8),
- ``ncc``:   LK-seeded FFT-NCC patch refinement at grid points (K5 at the
             patch side, 32 by default),
- ``mosse``: LK-seeded MOSSE-filter refinement (reference:
             run_OF_NCC_VOT_test.py:108-135 machinery).

The estimators run on ``device`` (the card by default); the ground truth,
the grid and the aggregation are numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from invcompcamtrack_torch.device import resolve
from invcompcamtrack_torch.image.patch import extract_patches
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.match.dense_flow import dense_flow_lk
from invcompcamtrack_torch.match.flow_eval import flow_epe_binned
from invcompcamtrack_torch.match.ncc import (
    cosine_window,
    mosse_filter,
    mosse_response,
    ncc_surface_fft,
    peak_subpixel,
)


def plane_gt_flow(scene, G0: np.ndarray, G1: np.ndarray) -> np.ndarray:
    """Dense analytic GT flow frame0 -> frame1 for the plane scene.

    Backproject each frame-0 pixel onto the world plane z = z0, then
    reproject into frame 1.  Returns (H, W, 2) float64.
    """
    W, H = scene.wh
    fx, fy = scene.fc
    cx, cy = scene.cc
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
    R0, t0 = G0[:, :3], G0[:, 3]
    c0 = -R0.T @ t0
    dw = d @ R0  # = R0^T d per pixel
    lam = (scene.z0 - c0[2]) / dw[..., 2]
    X = c0 + lam[..., None] * dw
    R1, t1 = G1[:, :3], G1[:, 3]
    Xc = X @ R1.T + t1
    u1 = Xc[..., 0] / Xc[..., 2] * fx + cx
    v1 = Xc[..., 1] / Xc[..., 2] * fy + cy
    return np.stack([u1 - u, v1 - v], axis=-1)


def _grid_points(wh, margin: int, step: int) -> np.ndarray:
    xs = np.arange(margin, wh[0] - margin, step, dtype=np.float32)
    ys = np.arange(margin, wh[1] - margin, step, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)


def _patch_refine(img0_pyr, img1_pyr, xy, seed_flow, psz, padding, method):
    """Correlation refinement of a seeded displacement at grid points."""
    img0 = img0_pyr[0].img
    dev = img0.device
    win = cosine_window(psz, device=dev)
    tpl = extract_patches(img0, torch.as_tensor(xy, device=dev), psz, padding)
    qry = extract_patches(img1_pyr[0].img, torch.as_tensor(xy + seed_flow, device=dev),
                          psz, padding)
    tpl = (tpl - tpl.mean(dim=(-2, -1), keepdim=True)) * win
    qry = (qry - qry.mean(dim=(-2, -1), keepdim=True)) * win
    if method == "ncc":
        surf = ncc_surface_fft(tpl[:, None], qry[:, None])
    else:
        h = mosse_filter(tpl[:, None], gsigma=2.0)
        surf = torch.fft.fftshift(mosse_response(h, qry[:, None]), dim=(-2, -1))
    off, _ = peak_subpixel(surf)
    # clamp wild peaks (beyond quarter patch) back to the seed
    off = torch.where(torch.abs(off) <= psz // 4, off, torch.zeros_like(off))
    return seed_flow + off.cpu().numpy()


def _binned(gt, est) -> dict:
    return {k: float(v) for k, v in flow_epe_binned(gt, est).items()}


def evaluate_pair(scene, G0, G1, img0, img1, psz: int = 32, grid_step: int = 16,
                  device: torch.device | str | None = None):
    """Run all estimators on one pair; returns dict of binned EPE dicts
    plus the raw per-grid-point errors."""
    dev = resolve(device)
    pad = psz
    pyr0 = build_pyramid(torch.as_tensor(np.asarray(img0, np.float32), device=dev), 4, pad)
    pyr1 = build_pyramid(torch.as_tensor(np.asarray(img1, np.float32), device=dev), 4, pad)
    gt = plane_gt_flow(scene, G0, G1)

    flow_dev = dense_flow_lk(pyr0, pyr1, pad, iters=4, radius=4)
    flow_lk = flow_dev.cpu().numpy()
    out = {"lk": _binned(torch.as_tensor(gt.astype(np.float32), device=dev), flow_dev)}

    xy = _grid_points(scene.wh, margin=psz, step=grid_step)
    # KITTI-style validity: the GT correspondence must land inside
    # frame 1 (points whose target leaves the frame have no data)
    tgt_all = xy + gt[xy[:, 1].astype(int), xy[:, 0].astype(int)]
    inb = ((tgt_all[:, 0] >= 0) & (tgt_all[:, 0] < scene.wh[0])
           & (tgt_all[:, 1] >= 0) & (tgt_all[:, 1] < scene.wh[1]))
    xy = xy[inb]
    xi = xy[:, 0].astype(int)
    yi = xy[:, 1].astype(int)
    gt_pts = gt[yi, xi].astype(np.float32)
    seed = flow_lk[yi, xi]
    raw = {"lk": (np.linalg.norm(gt_pts, axis=1),
                  np.linalg.norm(seed - gt_pts, axis=1))}
    for method in ("ncc", "mosse"):
        est = _patch_refine(pyr0, pyr1, xy, seed, psz, pad, method)
        out[method] = _binned(torch.as_tensor(gt_pts[:, None], device=dev),
                              torch.as_tensor(est[:, None], device=dev))
        raw[method] = (np.linalg.norm(gt_pts, axis=1),
                       np.linalg.norm(est - gt_pts, axis=1))
    out["gt_mag_mean"] = float(np.linalg.norm(gt_pts, axis=1).mean())
    out["_raw"] = raw
    return out


def run_benchmark(rng, wh=(640, 480), n_pairs: int = 6,
                  device: torch.device | str | None = None):
    """Render pairs spanning the magnitude bins and aggregate binned EPE
    per method.  Returns (per-method mean dicts, per-pair raw rows)."""
    from invcompcamtrack_torch.core import lie
    from invcompcamtrack_torch.vo import synthetic

    def se3_exp(p):
        return lie.se3_exp(torch.as_tensor(p, dtype=torch.float64)).numpy()

    scene = synthetic.make_scene(rng, wh=wh, fc=(0.9 * wh[0], 0.95 * wh[0]),
                                 freq_range=(0.3, 4.0))
    G0 = se3_exp(np.zeros(6))
    img0 = synthetic.render(scene, G0)

    # pose steps whose image motion spans <10 / 10-40 / >=40 px
    mags = np.linspace(0.05, 0.75, n_pairs)
    rows = []
    for m in mags:
        p1 = np.r_[m * 0.8, m * 0.35, m * 0.1,
                   0.004 * m, 0.006 * m, 0.003 * m]
        G1 = se3_exp(p1)
        img1 = synthetic.render(scene, G1)
        rows.append(evaluate_pair(scene, G0, G1, img0, img1, device=device))

    # aggregate over the CONCATENATED per-grid-point errors of all pairs
    # (per-pair bin means would dilute empty bins with zeros)
    agg = {}
    for method in ("lk", "ncc", "mosse"):
        mag = np.concatenate([r["_raw"][method][0] for r in rows])
        err = np.concatenate([r["_raw"][method][1] for r in rows])
        agg[method] = {
            "all": float(err.mean()),
            "s<10": float(err[mag < 10].mean()) if np.any(mag < 10) else 0.0,
            "s10-40": float(err[(mag >= 10) & (mag < 40)].mean())
            if np.any((mag >= 10) & (mag < 40)) else 0.0,
            "s>=40": float(err[mag >= 40].mean()) if np.any(mag >= 40) else 0.0,
        }
    return agg, rows
