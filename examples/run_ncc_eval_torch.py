"""Example: the LK-vs-NCC-vs-MOSSE patch-matching evaluation with the
PyTorch/CUDA port, the counterpart of ``examples/run_ncc_eval.py`` (the
reference's correlation lab: run_OF_NCC_eval.py / run_OF_NCC_VOT_test.py).
It tracks points between two frames of a textured plane with (a)
pyramidal LK, (b) an FFT-NCC peak search and (c) a MOSSE peak search, and
prints their endpoint errors against the analytic correspondences.

Runs on the card unless ``--device cpu`` is given.

Usage: python examples/run_ncc_eval_torch.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.device import card_line, resolve
from invcompcamtrack_torch.image.patch import extract_patches
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.match import ncc
from invcompcamtrack_torch.match.lk import track_points_lk
from invcompcamtrack_torch.vo import synthetic

LABELS = ("LK", "FFT-NCC", "MOSSE")


def _exp(p):
    # the JAX example's exp: a float32 se3_exp, read back in float64
    return lie.se3_exp(torch.as_tensor(np.asarray(p), dtype=torch.float32)).numpy().astype(
        np.float64)


def ncc_eval(device=None, wh=(320, 240), n_points=150, with_uv=False):
    """The JAX example's pair and points -> {label: (n_points,) endpoint
    errors in pixels} for LK, FFT-NCC and MOSSE; with ``with_uv`` also
    {label: (n_points, 2) estimated positions in the second frame}."""
    dev = resolve(device)
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, wh=wh, fc=(300.0, 302.0))
    p_gt = np.r_[rng.normal(size=3) * 0.015, rng.normal(size=3) * 0.006]
    img_a = synthetic.render(scene, _exp(np.zeros(6)))
    img_b = synthetic.render(scene, _exp(p_gt))

    X = synthetic.sample_plane_points(scene, rng, n_points, margin=40)
    G = _exp(p_gt)
    Xc = X @ G[:, :3].T + G[:, 3]
    uv_a = np.stack([
        X[:, 0] / X[:, 2] * scene.fc[0] + scene.cc[0],
        X[:, 1] / X[:, 2] * scene.fc[1] + scene.cc[1]], 1)
    uv_b = np.stack([
        Xc[:, 0] / Xc[:, 2] * scene.fc[0] + scene.cc[0],
        Xc[:, 1] / Xc[:, 2] * scene.fc[1] + scene.cc[1]], 1)

    L, pad, P = 3, 16, 32

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    pa = build_pyramid(t32(img_a), L, pad)
    pb = build_pyramid(t32(img_b), L, pad)

    # (a) pyramidal LK
    ca = t32(uv_a)
    lk, _ = track_points_lk(pa, pb, ca, psz=8, padding=pad)

    # (b) FFT-NCC: search the PxP correlation surface around each point
    t = extract_patches(pa[0].img, ca, P, pad, patch_norm=True)
    q = extract_patches(pb[0].img, ca, P, pad, patch_norm=True)
    surf = ncc.ncc_surface_fft(t[:, None], q[:, None])
    off, _ = ncc.peak_subpixel(surf)

    # (c) MOSSE (its response is already centre-anchored)
    h = ncc.mosse_filter(t[:, None], gsigma=2.0, beta=0.1)
    resp = ncc.mosse_response(h, q[:, None])
    off_m, _ = ncc.peak_subpixel(resp)
    uv = {k: e.cpu().numpy().astype(np.float64)
          for k, e in zip(LABELS, (lk, ca + off, ca + off_m))}
    errs = {k: np.linalg.norm(e - uv_b, axis=1) for k, e in uv.items()}
    return (errs, uv) if with_uv else errs


def summary(err):
    """(mean, median, 95th percentile) of one method's endpoint errors."""
    return float(err.mean()), float(np.median(err)), float(np.percentile(err, 95))


def epe_line(label, err):
    mean, med, p95 = summary(err)
    return f"{label:8s} EPE mean {mean:6.3f}  median {med:6.3f}  p95 {p95:6.3f}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    print(card_line(dev))
    errs = ncc_eval(dev)
    for label, err in errs.items():
        print(epe_line(label, err))
    return errs


if __name__ == "__main__":
    main()
