"""The degraded-image robustness harness with the PyTorch/CUDA port, the
counterpart of ``examples/run_robustness.py``.

The accuracy log's corridor-fwd sequence re-run under increasing sensor
degradation (optical blur, drifting exposure gain and bias, additive
Gaussian noise: ``vo/synthetic.py::degrade_sequence``), with the
tracker's patch mean-normalisation (``dopatchnorm``, the reference's own
photometric countermeasure, reference: utilities.cpp:111-112) off and
on.  ``dopatchnorm=True`` takes the ``patch_norm`` route of the kernels
K1 and K2.

Writes ROBUSTNESS_torch.md (the JAX package's table is ROBUSTNESS.md);
runs on the card unless ``--device cpu`` is given.

Usage:  python examples/run_robustness_torch.py [--frames N] [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np

from run_accuracy_log_torch import _exp, path_corridor_fwd, run_sequence
from invcompcamtrack_torch.config import ICGNParams
from invcompcamtrack_torch.device import card_line, resolve
from invcompcamtrack_torch.vo import synthetic

LEVELS = [
    ("clean", dict(noise_sigma=0.0, exposure_drift=0.0, blur_sigma=0.0)),
    ("mild", dict(noise_sigma=2.0, exposure_drift=0.05, blur_sigma=0.5)),
    ("heavy", dict(noise_sigma=5.0, exposure_drift=0.15, blur_sigma=1.0)),
]


def _tracker(dopatchnorm: bool):
    return ICGNParams(lv_f=3, lv_l=0, psz=8, maxiter=8, normdp_ratio=0.01,
                      dopatchnorm=dopatchnorm)


def corridor_sequence(frames):
    """The JAX example's corridor, path and clean frames."""
    rng = np.random.default_rng(0)
    scene = synthetic.make_corridor(rng, wh=(640, 480), fc=(520.0, 525.0))
    path = path_corridor_fwd(frames)
    clean = [synthetic.render_corridor(scene, _exp(p)) for p in path]
    return scene, path, clean


def run_level(scene, path, clean, level, patchnorm, device=None, keep_poses=False):
    """One degradation level with ``dopatchnorm`` off or on -> its row."""
    deg = dict(LEVELS)[level]
    imgs = synthetic.degrade_sequence(clean, np.random.default_rng(99), **deg)
    r = run_sequence("corridor-fwd", scene, synthetic.render_corridor,
                     synthetic.sample_corridor_points, path, "hybrid", imgs=imgs,
                     cfg_overrides={"tracker": _tracker(patchnorm)}, device=device,
                     keep_poses=keep_poses)
    r.update(level=level, dopatchnorm=patchnorm, **deg)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default="ROBUSTNESS_torch.md")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    card = card_line(dev)
    print(card, flush=True)

    scene, path, clean = corridor_sequence(args.frames)
    rows = []
    for lvl, _ in LEVELS:
        for pn in (False, True):
            r = run_level(scene, path, clean, lvl, pn, dev)
            rows.append(r)
            print(f"[{card}] " + json.dumps(
                {k: (round(v, 5) if isinstance(v, float) else v) for k, v in r.items()
                 if k in ("level", "dopatchnorm", "ate_rmse", "final_drift",
                          "rpe_trans", "map_surface_rms", "fps_engine")}), flush=True)

    hdr = ("| level | blur px | exp drift | noise | dopatchnorm | ATE RMSE "
           "| final drift | RPE trans | map RMS | fps |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = [
        f"| {r['level']} | {r['blur_sigma']} | {r['exposure_drift']} "
        f"| {r['noise_sigma']} | {'on' if r['dopatchnorm'] else 'off'} "
        f"| {r['ate_rmse']:.4f} | {r['final_drift']:.4f} "
        f"| {r['rpe_trans']:.5f} | {r['map_surface_rms']:.4f} | {r['fps_engine']:.1f} |"
        for r in rows
    ]
    doc = f"""# Degraded-image robustness of the PyTorch/CUDA port (synthetic sensor model)

Generated by `python examples/run_robustness_torch.py --frames {args.frames}` on
`{card}`.  The JAX package's table is `ROBUSTNESS.md`.

The corridor-fwd sequence re-rendered through the sensor-degradation
model (`vo/synthetic.py::degrade_sequence`): separable Gaussian optical
blur, drifting exposure gain (±fraction shown) and bias, additive
Gaussian sensor noise (gray levels).  Engine config identical to
ACCURACY_torch.md (`hybrid` BA); only `dopatchnorm` (patch
mean-normalisation, the reference's photometric countermeasure,
reference: utilities.cpp:111-112) varies.  fps: the median rate of
20-frame `run_frames` chunks, the first excluded.

{hdr}{chr(10).join(lines)}
"""
    with open(args.out, "w") as f:
        f.write(doc)
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
