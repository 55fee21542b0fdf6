"""Example: NCC optical-flow point tracking over a clip with the
PyTorch/CUDA port (BASELINE config 2; the reference's run_OF_point_track
workload), the counterpart of ``examples/run_of_point_track.py``.

Dense LK flow per frame pair (fwd+bwd, one launch of the dense-warp
kernel per LK iteration) feeds the fixed-capacity track table with the
forward/backward consistency gate; corners re-seed dead slots each
frame.  Works on any image directory or, without one, a generated clip.
Runs on the card unless ``--device cpu`` is given.

Usage: python examples/run_of_point_track_torch.py [--frames N] [--device cpu] [imgdir]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from invcompcamtrack_torch import convert, synthetic
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.device import resolve
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.match.dense_flow import dense_flow_lk
from invcompcamtrack_torch.match.features import shi_tomasi_corners
from invcompcamtrack_torch.match.track import advance_tracks, make_track_table, point_pairs
from invcompcamtrack_torch.utils.viz import viz_flow


def synthetic_clip(n_frames, rng):
    scene = synthetic.make_scene(rng, wh=(256, 192), fc=(240.0, 242.0))
    p = np.zeros(6)
    frames = []
    for _ in range(n_frames):
        G = lie.se3_exp(torch.tensor(p, dtype=torch.float32)).double().numpy()
        frames.append(synthetic.render(scene, G))
        p = p + np.r_[0.01, 0.004, 0.004, rng.normal(size=3) * 0.001]
    return frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("imgdir", nargs="?", default=None)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args()
    dev = resolve(args.device)

    rng = np.random.default_rng(0)
    if args.imgdir:
        from invcompcamtrack_torch.utils.image import load_gray

        paths = sorted(pathlib.Path(args.imgdir).glob("*"))[: args.frames]
        frames = [load_gray(p) for p in paths]
    else:
        frames = synthetic_clip(args.frames, rng)

    L, pad = 3, 8
    pyrs = [build_pyramid(convert.tensor_from_numpy(f, dev, torch.float32), L, pad)
            for f in frames]
    table = make_track_table(args.capacity, window=6, device=dev)

    for i in range(len(frames) - 1):
        flow_f = dense_flow_lk(pyrs[i], pyrs[i + 1], pad, iters=4)
        flow_b = dense_flow_lk(pyrs[i + 1], pyrs[i], pad, iters=4)
        xy, valid = shi_tomasi_corners(pyrs[i + 1][0].img[pad:-pad, pad:-pad],
                                       max_corners=args.capacity, border=pad)
        table = advance_tracks(table, flow_f, flow_b, xy, valid)
        pairs, pvalid = point_pairs(table)
        n = int(pvalid.sum())
        disp = torch.linalg.vector_norm(pairs[:, 1] - pairs[:, 0], dim=1)
        med = float(disp[pvalid].median()) if n else float("nan")
        print(f"frame {i+1}: live tracks {int(table.alive.sum())}, "
              f"verified pairs {n}, median step {med:.2f} px")

    flow_np = flow_f.cpu().numpy()
    rendered = viz_flow(flow_np[..., 0], flow_np[..., 1])
    print("final flow field rendered:", rendered.shape, rendered.dtype)


if __name__ == "__main__":
    sys.exit(main())
