"""N-pose forward/backward tracker + NCC verifier CLI (port of
``invcompcamtrack_tpu/cli/track_nposes.py``).

File-protocol-compatible with the reference binary
(reference: run_track_nposes.cpp:133-365; invoked by the MATLAB RANSAC
script, func_ransac_fitcameras_odom.m:117):

    python -m invcompcamtrack_torch.cli.track_nposes [--device cpu] INPUT.txt OUTPUT.txt

All pose samples are verified as ONE batch instead of the reference's
sequential sample loop, on the NVIDIA card unless ``--device cpu`` is
given; without a card it raises.

``main`` = parse and load -> ``run`` -> write: a caller that holds the
frames as arrays drives ``run`` itself and needs no image decoder.
"""

from __future__ import annotations

import sys


def cfg_of(data):
    """utils.io.NPosesInput -> ICGNParams."""
    from invcompcamtrack_torch.config import ICGNParams

    p = data.params
    return ICGNParams(
        lv_f=p["lv_f"], lv_l=p["lv_l"], psz=p["psz"], maxiter=p["maxiter"],
        normdp_ratio=p["normdp_ratio"], donorm=bool(p["donorm"]),
        dopatchnorm=bool(p["dopatchnorm"]), verbosity=p["verbosity"])


def inlier_masks_of(data):
    """The protocol's 1-based inlier ids per sample -> (S, N) bool."""
    import numpy as np

    masks = np.zeros((data.poses.shape[0], data.pt3d.shape[0]), bool)
    for s, ids in enumerate(data.inlier_ids):
        masks[s, np.asarray(ids) - 1] = True
    return masks


def run(data, images, device=None):
    """data: utils.io.NPosesInput; images: one grayscale float32 (H, W)
    array per ``data.filenames`` entry -> (pose_tracks (S, M, 6) float64,
    per-sample correlation rows, the ChainResult on the device).

    Each correlation row holds the scores of that sample's inlier points
    only, in protocol order (the reference writes nopoints = per-sample
    inliers)."""
    import numpy as np

    from invcompcamtrack_torch import convert
    from invcompcamtrack_torch.core.camera import CameraPyramid
    from invcompcamtrack_torch.device import resolve
    from invcompcamtrack_torch.solver.chain import track_nposes

    device = resolve(device)
    cfg = cfg_of(data)
    cam = CameraPyramid.create(data.fc, data.cc, data.wh, cfg.num_levels, cfg.psz,
                               device=device)
    pyramids, poses, pt3d, masks = convert.nposes_from_numpy(
        data.poses, data.pt3d, inlier_masks_of(data), images,
        num_levels=cfg.num_levels, padding=cfg.psz, device=device)
    res = track_nposes(pyramids, poses, pt3d, masks, cam, cfg,
                       fb_frames=data.fb_frames)
    corr = res.correlations.cpu().numpy()
    corr_rows = [corr[s, np.asarray(ids) - 1] for s, ids in enumerate(data.inlier_ids)]
    return res.pose_tracks.cpu().numpy().astype(np.float64), corr_rows, res


def main(argv=None, device=None):
    from invcompcamtrack_torch.cli._args import split_device

    argv, device = split_device(list(sys.argv[1:] if argv is None else argv), device)
    if len(argv) != 2:
        print(__doc__)
        return 2

    from invcompcamtrack_torch.utils import io
    from invcompcamtrack_torch.utils.image import load_gray

    data = io.read_nposes_input(argv[0])
    pose_tracks, corr_rows, _ = run(data, [load_gray(f) for f in data.filenames],
                                    device)
    io.write_nposes_result(argv[1], pose_tracks, corr_rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
