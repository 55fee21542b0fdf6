"""Single image-pair pose tracker CLI (port of
``invcompcamtrack_tpu/cli/track_pair.py``).

Argv- and file-protocol-compatible with the reference binary
(reference: run_io_reprojection_test.cpp:99-236):

    python -m invcompcamtrack_torch.cli.track_pair [--device cpu] \\
        IMG_A IMG_B INFILE OUTFILE \\
        LV_F LV_L PSZ MAXITER NORMDP_RATIO DONORM DOPATCHNORM MAXPT VERBOSITY

- INFILE: the binary point+camera protocol (utils/io.py),
- OUTFILE: 6 float64 of the refined pose,
- VERBOSITY == 1: repeat tracking 1000x and print wall time in the
  reference's format (reference: :209-231),
- VERBOSITY == 2: per-scale diagnostics.

MAXPT is accepted for argv parity but irrelevant (capacity is the
actual point count here).  The tracker runs on the NVIDIA card unless
``--device cpu`` is given; without a card it raises.

``main`` = parse and load -> ``run`` -> write: a caller that holds the
two images as arrays drives ``run`` itself and needs no image decoder.
"""

from __future__ import annotations

import sys
import time


def parse_cfg(argv):
    """The 9 solver arguments (LV_F ... VERBOSITY) -> ICGNParams."""
    from invcompcamtrack_torch.config import ICGNParams

    (lv_f, lv_l, psz, maxiter, normdp_ratio, donorm, dopatchnorm, _maxpt,
     verbosity) = argv
    return ICGNParams(
        lv_f=int(lv_f), lv_l=int(lv_l), psz=int(psz), maxiter=int(maxiter),
        normdp_ratio=float(normdp_ratio), donorm=bool(int(donorm)),
        dopatchnorm=bool(int(dopatchnorm)), verbosity=int(verbosity))


def run(cfg, data, images, device=None):
    """cfg: ICGNParams; data: utils.io.PointCamFile; images: the two
    grayscale float32 (H, W) arrays -> the refined pose, (6,) float64.
    Prints the reference's timing or per-scale lines as cfg.verbosity asks."""
    import numpy as np
    import torch

    from invcompcamtrack_torch import convert
    from invcompcamtrack_torch.core.camera import CameraPyramid
    from invcompcamtrack_torch.device import resolve
    from invcompcamtrack_torch.image.pyramid import build_pyramid
    from invcompcamtrack_torch.solver.icgn import track_pose

    device = resolve(device)
    cam = CameraPyramid.create(data.fc, data.cc, data.wh, cfg.num_levels, cfg.psz,
                               device=device)
    pyr_a, pyr_b = (build_pyramid(convert.tensor_from_numpy(im, device, torch.float32),
                                  cfg.num_levels, cfg.psz) for im in images)
    X = convert.tensor_from_numpy(data.pt3d, device, torch.float32)
    p0 = convert.tensor_from_numpy(data.pose, device, torch.float32)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def track():
        return track_pose(pyr_a, pyr_b, X, p0, cam, cfg, return_aux=True)

    p_out, aux = track()
    sync()

    if cfg.verbosity == 1:
        # The reference times 1000 repetitions, computes *milliseconds for
        # the 1000 runs*, and prints that number under a "(musec)" label:
        # ms/1000-runs is numerically identical to microseconds per run
        # (reference: run_io_reprojection_test.cpp:209-231).
        t0 = time.time()
        for _ in range(1000):
            p_out, aux = track()
        sync()
        tt = (time.time() - t0) * 1e3
        print(f"TIME (pose tracking) (musec): {tt:3g}")
    if cfg.verbosity == 2:
        for s, (it, ndp) in enumerate(zip(aux.iters.cpu().numpy(),
                                          aux.normdp.cpu().numpy())):
            print(f"Sc{cfg.lv_f - s:02d}: iters {int(it)}, |dp| {float(ndp):g}")
    return p_out.detach().cpu().numpy().astype(np.float64)


def main(argv=None, device=None):
    from invcompcamtrack_torch.cli._args import split_device

    argv, device = split_device(list(sys.argv[1:] if argv is None else argv), device)
    if len(argv) != 13:
        print(__doc__)
        return 2

    from invcompcamtrack_torch.utils import io
    from invcompcamtrack_torch.utils.image import load_gray

    img_a, img_b, infile, outfile = argv[:4]
    pose = run(parse_cfg(argv[4:]), io.read_pointcam(infile),
               [load_gray(img_a), load_gray(img_b)], device)
    io.write_pose_result(outfile, pose)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
