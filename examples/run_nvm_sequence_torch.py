"""NVM sequence replay driver on the PyTorch port (the counterpart of
``examples/run_nvm_sequence.py``).

The reference's MATLAB oracle loop (reference:
run_odometer_test.m:21-39,197-244): load an NVM model (or synthesize
one), normalise it, track frame to frame through the byte-level CLI
protocol (the port's ``cli/track_pair.py``: K1 and K2 on the card), and
print each frame's camera-centre error against the model's cameras.

Usage:
  python examples/run_nvm_sequence_torch.py --synthetic [--device cpu]
  python examples/run_nvm_sequence_torch.py --nvm model.nvm --images 'seq/*.png' \\
      --fc 1000 1200 --cc 640 360 --wh 1280 720
"""

import argparse
import glob
import json
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nvm")
    ap.add_argument("--images")
    ap.add_argument("--fc", nargs=2, type=float)
    ap.add_argument("--cc", nargs=2, type=float)
    ap.add_argument("--wh", nargs=2, type=int)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--out", default="nvm_replay_metrics.jsonl")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    from invcompcamtrack_torch.vo import replay

    workdir = pathlib.Path(tempfile.mkdtemp(prefix="nvm_replay_"))
    if args.synthetic or not args.nvm:
        rng = np.random.default_rng(0)
        nvm_path, image_paths, fc, cc, wh = replay.make_synthetic_nvm_scenario(
            rng, workdir / "scenario", n_frames=args.frames)
        print(f"synthetic NVM scenario at {workdir / 'scenario'}")
    else:
        nvm_path = args.nvm
        image_paths = sorted(glob.glob(args.images))
        fc, cc, wh = tuple(args.fc), tuple(args.cc), tuple(args.wh)

    poses, err = replay.replay_sequence(nvm_path, image_paths, workdir, fc, cc, wh,
                                        verbose=True, device=args.device)
    with open(args.out, "w") as f:
        for i, e in enumerate(err):
            f.write(json.dumps({"frame": i, "center_err": float(e)}) + "\n")
    print(f"frames: {len(err)}  mean center err: {err.mean():.5f}  "
          f"max: {err.max():.5f}  (normalized units)")
    return poses, err


if __name__ == "__main__":
    main()
