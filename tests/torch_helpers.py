"""Shared set-up of the port's tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages: the
JAX package as explicit float32 arrays (``conftest.py`` turns on x64),
the port through ``invcompcamtrack_torch.convert``.
"""

import numpy as np
import torch

from invcompcamtrack_tpu.vo import synthetic
from tests.oracles import geometry_np as geo

# tier-1 runs several xdist workers on a few cores
torch.set_num_threads(1)


def make_pair(rng, n_pts, wh=(320, 240)):
    """The tests/test_icgn.py scene: a textured plane seen from the
    identity pose and from a small random pose p_gt.  Returns the scene,
    p_gt, both float32 images and (n_pts, 3) float32 plane points."""
    scene = synthetic.make_scene(rng, wh=wh)
    p_gt = np.r_[rng.normal(size=3) * 0.02, rng.normal(size=3) * 0.01]
    img_ref = synthetic.render(scene, geo.se3_exp(np.zeros(6)))
    img_new = synthetic.render(scene, geo.se3_exp(p_gt))
    X = synthetic.sample_plane_points(scene, rng, n_pts)
    return (scene, p_gt, img_ref.astype(np.float32), img_new.astype(np.float32),
            X.astype(np.float32))


def t32(a, device="cpu"):
    """numpy -> float32 tensor."""
    return torch.tensor(np.asarray(a, np.float32), device=device)
