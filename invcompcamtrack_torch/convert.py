"""Carry the tracker's state from the JAX package (or plain numpy) into
the port.

The tracker has no weights: its state is the two pyramids, the camera,
the world points and the poses.  These helpers take them as numpy
arrays, or anything ``numpy.asarray`` accepts (a JAX array included,
without this module importing JAX), and return the port's tensors on
the device asked for.  The tests feed both packages through them.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.image.pyramid import Pyramid, PyramidLevel


def tensor_from_numpy(a, device: torch.device | str = "cpu",
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """Copy an array to a tensor (dtype kept unless one is given)."""
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def pyramid_from_numpy(levels: Iterable, device: torch.device | str = "cpu",
                       dtype: torch.dtype = torch.float32) -> Pyramid:
    """A sequence of (img, dx, dy) padded planes per level -> Pyramid."""
    return tuple(PyramidLevel(*(tensor_from_numpy(a, device, dtype) for a in lvl))
                 for lvl in levels)


def camera_from_numpy(cam, device: torch.device | str = "cpu") -> CameraPyramid:
    """Any object with (L,) fields fx, fy, cx, cy, swo, sho and an int
    ``padding`` (such as the JAX package's CameraPyramid) ->
    the port's CameraPyramid, float32."""
    return CameraPyramid(
        **{k: tensor_from_numpy(getattr(cam, k), device, torch.float32)
           for k in ("fx", "fy", "cx", "cy", "swo", "sho")},
        padding=int(cam.padding))
