"""Batched sub-pixel patch extraction (port of
``invcompcamtrack_tpu/image/patch.py``).

``extract_patches`` and ``extract_patches_grad`` dispatch as the JAX
module's do: a CUDA tensor goes to the hand-written kernels K5 and K6
(``ops/patch_gather.py``), a CPU tensor to their plain versions there.
The sampling rule and the index, slice and tap helpers that both share
are in ``image/taps.py``.  The patch mean, when asked for, is taken on
the intensity plane only.
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.ops import patch_gather


def extract_patches(img: torch.Tensor, centers: torch.Tensor, psz: int,
                    padding: int, patch_norm: bool = False) -> torch.Tensor:
    """img (Hp, Wp) padded, centers (..., 2); or a stack of S planes
    (S, Hp, Wp), centers (S, ..., 2) -> (..., psz, psz).  K5 on a CUDA
    tensor, its plain version on a CPU tensor."""
    return patch_gather.gather_patches(img, centers, psz, padding, patch_norm)


def extract_patches_grad(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                         centers: torch.Tensor, psz: int, padding: int,
                         patch_norm: bool = False):
    """One (I, dI/dx, dI/dy) gather sharing indices and weights ->
    three (..., psz, psz) tensors; the mean applies to I only.  Planes
    and centres as ``extract_patches`` takes them.  K6 on a
    CUDA tensor (it forms the gradients from ``img`` and reads neither
    ``dx`` nor ``dy``), its plain version on a CPU tensor."""
    return patch_gather.gather_patches_grad(img, dx, dy, centers, psz, padding,
                                            patch_norm)
