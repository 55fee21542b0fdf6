"""K9: the prefetch-pipelined dual gather (port of
``invcompcamtrack_tpu/ops/patch_prefetch.py``).

It gives K1's four outputs (``ops/patch_gather.py``: the reference
patch, its two gradient patches and the query window per point), bit
for bit, by another schedule: a persistent grid whose warps walk strips
of points with a two-stage ring in shared memory, the asynchronous
copies of the next point's blocks in flight while the current point's
taps, gradients and window copy run (``csrc/patch_prefetch.cu``).  The
tracker takes it for ``ICGNParams.gather_prefetch=True``, which stays
off by default, where ``supported`` holds, and K1 elsewhere: the branch
of the JAX tracker.

The JAX module's plan (24 row-shifted copies of each plane, packed index
words and their bit-field limits) serves the TPU's block-aligned copies
and has no counterpart; ``supported`` keeps the shape rule that remains.
At the frustum border the port follows K1 in the port: a window that
would leave the plane is moved back inside it.

The plain version is K1's, under K9's name: the outputs are the same by
definition.
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.image.pyramid import PyramidLevel
from invcompcamtrack_torch.ops import _build, patch_gather

# kernel launches since the count was last set to 0
launches = {"gather_ref_grad_windows_prefetch": 0}

gather_ref_grad_windows_prefetch_plain = patch_gather.gather_ref_grad_windows_plain


def supported(psz: int, win: int, dtype: torch.dtype = torch.float32) -> bool:
    """The kernel is built for the production shape, psz 8 with 16x16
    windows of float32 planes (the JAX module's rule for its fixed shift
    count says the same; its geometry test of the packed index words is
    always true here)."""
    return psz == _build.PSZ and win == _build.WIN and dtype == torch.float32


def gather_ref_grad_windows_prefetch(ref: PyramidLevel, query_img: torch.Tensor,
                                     centers: torch.Tensor, origins: torch.Tensor,
                                     psz: int, padding: int, win: int,
                                     patch_norm: bool = False):
    """K9: K1's arguments and outputs.  CPU tensors -> plain version,
    CUDA tensors -> kernel."""
    name = "gather_ref_grad_windows_prefetch"
    if not patch_gather.on_card(name, ref.img):
        return gather_ref_grad_windows_prefetch_plain(
            ref, query_img, centers, origins, psz, padding, win, patch_norm)
    return patch_gather.dual_gather(name, "icgn_gather_prefetch", launches, ref,
                                    query_img, centers, origins, psz, padding,
                                    win, patch_norm)
