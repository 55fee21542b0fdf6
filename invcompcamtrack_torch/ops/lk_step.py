"""One dense Lucas-Kanade iteration of ``match/dense_flow.py`` in one
launch: the gradients, the five box sums, the guarded 2x2 solve and the
flow update.

The kernel (``csrc/lk_step.cu``) is a kernel of the port with no TPU
counterpart: the JAX package leaves this iteration to XLA.  ``lk_step``
launches it on CUDA tensors and ``lk_step_plain`` on CPU tensors.  The
plain version is the iteration as the eager port always ran it, box sums
by ``F.conv2d`` with a ones kernel and zero padding, so iterating it
gives the eager loop's flows bit for bit.  The kernel takes the same float
operations through the non-contracting ``_rn`` intrinsics and sums each
window in the convolution's order, from 0, one product at a time, row by
row, left to right: it equals the plain version run on the CPU bit for
bit (at every radius but 1, whose 3x3 convolution the CPU sums in
another order; no caller takes it).

Both update ``flow`` in place and return it.  A pixel whose determinant
fails the guard keeps its flow bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from invcompcamtrack_torch.image.pyramid import central_gradients
from invcompcamtrack_torch.ops import _build
from invcompcamtrack_torch.ops.patch_gather import on_card, require

# kernel launches since the count was last set to 0
launches = {"lk_step": 0}

# the widest window radius the kernel's shared-memory halo is sized for
# (csrc/lk_step.cu: kLkMaxRadius)
MAX_RADIUS = 8


def _box(x: torch.Tensor, radius: int) -> torch.Tensor:
    k = 2 * radius + 1
    kernel = torch.ones((1, 1, k, k), dtype=x.dtype, device=x.device)
    return F.conv2d(x[None, None], kernel, padding=radius)[0, 0]


def lk_step_plain(I0: torch.Tensor, I1w: torch.Tensor, flow: torch.Tensor,
                  radius: int, min_det: float) -> torch.Tensor:
    """I0, I1w (H, W); flow (H, W, 2) in (dx, dy) order, updated in place."""
    Ix, Iy = central_gradients(I0)
    Ix = Ix * 0.5  # central_gradients returns unscaled I[x+1]-I[x-1]
    Iy = Iy * 0.5
    a11 = _box(Ix * Ix, radius)
    a12 = _box(Ix * Iy, radius)
    a22 = _box(Iy * Iy, radius)
    det = a11 * a22 - a12 * a12
    good = det > min_det
    det_safe = torch.where(good, det, torch.ones_like(det))
    It = I1w - I0
    b1 = _box(Ix * It, radius)
    b2 = _box(Iy * It, radius)
    du = (a22 * b1 - a12 * b2) / det_safe
    dv = (a11 * b2 - a12 * b1) / det_safe
    upd = torch.stack([du, dv], dim=-1)
    return flow.sub_(torch.where(good[..., None], upd, torch.zeros_like(upd)))


def lk_step(I0: torch.Tensor, I1w: torch.Tensor, flow: torch.Tensor,
            radius: int, min_det: float) -> torch.Tensor:
    """I0, I1w (H, W) f32, H, W >= 2; flow (H, W, 2) f32, updated in place
    and returned.  CPU tensors -> plain version, CUDA tensors -> kernel."""
    name = "lk_step"
    if not on_card(name, I0):
        return lk_step_plain(I0, I1w, flow, radius, min_det)
    require(name, I1w.device == I0.device and flow.device == I0.device,
            f"I1w and flow must be on {I0.device}, got {I1w.device} and {flow.device}")
    require(name, I0.dtype == I1w.dtype == flow.dtype == torch.float32,
            f"I0, I1w and flow must be float32, got {I0.dtype}, {I1w.dtype} and {flow.dtype}")
    require(name, I0.dim() == 2 and min(I0.shape) >= 2,
            f"I0 must be a 2-D plane of at least 2x2, got {tuple(I0.shape)}")
    H, W = I0.shape
    require(name, tuple(I1w.shape) == (H, W) and tuple(flow.shape) == (H, W, 2),
            f"I1w must be {(H, W)} and flow {(H, W, 2)}, got {tuple(I1w.shape)} and "
            f"{tuple(flow.shape)}")
    # flow is written in place as float2: it must be one aligned block
    require(name, I0.is_contiguous() and I1w.is_contiguous() and flow.is_contiguous()
            and flow.data_ptr() % 8 == 0,
            "I0, I1w and flow must be contiguous, flow 8-byte aligned")
    require(name, isinstance(radius, int) and 0 <= radius <= MAX_RADIUS,
            f"radius must be an int in [0, {MAX_RADIUS}], got {radius!r}")
    lib = _build.load()
    code = lib.icgn_lk_step(I0.data_ptr(), I1w.data_ptr(), flow.data_ptr(), H, W,
                            radius, float(min_det), _build.stream_ptr(I0.device))
    _build.check(lib, code, name)
    launches[name] += 1
    return flow
