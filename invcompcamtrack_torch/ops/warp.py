"""K8: the dense backward warp (port of
``invcompcamtrack_tpu/ops/warp_pallas.py::warp_image_pallas``).

``out(x) = img(x + flow(x))``, bilinear and edge-clamped: the inner
operation of the dense coarse-to-fine LK flow, once per iteration.
``warp_image`` launches ``csrc/warp.cu`` on CUDA tensors and
``warp_image_plain`` on CPU tensors.  The plain version is the exact
per-pixel bilinear of the JAX package's XLA twin
(``match/dense_flow.py::warp_image``), and the kernel follows it
operation for operation.

A deliberate deviation from the TPU kernel: that kernel resolves a
pixel's offset only within 3 px of its (8, 128) tile's mean integer flow
and clamps beyond, so it is wrong across sharp flow discontinuities.  A
thread on the card addresses its own four taps, so neither the kernel
nor the plain version clamps: both are exact for any flow.

A flow that is huge or infinite samples the border pixel; a NaN flow
gives a NaN pixel.  The clamp is taken in float before the conversion to
an index, which otherwise differs between the CPU and the card.
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.ops import _build
from invcompcamtrack_torch.ops.patch_gather import on_card, require

# kernel launches since the count was last set to 0
launches = {"warp_image": 0}


def warp_image_plain(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img (H, W); flow (H, W, 2) in (dx, dy) order -> (H, W)."""
    H, W = img.shape
    yy, xx = torch.meshgrid(torch.arange(H, dtype=flow.dtype, device=flow.device),
                            torch.arange(W, dtype=flow.dtype, device=flow.device),
                            indexing="ij")
    sx = xx + flow[..., 0]
    sy = yy + flow[..., 1]
    x0 = torch.nan_to_num(torch.clamp(torch.floor(sx), 0, W - 2), nan=0.0)
    y0 = torch.nan_to_num(torch.clamp(torch.floor(sy), 0, H - 2), nan=0.0)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    at = y0.long() * W + x0.long()
    flat = img.reshape(-1)
    return ((1 - fx) * (1 - fy) * flat[at]
            + fx * (1 - fy) * flat[at + 1]
            + (1 - fx) * fy * flat[at + W]
            + fx * fy * flat[at + W + 1])


def warp_image(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """K8.  img (H, W) f32, H, W >= 2; flow (H, W, 2) f32 -> (H, W).
    CPU tensors -> plain version, CUDA tensors -> kernel."""
    name = "warp_image"
    if not on_card(name, img):
        return warp_image_plain(img, flow)
    require(name, flow.device == img.device,
            f"flow is on {flow.device}, not {img.device}")
    require(name, img.dtype == torch.float32 and flow.dtype == torch.float32,
            f"img and flow must be float32, got {img.dtype} and {flow.dtype}")
    require(name, img.dim() == 2 and min(img.shape) >= 2,
            "img must be a 2-D plane of at least 2x2")
    require(name, tuple(flow.shape) == tuple(img.shape) + (2,),
            f"flow must be {tuple(img.shape) + (2,)}, got {tuple(flow.shape)}")
    img = img.contiguous()     # a level stripped of its padding is a view
    flow = flow.contiguous()
    H, W = img.shape
    out = torch.empty_like(img)
    lib = _build.load()
    code = lib.icgn_warp_image(img.data_ptr(), flow.data_ptr(), out.data_ptr(),
                               H, W, _build.stream_ptr(img.device))
    _build.check(lib, code, name)
    launches[name] += 1
    return out
