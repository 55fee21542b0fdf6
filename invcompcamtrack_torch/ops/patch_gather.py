"""K1: the per-scale dual gather of the tracker (port of
``invcompcamtrack_tpu/ops/patch_pallas.py::gather_ref_grad_and_windows``).

For each point: the reference patch at its sub-pixel center with the
two gradient patches, and the integer-origin query window that the GN
iterations resample from.  ``gather_ref_grad_windows`` launches the
CUDA kernel ``csrc/patch_gather.cu`` on CUDA tensors and the plain
version ``gather_ref_grad_windows_plain`` on CPU tensors.  Both take
their indices and weights from the same code (``image/patch.py``), and
both move a support or window that would leave the plane back inside it
(the ``dynamic_slice`` rule of the JAX package's XLA twins, which the
TPU kernel does not follow at the frustum border).
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.image.patch import (
    bilinear_base,
    clamp_to_fit,
    extract_patches_grad,
)
from invcompcamtrack_torch.image.pyramid import PyramidLevel
from invcompcamtrack_torch.ops import _build
from invcompcamtrack_torch.ops.window_sample import gather_windows_any

# kernel launches since the count was last set to 0
launches = {"gather_ref_grad_windows": 0}


def gather_ref_grad_windows_plain(ref: PyramidLevel, query_img: torch.Tensor,
                                  centers: torch.Tensor, origins: torch.Tensor,
                                  psz: int, padding: int, win: int,
                                  patch_norm: bool = False):
    """extract_patches_grad on the reference level + gather_windows_any
    on the query image -> p_img, p_dx, p_dy (..., psz, psz) and qwin
    (..., win, win)."""
    p_img, p_dx, p_dy = extract_patches_grad(ref.img, ref.dx, ref.dy, centers,
                                             psz, padding, patch_norm)
    return p_img, p_dx, p_dy, gather_windows_any(query_img, origins, win)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gather_ref_grad_windows: {msg}")


def gather_ref_grad_windows(ref: PyramidLevel, query_img: torch.Tensor,
                            centers: torch.Tensor, origins: torch.Tensor,
                            psz: int, padding: int, win: int,
                            patch_norm: bool = False):
    """Dual gather; CPU tensors -> plain version, CUDA tensors -> kernel.

    ref: padded reference level (the kernel reads ``ref.img`` only and
    forms the gradient patches from it); query_img: padded query plane
    of the same shape; centers (..., 2) f32 unpadded coords; origins
    (..., 2) int32 window origins in the padded plane.
    """
    img = ref.img
    if img.device.type == "cpu":
        return gather_ref_grad_windows_plain(ref, query_img, centers, origins,
                                             psz, padding, win, patch_norm)
    if img.device.type != "cuda":
        raise ValueError(f"gather_ref_grad_windows: no kernel for {img.device}")
    if (psz, win) != (_build.PSZ, _build.WIN):
        raise NotImplementedError(
            f"gather_ref_grad_windows: the kernel is built for psz={_build.PSZ}, "
            f"win={_build.WIN}; got psz={psz}, win={win}")
    for name, t in (("ref.img", img), ("query_img", query_img),
                    ("centers", centers)):
        _require(t.device == img.device, f"{name} is on {t.device}, not {img.device}")
        _require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
    _require(origins.device == img.device and origins.dtype == torch.int32,
             "origins must be int32 on the planes' device")
    _require(img.dim() == 2 and query_img.shape == img.shape,
             "planes must be 2-D and of one shape")
    _require(img.is_contiguous() and query_img.is_contiguous(),
             "planes must be contiguous")
    _require(centers.shape[-1] == 2 and origins.shape == centers.shape,
             "centers and origins must both be (..., 2)")
    Hp, Wp = img.shape
    _require(Hp >= win and Wp >= win, f"plane {tuple(img.shape)} is smaller "
             f"than the {win}x{win} window")

    lead = centers.shape[:-1]
    flat_c = centers.reshape(-1, 2)
    flat_o = origins.reshape(-1, 2)
    M = flat_c.shape[0]
    row0, col0, w = bilinear_base(flat_c, psz, padding)
    idx = torch.stack([clamp_to_fit(row0, psz + 1, Hp),
                       clamp_to_fit(col0, psz + 1, Wp),
                       clamp_to_fit(flat_o[:, 0], win, Hp),
                       clamp_to_fit(flat_o[:, 1], win, Wp)], dim=1)
    idx = idx.to(torch.int32).contiguous()
    w = w.contiguous()
    p_img = torch.empty((M, psz, psz), dtype=torch.float32, device=img.device)
    p_dx = torch.empty_like(p_img)
    p_dy = torch.empty_like(p_img)
    qwin = torch.empty((M, win, win), dtype=torch.float32, device=img.device)
    if M > 0:
        lib = _build.load()
        code = lib.icgn_gather_ref_grad_windows(
            img.data_ptr(), query_img.data_ptr(), Hp, Wp, idx.data_ptr(),
            w.data_ptr(), p_img.data_ptr(), p_dx.data_ptr(), p_dy.data_ptr(),
            qwin.data_ptr(), M, padding, _build.stream_ptr(img.device))
        _build.check(lib, code, "gather_ref_grad_windows")
        launches["gather_ref_grad_windows"] += 1
    if patch_norm:
        p_img = p_img - torch.mean(p_img, dim=(-2, -1), keepdim=True)
    shp = lead + (psz, psz)
    return (p_img.reshape(shp), p_dx.reshape(shp), p_dy.reshape(shp),
            qwin.reshape(lead + (win, win)))
