"""K4: the fused NCC scorer of the odometry verifier (port of
``invcompcamtrack_tpu/ops/ncc_pallas.py::ncc3_scores``).

Per point, three mean-removed ``psz x psz`` patches (from the oldest
image at the backward-chained pose, the reference image at the sample
pose, the newest image at the forward-chained pose) and the clamped
unit-norm correlations of (back, ref) and (ref, fwd).  ``ncc3_scores``
launches ``csrc/ncc3.cu`` on CUDA tensors, where only two floats per
point reach device memory, and ``ncc3_scores_plain`` on CPU tensors:
``gather_patches_plain(patch_norm=True)`` per plane and
``match/ncc.py::ncc_score`` per pair, the JAX package's XLA path.

The JAX package falls back to its XLA path when the three planes exceed
its kernel's fast memory (``ncc3_available``); here the kernel reads the
planes from device memory and applies to every float32 CUDA image.

The kernel takes the three centre arrays and computes each support start
and its weights with K5's device functions, which repeat the plain
version's ``image/taps.py`` operations in their order: kernel and plain
version place every support alike and form every patch pixel alike,
border and far-outside centres included (callers mask those).  A centre
that is not finite gives NaN in each score it enters, in both.  A call
is one device op.
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.match.ncc import ncc_score
from invcompcamtrack_torch.ops import _build
from invcompcamtrack_torch.ops.patch_gather import (
    MAX_PSZ,
    on_card,
    require,
    gather_patches_plain,
)

# kernel launches since the count was last set to 0
launches = {"ncc3_scores": 0}


def ncc3_scores_plain(img_back: torch.Tensor, img_ref: torch.Tensor,
                      img_fwd: torch.Tensor, uv_back: torch.Tensor,
                      uv_ref: torch.Tensor, uv_fwd: torch.Tensor,
                      psz: int, padding: int):
    """-> (corr_back_ref, corr_ref_fwd), each shaped like uv[..., 0]."""
    pb, pr, pf = (gather_patches_plain(im, uv, psz, padding, patch_norm=True)
                  for im, uv in ((img_back, uv_back), (img_ref, uv_ref),
                                 (img_fwd, uv_fwd)))
    return ncc_score(pb, pr), ncc_score(pr, pf)


def ncc3_scores(img_back: torch.Tensor, img_ref: torch.Tensor,
                img_fwd: torch.Tensor, uv_back: torch.Tensor,
                uv_ref: torch.Tensor, uv_fwd: torch.Tensor,
                psz: int, padding: int):
    """K4.  imgs: (Hp, Wp) f32 padded pyramid levels of one shape; uv_*:
    (..., 2) f32 unpadded pixel centres of one shape -> two (...,) f32
    tensors.  CPU tensors -> plain version, CUDA tensors -> kernel."""
    name = "ncc3_scores"
    if not on_card(name, img_ref):
        return ncc3_scores_plain(img_back, img_ref, img_fwd, uv_back, uv_ref,
                                 uv_fwd, psz, padding)
    if psz % 2 != 0 or not 2 <= psz <= MAX_PSZ:
        raise NotImplementedError(
            f"{name}: the kernel takes an even psz in [2, {MAX_PSZ}], got {psz}")
    dev = img_ref.device
    for arg, t in (("img_back", img_back), ("img_ref", img_ref), ("img_fwd", img_fwd),
                   ("uv_back", uv_back), ("uv_ref", uv_ref), ("uv_fwd", uv_fwd)):
        require(name, t.device == dev, f"{arg} is on {t.device}, not {dev}")
        require(name, t.dtype == torch.float32,
                f"{arg} must be float32, got {t.dtype}")
    for arg, t in (("img_back", img_back), ("img_ref", img_ref), ("img_fwd", img_fwd)):
        require(name, t.dim() == 2 and t.is_contiguous() and t.shape == img_ref.shape,
                f"{arg} must be a contiguous 2-D plane of the shape of img_ref")
    require(name, uv_ref.shape[-1] == 2 and uv_back.shape == uv_ref.shape
            and uv_fwd.shape == uv_ref.shape, "uv_* must share one (..., 2) shape")
    Hp, Wp = img_ref.shape
    require(name, min(Hp, Wp) >= psz + 1,
            f"plane {tuple(img_ref.shape)} is smaller than the patch support")

    lead = uv_ref.shape[:-1]
    flat = [uv.reshape(-1, 2).contiguous() for uv in (uv_back, uv_ref, uv_fwd)]
    M = flat[1].shape[0]
    out = torch.empty((M, 2), dtype=torch.float32, device=dev)
    if M > 0:
        lib = _build.load()
        code = lib.icgn_ncc3_scores(
            img_back.data_ptr(), img_ref.data_ptr(), img_fwd.data_ptr(), Hp, Wp,
            *(f.data_ptr() for f in flat), out.data_ptr(), M, psz, padding,
            _build.stream_ptr(dev))
        _build.check(lib, code, name)
        launches[name] += 1
    return out[:, 0].reshape(lead), out[:, 1].reshape(lead)
