"""The tracker's gathers K1, K5, K6 and K7 (port of
``invcompcamtrack_tpu/ops/patch_pallas.py``).

- K1 ``gather_ref_grad_windows`` (``gather_ref_grad_and_windows`` there):
  per point the reference patch at its sub-pixel center with the two
  gradient patches, and the integer-origin query window that the GN
  iterations resample from.  Built for psz 8, window 16.
- K5 ``gather_patches``: the ``psz x psz`` bilinear patch, any even psz
  (the descriptors call it at 18, the flow benchmark at 32).
- K6 ``gather_patches_grad``: K1 without the window, any even psz <= 16.
- K7 ``gather_windows``: the ``(wh, ww)`` window at an integer origin.

Each wrapper launches its CUDA kernel (``csrc/patch_gather.cu``) on CUDA
tensors and its plain version (``*_plain``) on CPU tensors.  The plain
versions take their indices and weights from ``image/taps.py``
(``bilinear_base``, ``clamp_to_fit``).  K5 and K6 take the centres: the
kernel computes each point's support start and weights with that code's
operations in its order, so a call without the patch mean is one device
op.  K1 takes the starts and weights that ``support_of`` makes with that
code (and so does K4, ``ops/ncc3.py``), K7 its clamped origins.  Kernels
and plain versions move a support or window that would leave the plane
back inside it (the ``dynamic_slice`` rule of the JAX package's XLA
twins, which the TPU kernels do not follow at the frustum border).  The
patch mean, when asked for, is removed by the wrapper with the plain
version's own ``torch.mean``, as the JAX package removes it outside its
kernels.
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.image.taps import (
    bilinear_base,
    clamp_to_fit,
    combine,
    patch_mean_removed,
    slice_windows,
)
from invcompcamtrack_torch.image.pyramid import PyramidLevel
from invcompcamtrack_torch.ops import _build

# kernel launches since the counts were last set to 0
launches = {"gather_ref_grad_windows": 0, "gather_patches": 0,
            "gather_patches_grad": 0, "gather_windows": 0}

# the largest side of K6 and K4; K5 serves the sides up to it with 32/psz
# points per warp and larger ones with one warp per point
MAX_PSZ = 16


# ---------------------------------------------------------------- plain


def gather_patches_plain(img: torch.Tensor, centers: torch.Tensor, psz: int,
                         padding: int, patch_norm: bool = False) -> torch.Tensor:
    """img (Hp, Wp) padded; centers (..., 2) -> (..., psz, psz)."""
    lead = centers.shape[:-1]
    row0, col0, w = bilinear_base(centers.reshape(-1, 2), psz, padding)
    patches = combine(slice_windows(img, row0, col0, psz + 1), w)
    patches = patches.reshape(lead + (psz, psz))
    return patch_mean_removed(patches) if patch_norm else patches


def gather_patches_grad_plain(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                              centers: torch.Tensor, psz: int, padding: int,
                              patch_norm: bool = False):
    """One (I, dI/dx, dI/dy) gather sharing indices and weights ->
    three (..., psz, psz) tensors; the mean applies to I only."""
    lead = centers.shape[:-1]
    row0, col0, w = bilinear_base(centers.reshape(-1, 2), psz, padding)
    planes = torch.stack([img, dx, dy])
    patches = combine(slice_windows(planes, row0, col0, psz + 1), w)
    p_img, p_dx, p_dy = (patches[k].reshape(lead + (psz, psz)) for k in range(3))
    if patch_norm:
        p_img = patch_mean_removed(p_img)
    return p_img, p_dx, p_dy


def gather_windows_plain(img: torch.Tensor, origins: torch.Tensor, wh: int,
                         ww: int) -> torch.Tensor:
    """Integer-origin (wh, ww) windows of the padded image; origins
    (..., 2) int32, each moved back inside the image if it would leave it."""
    flat = origins.reshape(-1, 2)
    out = slice_windows(img, flat[:, 0], flat[:, 1], (wh, ww))
    return out.reshape(origins.shape[:-1] + (wh, ww))


def gather_ref_grad_windows_plain(ref: PyramidLevel, query_img: torch.Tensor,
                                  centers: torch.Tensor, origins: torch.Tensor,
                                  psz: int, padding: int, win: int,
                                  patch_norm: bool = False):
    """gather_patches_grad_plain on the reference level +
    gather_windows_plain on the query image -> p_img, p_dx, p_dy
    (..., psz, psz) and qwin (..., win, win)."""
    p_img, p_dx, p_dy = gather_patches_grad_plain(ref.img, ref.dx, ref.dy, centers,
                                                  psz, padding, patch_norm)
    return p_img, p_dx, p_dy, gather_windows_plain(query_img, origins, win, win)


# ------------------------------------------------------------- wrappers


def on_card(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for CUDA; raises else."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    return True


def require(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_plane(name: str, img: torch.Tensor, arg: str = "img") -> None:
    require(name, img.dtype == torch.float32, f"{arg} must be float32, got {img.dtype}")
    require(name, img.dim() == 2 and img.is_contiguous(),
            f"{arg} must be a contiguous 2-D plane")


def _check_centers(name: str, img: torch.Tensor, centers: torch.Tensor) -> None:
    require(name, centers.device == img.device,
            f"centers is on {centers.device}, not {img.device}")
    require(name, centers.dtype == torch.float32,
            f"centers must be float32, got {centers.dtype}")
    require(name, centers.shape[-1] == 2, "centers must be (..., 2)")


def _check_origins(name: str, img: torch.Tensor, origins: torch.Tensor) -> None:
    require(name, origins.device == img.device and origins.dtype == torch.int32,
            "origins must be int32 on the planes' device")
    require(name, origins.shape[-1] == 2, "origins must be (..., 2)")


def _check_psz(name: str, img: torch.Tensor, psz: int,
               max_psz: int | None = None) -> None:
    """K5 takes any even psz; K6 up to ``max_psz`` (no caller goes beyond)."""
    if psz % 2 != 0 or psz < 2:
        raise NotImplementedError(f"{name}: the kernel takes an even psz, got {psz}")
    if max_psz is not None and psz > max_psz:
        raise NotImplementedError(
            f"{name}: the kernel takes an even psz up to {max_psz}, got {psz}: no "
            f"caller goes beyond, and gather_patches takes any even psz")
    require(name, min(img.shape) >= psz + 1,
            f"plane {tuple(img.shape)} is smaller than the patch support")


def support_of(img: torch.Tensor, flat_c: torch.Tensor, psz: int, padding: int):
    """Support starts (M, 2) int32, moved inside the plane, and the 4
    weights (M, 4), both contiguous."""
    Hp, Wp = img.shape
    row0, col0, w = bilinear_base(flat_c, psz, padding)
    idx = torch.stack([clamp_to_fit(row0, psz + 1, Hp),
                       clamp_to_fit(col0, psz + 1, Wp)], dim=1)
    return idx.to(torch.int32).contiguous(), w.contiguous()


def gather_patches(img: torch.Tensor, centers: torch.Tensor, psz: int,
                   padding: int, patch_norm: bool = False) -> torch.Tensor:
    """K5.  img (Hp, Wp) f32 padded; centers (..., 2) f32 unpadded coords
    -> (..., psz, psz)."""
    name = "gather_patches"
    if not on_card(name, img):
        return gather_patches_plain(img, centers, psz, padding, patch_norm)
    _check_plane(name, img)
    _check_centers(name, img, centers)
    _check_psz(name, img, psz)
    lead = centers.shape[:-1]
    flat = centers.reshape(-1, 2).contiguous()
    M = flat.shape[0]
    out = torch.empty((M, psz, psz), dtype=torch.float32, device=img.device)
    if M > 0:
        lib = _build.load()
        code = lib.icgn_gather_patches(
            img.data_ptr(), img.shape[0], img.shape[1], flat.data_ptr(),
            out.data_ptr(), M, psz, padding, _build.stream_ptr(img.device))
        _build.check(lib, code, name)
        launches[name] += 1
    out = out.reshape(lead + (psz, psz))
    return patch_mean_removed(out) if patch_norm else out


def gather_patches_grad(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                        centers: torch.Tensor, psz: int, padding: int,
                        patch_norm: bool = False):
    """K6.  As K5, plus the two gradient patches, which the kernel forms
    from a 1-px halo of ``img``: the pyramid's gradient planes are
    central differences of the image, zero on the border rows/columns and
    in the pad band, so ``dx`` and ``dy`` are not read on the card (the
    JAX package's kernel ignores them as well)."""
    name = "gather_patches_grad"
    if not on_card(name, img):
        return gather_patches_grad_plain(img, dx, dy, centers, psz, padding,
                                         patch_norm)
    _check_plane(name, img)
    _check_centers(name, img, centers)
    _check_psz(name, img, psz, MAX_PSZ)
    lead = centers.shape[:-1]
    flat = centers.reshape(-1, 2).contiguous()
    M = flat.shape[0]
    p_img = torch.empty((M, psz, psz), dtype=torch.float32, device=img.device)
    p_dx = torch.empty_like(p_img)
    p_dy = torch.empty_like(p_img)
    if M > 0:
        lib = _build.load()
        code = lib.icgn_gather_patches_grad(
            img.data_ptr(), img.shape[0], img.shape[1], flat.data_ptr(),
            p_img.data_ptr(), p_dx.data_ptr(), p_dy.data_ptr(), M, psz, padding,
            _build.stream_ptr(img.device))
        _build.check(lib, code, name)
        launches[name] += 1
    shp = lead + (psz, psz)
    p_img = p_img.reshape(shp)
    if patch_norm:
        p_img = patch_mean_removed(p_img)
    return p_img, p_dx.reshape(shp), p_dy.reshape(shp)


def gather_windows(img: torch.Tensor, origins: torch.Tensor, wh: int,
                   ww: int) -> torch.Tensor:
    """K7.  img (Hp, Wp) f32 padded; origins (..., 2) int32 (row, col)
    -> (..., wh, ww) copies."""
    name = "gather_windows"
    if not on_card(name, img):
        return gather_windows_plain(img, origins, wh, ww)
    _check_plane(name, img)
    _check_origins(name, img, origins)
    Hp, Wp = img.shape
    require(name, 1 <= wh <= Hp and 1 <= ww <= Wp,
            f"plane {tuple(img.shape)} is smaller than the {wh}x{ww} window")
    flat = origins.reshape(-1, 2)
    idx = torch.stack([clamp_to_fit(flat[:, 0], wh, Hp),
                       clamp_to_fit(flat[:, 1], ww, Wp)], dim=1).contiguous()
    M = idx.shape[0]
    out = torch.empty((M, wh, ww), dtype=torch.float32, device=img.device)
    if M > 0:
        lib = _build.load()
        code = lib.icgn_gather_windows(
            img.data_ptr(), Wp, idx.data_ptr(), out.data_ptr(), M, wh, ww,
            _build.stream_ptr(img.device))
        _build.check(lib, code, name)
        launches[name] += 1
    return out.reshape(origins.shape[:-1] + (wh, ww))


def dual_gather(name: str, entry: str, counts: dict, ref: PyramidLevel,
                query_img: torch.Tensor, centers: torch.Tensor,
                origins: torch.Tensor, psz: int, padding: int, win: int,
                patch_norm: bool):
    """Check, prepare and launch a dual-gather kernel on CUDA tensors: K1
    (``icgn_gather_ref_grad_windows``) or K9 (``icgn_gather_prefetch``,
    ``ops/patch_prefetch.py``), which take the same arguments and give the
    same outputs.  ``counts[name]`` is the wrapper's launch count."""
    img = ref.img
    if (psz, win) != (_build.PSZ, _build.WIN):
        raise NotImplementedError(
            f"{name}: the kernel is built for psz={_build.PSZ}, "
            f"win={_build.WIN}; got psz={psz}, win={win}")
    require(name, query_img.device == img.device,
            f"query_img is on {query_img.device}, not {img.device}")
    _check_plane(name, img, "ref.img")
    _check_plane(name, query_img, "query_img")
    require(name, query_img.shape == img.shape, "planes must be of one shape")
    _check_centers(name, img, centers)
    _check_origins(name, img, origins)
    require(name, origins.shape == centers.shape,
            "centers and origins must both be (..., 2)")
    Hp, Wp = img.shape
    require(name, Hp >= win and Wp >= win, f"plane {tuple(img.shape)} is smaller "
            f"than the {win}x{win} window")

    lead = centers.shape[:-1]
    flat_o = origins.reshape(-1, 2)
    sup, w = support_of(img, centers.reshape(-1, 2), psz, padding)
    idx = torch.cat([sup, torch.stack([clamp_to_fit(flat_o[:, 0], win, Hp),
                                       clamp_to_fit(flat_o[:, 1], win, Wp)], dim=1)],
                    dim=1).contiguous()
    M = idx.shape[0]
    p_img = torch.empty((M, psz, psz), dtype=torch.float32, device=img.device)
    p_dx = torch.empty_like(p_img)
    p_dy = torch.empty_like(p_img)
    qwin = torch.empty((M, win, win), dtype=torch.float32, device=img.device)
    if M > 0:
        lib = _build.load()
        code = getattr(lib, entry)(
            img.data_ptr(), query_img.data_ptr(), Hp, Wp, idx.data_ptr(),
            w.data_ptr(), p_img.data_ptr(), p_dx.data_ptr(), p_dy.data_ptr(),
            qwin.data_ptr(), M, padding, _build.stream_ptr(img.device))
        _build.check(lib, code, name)
        counts[name] += 1
    if patch_norm:
        p_img = patch_mean_removed(p_img)
    shp = lead + (psz, psz)
    return (p_img.reshape(shp), p_dx.reshape(shp), p_dy.reshape(shp),
            qwin.reshape(lead + (win, win)))


def gather_ref_grad_windows(ref: PyramidLevel, query_img: torch.Tensor,
                            centers: torch.Tensor, origins: torch.Tensor,
                            psz: int, padding: int, win: int,
                            patch_norm: bool = False):
    """K1: the dual gather; CPU tensors -> plain version, CUDA tensors ->
    kernel.

    ref: padded reference level (the kernel reads ``ref.img`` only and
    forms the gradient patches from it); query_img: padded query plane
    of the same shape; centers (..., 2) f32 unpadded coords; origins
    (..., 2) int32 window origins in the padded plane.
    """
    name = "gather_ref_grad_windows"
    if not on_card(name, ref.img):
        return gather_ref_grad_windows_plain(ref, query_img, centers, origins,
                                             psz, padding, win, patch_norm)
    return dual_gather(name, "icgn_gather_ref_grad_windows", launches, ref,
                       query_img, centers, origins, psz, padding, win, patch_norm)
