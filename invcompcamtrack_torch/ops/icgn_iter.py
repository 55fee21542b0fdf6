"""K2 and K3: the fused GN-iteration body (port of
``invcompcamtrack_tpu/ops/icgn_iter_pallas.py``).

Per point: resample the ``(psz, psz)`` query patch from its cached
window at offset ``(row_w, col_w)`` with 4 taps, optionally remove its
mean, form the masked residual ``pdiff = (ref - patch) * valid``, and
(K2) project it onto the gradient patches, ``(gx, gy)``, or (K3) return
``pdiff``.  The 6-vector ``rhs = jx gx + jy gy`` stays with the caller.

Layouts are plain: windows (M, win*win), ref / p_dx / p_dy (M, psz*psz),
stored float32 or bfloat16 (``ICGNParams.bf16_gather``); offsets (M,)
int32, weights (M, 4) float32, valid (M,) float32.  Arithmetic is
float32.  CUDA tensors launch ``csrc/icgn_iter.cu``; CPU tensors take
the plain versions below.
"""

from __future__ import annotations

import torch

from invcompcamtrack_torch.ops import _build
from invcompcamtrack_torch.ops._build import PSZ, WIN
from invcompcamtrack_torch.ops.window_sample import resample_windows

# kernel launches since the counts were last set to 0
launches = {"project": 0, "pdiff": 0}


def fused_resample_pdiff_plain(qwin, ref, row_w, col_w, wts, valid,
                               patch_norm: bool = False) -> torch.Tensor:
    """-> the masked error image (M, psz*psz) float32."""
    M = qwin.shape[0]
    q = resample_windows(qwin.float().reshape(M, WIN, WIN), row_w, col_w,
                         wts, PSZ).reshape(M, PSZ * PSZ)
    if patch_norm:
        q = q - torch.mean(q, dim=-1, keepdim=True)
    return (ref.float() - q) * valid[:, None]


def fused_resample_project_plain(qwin, ref, pdx, pdy, row_w, col_w, wts, valid,
                                 patch_norm: bool = False) -> torch.Tensor:
    """-> (M, 2) = (sum p_dx * pdiff, sum p_dy * pdiff)."""
    d = fused_resample_pdiff_plain(qwin, ref, row_w, col_w, wts, valid,
                                   patch_norm)
    return torch.stack([torch.sum(pdx.float() * d, dim=-1),
                        torch.sum(pdy.float() * d, dim=-1)], dim=-1)


def _check_inputs(name, qwin, planes, row_w, col_w, wts, valid) -> bool:
    """Validate kernel inputs; returns True for bfloat16 storage."""
    dev = qwin.device
    M = qwin.shape[0]
    store = qwin.dtype
    if store not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: planes must be float32 or bfloat16, got {store}")
    expect = [("qwin", qwin, (M, WIN * WIN), store)]
    expect += [(f"plane{k}", p, (M, PSZ * PSZ), store) for k, p in enumerate(planes)]
    expect += [("row_w", row_w, (M,), torch.int32), ("col_w", col_w, (M,), torch.int32),
               ("wts", wts, (M, 4), torch.float32), ("valid", valid, (M,), torch.float32)]
    for arg, t, shape, dtype in expect:
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return store == torch.bfloat16


def _kernel_device(name: str, qwin: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA; raises else."""
    if qwin.device.type == "cpu":
        return False
    if qwin.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {qwin.device}")
    return True


def fused_resample_project(qwin, ref, pdx, pdy, row_w, col_w, wts, valid,
                           patch_norm: bool = False) -> torch.Tensor:
    """K2: one GN-iteration inner body over M points -> (M, 2) float32."""
    if not _kernel_device("fused_resample_project", qwin):
        return fused_resample_project_plain(qwin, ref, pdx, pdy, row_w, col_w,
                                            wts, valid, patch_norm)
    bf16 = _check_inputs("fused_resample_project", qwin, (ref, pdx, pdy),
                         row_w, col_w, wts, valid)
    M = qwin.shape[0]
    out = torch.empty((M, 2), dtype=torch.float32, device=qwin.device)
    if M > 0:
        lib = _build.load()
        code = lib.icgn_resample_project(
            qwin.data_ptr(), ref.data_ptr(), pdx.data_ptr(), pdy.data_ptr(),
            row_w.data_ptr(), col_w.data_ptr(), wts.data_ptr(), valid.data_ptr(),
            out.data_ptr(), M, int(patch_norm), int(bf16),
            _build.stream_ptr(qwin.device))
        _build.check(lib, code, "fused_resample_project")
        launches["project"] += 1
    return out


def fused_resample_pdiff(qwin, ref, row_w, col_w, wts, valid,
                         patch_norm: bool = False) -> torch.Tensor:
    """K3: K2 without the projection -> the error image (M, 64) float32."""
    if not _kernel_device("fused_resample_pdiff", qwin):
        return fused_resample_pdiff_plain(qwin, ref, row_w, col_w, wts, valid,
                                          patch_norm)
    bf16 = _check_inputs("fused_resample_pdiff", qwin, (ref,), row_w, col_w,
                         wts, valid)
    M = qwin.shape[0]
    out = torch.empty((M, PSZ * PSZ), dtype=torch.float32, device=qwin.device)
    if M > 0:
        lib = _build.load()
        code = lib.icgn_resample_pdiff(
            qwin.data_ptr(), ref.data_ptr(), row_w.data_ptr(), col_w.data_ptr(),
            wts.data_ptr(), valid.data_ptr(), out.data_ptr(), M,
            int(patch_norm), int(bf16), _build.stream_ptr(qwin.device))
        _build.check(lib, code, "fused_resample_pdiff")
        launches["pdiff"] += 1
    return out
