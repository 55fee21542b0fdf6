"""Patch correlation: direct NCC, FFT NCC surfaces, MOSSE filters (port
of ``invcompcamtrack_tpu/match/ncc.py``).

Behavioral specs:

- unit-norm NCC with a 1e-15 norm floor and zero clamp
  (reference: func_OF_util.py:115-122, run_track_nposes.cpp:317-324),
- the forward/backward track-quality score weighting correlations by the
  squared frame counts (reference: run_track_nposes.cpp:281-352),
- FFT correlation surface ``fftshift(Re ifft2(Fq conj(Ft)))`` clamped at
  zero and averaged over channels (reference: run_OF_NCC_VOT_test.py:63-74),
- MOSSE: ``H* = G conj(F) / (F conj(F) + beta)``
  (reference: run_OF_NCC_VOT_test.py:108-135, Bolme et al. CVPR 2010),
- cosine window + 2D gaussian helpers (reference: func_OF_util.py:169-187).

Everything is batched over leading dims; the FFTs are ``torch.fft``.
``ncc_score`` of three mean-removed patches per point is what the fused
scorer K4 (``ops/ncc3.py``) computes on the card.
"""

from __future__ import annotations

import math

import torch

NORM_FLOOR = 1e-15


def _unit(p: torch.Tensor) -> torch.Tensor:
    flat = p.reshape(p.shape[:-2] + (-1,))
    norm = torch.linalg.vector_norm(flat, dim=-1, keepdim=True)
    return flat / torch.clamp(norm, min=NORM_FLOOR)


def ncc_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max(0, <a/|a|, b/|b|>) over the last two (patch) dims."""
    return torch.clamp(torch.sum(_unit(a) * _unit(b), dim=-1), min=0.0)


def patch_correlation_score(patch_back, patch_ref, patch_fwd,
                            valid_back, valid_ref, valid_fwd,
                            fb_frames) -> torch.Tensor:
    """Forward/backward odometry-verification score per point
    (reference: run_track_nposes.cpp:281-352).

    corr = max(0, (corr_br * fb0^2 + corr_rf * fb1^2) / (fb0^2 + fb1^2))
    with weights zeroed for invalid back/fwd patches, and -1 when the
    reference patch itself is invalid.
    """
    corr_br = ncc_score(patch_back, patch_ref)
    corr_rf = ncc_score(patch_ref, patch_fwd)
    return patch_correlation_combine(corr_br, corr_rf, valid_back,
                                     valid_ref, valid_fwd, fb_frames)


def patch_correlation_combine(corr_br, corr_rf, valid_back, valid_ref,
                              valid_fwd, fb_frames) -> torch.Tensor:
    """fb^2-weighted combination of precomputed pair correlations: the
    tail of ``patch_correlation_score``, shared with the fused scorer
    (``ops/ncc3.py``)."""
    fb0, fb1 = fb_frames
    dt = corr_br.dtype
    w0 = valid_back.to(dt) * float(fb0 * fb0)
    w1 = valid_fwd.to(dt) * float(fb1 * fb1)
    denom = torch.clamp(w0 + w1, min=NORM_FLOOR)
    corr = torch.clamp((corr_br * w0 + corr_rf * w1) / denom, min=0.0)
    return torch.where(valid_ref, corr, torch.full_like(corr, -1.0))


def ncc_surface_fft(template: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Dense correlation surface between same-size patches.

    template/query: (..., C, P, P) -> (..., P, P);
    = mean_C max(0, fftshift(Re ifft2(Fq conj(Ft)))).
    """
    ft = torch.fft.fft2(template)
    fq = torch.fft.fft2(query)
    res = torch.fft.ifft2(fq * torch.conj(ft))
    res = torch.clamp(torch.fft.fftshift(res, dim=(-2, -1)).real, min=0.0)
    return torch.mean(res, dim=-3)


def gauss2d(psz: int, sigma: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized 2D gaussian (reference: func_OF_util.py:177-187)."""
    m = math.ceil((psz - 1) / 2.0)
    y = torch.arange(psz, dtype=dtype, device=device) - m
    h = torch.exp(-(y[:, None] ** 2 + y[None, :] ** 2) / (2.0 * sigma * sigma))
    h = torch.where(h < torch.finfo(dtype).eps * h.max(), torch.zeros_like(h), h)
    return h / torch.sum(h)


def cosine_window(psz: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Radial cosine taper (reference: func_OF_util.py:169-175)."""
    cent = psz // 2
    xi = torch.arange(psz, dtype=dtype, device=device)
    r = torch.sqrt(
        ((xi[:, None] - cent + 0.5) ** 2 + (xi[None, :] - cent + 0.5) ** 2)
        / float(cent * cent))
    return torch.cos(torch.clamp(r, max=1.0) * math.pi / 2.0)


def mosse_filter(template: torch.Tensor, gsigma: float, beta: float = 0.1) -> torch.Tensor:
    """Learn a MOSSE filter in the Fourier domain from one (or a batch of)
    template patch(es): H* = G conj(F) / (F conj(F) + beta)
    (reference: run_OF_NCC_VOT_test.py:112-120).  Returns complex (..., P, P).
    """
    psz = template.shape[-1]
    g_fft = torch.fft.fft2(gauss2d(psz, gsigma, dtype=template.dtype,
                                   device=template.device))
    f = torch.fft.fft2(template)
    return (g_fft * torch.conj(f)) / (f * torch.conj(f) + beta)


def mosse_response(h_fft: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Apply a learned MOSSE filter: mean_C max(0, Re ifft2(Fq H)).
    query: (..., C, P, P); h_fft: (..., C, P, P)."""
    fq = torch.fft.fft2(query)
    res = torch.clamp(torch.fft.ifft2(fq * h_fft).real, min=0.0)
    return torch.mean(res, dim=-3)


def peak_subpixel(surface: torch.Tensor):
    """argmax of a correlation surface with quadratic sub-pixel fit.

    surface: (..., P, P) -> (offset_xy (..., 2), peak value (...,)).
    Offsets are relative to the surface center (fftshift convention).
    """
    P = surface.shape[-1]
    flat = surface.reshape(surface.shape[:-2] + (-1,))
    idx = torch.argmax(flat, dim=-1)
    py, px = idx // P, idx % P
    val = torch.gather(flat, -1, idx[..., None])[..., 0]

    def grab(dy, dx):
        yy = torch.clamp(py + dy, 0, P - 1)
        xx = torch.clamp(px + dx, 0, P - 1)
        return torch.gather(flat, -1, (yy * P + xx)[..., None])[..., 0]

    # 1D parabola fits in x and y
    cx0, cx2 = grab(0, -1), grab(0, 1)
    cy0, cy2 = grab(-1, 0), grab(1, 0)
    denx = cx0 - 2 * val + cx2
    deny = cy0 - 2 * val + cy2
    zero = torch.zeros_like(val)
    dx = torch.where(torch.abs(denx) > 1e-12, 0.5 * (cx0 - cx2) / denx, zero)
    dy = torch.where(torch.abs(deny) > 1e-12, 0.5 * (cy0 - cy2) / deny, zero)
    off = torch.stack([px + dx - P // 2, py + dy - P // 2], dim=-1)
    return off, val
