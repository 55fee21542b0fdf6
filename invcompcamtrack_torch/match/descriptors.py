"""Keypoint descriptors + ratio-test matching (port of
``invcompcamtrack_tpu/match/descriptors.py``).

The reference localizes against an SfM model with vl_sift descriptors
and Lowe ratio matching (reference: run_ransac_test.m:58-77).  This
keeps the capability (match a query frame's keypoints against a model's
descriptor set) as a batched pipeline:

- Shi-Tomasi corners (match/features.py) for detection,
- a gradient-orientation-histogram patch descriptor ("SIFT-like"):
  4x4 spatial cells x 8 orientation bins over a 16x16 patch, computed
  for ALL keypoints at once from one (patch+2)-sided gather (K5 at psz
  18 on a CUDA tensor), L2-normalized with the 0.2 clamp + renormalize,
- brute-force cosine matching with Lowe's ratio test (the reference's
  ratio: d1/d2 < thresh, :76); the similarity product is one
  ``torch.matmul`` in full float32 (TF32 off, set by the package).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from invcompcamtrack_torch.image.patch import extract_patches


def sift_like_descriptors(img_padded: torch.Tensor, centers: torch.Tensor,
                          padding: int, patch: int = 16, cells: int = 4,
                          bins: int = 8) -> torch.Tensor:
    """(N, cells*cells*bins) descriptors at sub-pixel centers.

    img_padded: replicate-padded image (image/pyramid conventions).
    """
    half = patch // 2
    # sample a (patch+2) window so gradients stay inside
    p = extract_patches(img_padded, centers, patch + 2, padding)
    dx = (p[..., 1:-1, 2:] - p[..., 1:-1, :-2]) * 0.5
    dy = (p[..., 2:, 1:-1] - p[..., :-2, 1:-1]) * 0.5
    mag = torch.sqrt(dx * dx + dy * dy + 1e-12)
    ang = torch.atan2(dy, dx)  # [-pi, pi]

    # soft orientation binning
    binpos = (ang + math.pi) / (2 * math.pi) * bins  # [0, bins]
    b0 = torch.floor(binpos)
    frac = binpos - b0
    b0 = b0.long() % bins
    b1 = (b0 + 1) % bins
    onehot0 = F.one_hot(b0, bins).to(mag.dtype) * (1 - frac)[..., None]
    onehot1 = F.one_hot(b1, bins).to(mag.dtype) * frac[..., None]
    votes = (onehot0 + onehot1) * mag[..., None]  # (N, P, P, bins)

    # gaussian spatial weighting (SIFT-style)
    yy = torch.arange(patch, device=p.device) - half + 0.5
    g = torch.exp(-(yy[:, None] ** 2 + yy[None, :] ** 2) / (2 * (half ** 2)))
    votes = votes * g.to(mag.dtype)[None, :, :, None]

    # pool into cells x cells spatial histogram
    cs = patch // cells
    N = votes.shape[0]
    votes = votes.reshape(N, cells, cs, cells, cs, bins)
    desc = votes.sum(dim=(2, 4)).reshape(N, cells * cells * bins)

    # normalize, clamp 0.2, renormalize (Lowe)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-12)
    desc = torch.clamp(desc, max=0.2)
    return desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-12)


def ratio_match(desc_query: torch.Tensor, desc_model: torch.Tensor,
                ratio: float = 0.8):
    """Brute-force nearest-neighbor matching with Lowe's ratio test.

    Returns (indices (Nq,), valid (Nq,)): index of the best model match
    per query, valid where d_best/d_second < ratio (L2 on unit vectors).
    One matrix product does all pairwise similarities.
    """
    sim = torch.matmul(desc_query, desc_model.T)  # cosine
    # L2^2 on unit vectors = 2 - 2 sim -> ranking by sim descending
    top2, idx2 = torch.topk(sim, 2, dim=1)
    d1 = torch.sqrt(torch.clamp(2.0 - 2.0 * top2[:, 0], min=0.0))
    d2 = torch.sqrt(torch.clamp(2.0 - 2.0 * top2[:, 1], min=1e-12))
    valid = d1 / d2 < ratio
    return idx2[:, 0], valid
