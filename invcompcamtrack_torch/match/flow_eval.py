"""Optical-flow endpoint-error evaluation (port of
``invcompcamtrack_tpu/match/flow_eval.py``).

The reference's magnitude-binned EPE metric over GT flow
(reference: misc_src/func_OF_util.py:18-36; Sintel-style bins
all / <10px / 10-40px / >=40px).
"""

from __future__ import annotations

import torch


def flow_epe_binned(flow_gt: torch.Tensor, flow_est: torch.Tensor,
                    valid: torch.Tensor | None = None):
    """flow_gt/flow_est: (H, W, 2).  Returns dict with keys
    'all', 's<10', 's10-40', 's>=40' (mean EPE per GT-magnitude bin)."""
    gt_mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1))
    err = torch.sqrt(torch.sum((flow_gt - flow_est) ** 2, dim=-1))
    every = torch.ones_like(gt_mag, dtype=torch.bool)
    base = every if valid is None else valid

    def bin_mean(mask):
        m = (mask & base).to(err.dtype)
        return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)

    return {
        "all": bin_mean(every),
        "s<10": bin_mean(gt_mag < 10),
        "s10-40": bin_mean((gt_mag >= 10) & (gt_mag < 40)),
        "s>=40": bin_mean(gt_mag >= 40),
    }
