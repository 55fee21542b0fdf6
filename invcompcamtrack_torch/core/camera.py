"""Multi-scale pinhole camera (port of
``invcompcamtrack_tpu/core/camera.py::CameraPyramid``).

Per-level intrinsics scale by ``2^-i``; ``swo/sho`` are the unpadded
image sizes at each level.  Every field is a float32 ``(L,)`` tensor on
the camera's device, so ``level(s)`` hands the solver 0-d tensors that
never leave the card.
"""

from __future__ import annotations

import dataclasses

import torch

from invcompcamtrack_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class CameraPyramid:
    """Per-level pinhole intrinsics; every tensor field has shape (L,)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    swo: torch.Tensor  # unpadded width at level (= 2^-i * W)
    sho: torch.Tensor  # unpadded height at level
    padding: int       # pixel padding added around every level

    @classmethod
    def create(cls, fc, cc, wh, num_levels: int, padding: int,
               device: torch.device | str | None = None) -> "CameraPyramid":
        """fc=(fx,fy), cc=(cx,cy), wh=(W,H) at full resolution; on the
        card unless ``device`` says otherwise."""
        device = resolve(device)
        scale = 0.5 ** torch.arange(num_levels, dtype=torch.float32,
                                    device=device)

        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32, device=device)

        return cls(
            fx=f32(fc[0]) * scale, fy=f32(fc[1]) * scale,
            cx=f32(cc[0]) * scale, cy=f32(cc[1]) * scale,
            swo=f32(wh[0]) * scale, sho=f32(wh[1]) * scale,
            padding=int(padding),
        )

    @property
    def num_levels(self) -> int:
        return self.fx.shape[-1]

    def level(self, s: int):
        """Level accessor -> (fx, fy, cx, cy, swo, sho) 0-d tensors."""
        return (self.fx[..., s], self.fy[..., s], self.cx[..., s],
                self.cy[..., s], self.swo[..., s], self.sho[..., s])

    def to(self, device) -> "CameraPyramid":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self) if f.name != "padding"})
