"""Convolutional feature extraction for patch matching (port of
``invcompcamtrack_tpu/vo/features_dnn.py``).

The reference dumps VGG19 conv activations as an alternative patch
descriptor for its NCC matching experiments (reference:
misc_src/run_test_get_DNNconv_representation.py).  Here, as in the JAX
module, a small VGG-style extractor:

- ``VGGFeatures``: stacked 3x3-conv/ReLU blocks with a 2x2 max-pool
  between stages, returning one map per stage (NCHW: each ``(C_s, H_s,
  W_s)``; the JAX module's are ``(H_s, W_s, C_s)``),
- random weights by default, drawn from an explicit ``torch.Generator``
  as flax's default ``init`` draws them (truncated-normal LeCun kernels,
  zero biases), or carried from the flax parameters by
  ``convert.features_params_from_numpy``,
- ``feature_patch_descriptors`` samples every channel's patches with K5
  (``ops/patch_gather.py::gather_patches``) in ONE launch on the stack of
  the C padded maps, where the JAX module gathers the channels one by one.

The convolutions are ``F.conv2d`` (XLA convolutions in the JAX module,
not Pallas kernels), with TF32 off.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from invcompcamtrack_torch.device import resolve
from invcompcamtrack_torch.ops import patch_gather

# flax's lecun_normal: a normal truncated at two standard deviations,
# scaled so that the truncated draw has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class VGGFeatures(nn.Module):
    """VGG-style truncated feature extractor.

    stage_channels: channels per stage (VGG19's first stages are (64, 128,
    256)); ``convs_per_stage`` 3x3 convs in each; ``in_channels`` of the
    image (1: grayscale).  ``forward`` returns the list of per-stage
    feature maps, each at half the previous stage's resolution.
    Convolutions are named ``conv{s}_{c}``, as the flax module's.
    """

    def __init__(self, stage_channels: Sequence[int] = (32, 64, 128),
                 convs_per_stage: int = 2, in_channels: int = 1):
        super().__init__()
        self.stage_channels = tuple(stage_channels)
        self.convs_per_stage = convs_per_stage
        cin = in_channels
        for s, ch in enumerate(self.stage_channels):
            for c in range(convs_per_stage):
                self.add_module(f"conv{s}_{c}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x: torch.Tensor):
        """x: (H, W) or (C, H, W) image, float -> [(C_s, H_s, W_s), ...]."""
        if x.dim() == 2:
            x = x[None]
        x = x[None]  # batch of 1
        outs = []
        for s in range(len(self.stage_channels)):
            for c in range(self.convs_per_stage):
                x = F.relu(getattr(self, f"conv{s}_{c}")(x))
            outs.append(x[0])
            x = F.max_pool2d(x, 2, 2)
        return outs


def init_features(generator: torch.Generator | None = None, device=None,
                  **kwargs) -> VGGFeatures:
    """The extractor with random weights from ``generator`` (a CPU
    generator, seeded with 0 when None, so that every device gets the
    same weights), on the card unless ``device`` says otherwise."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    mod = VGGFeatures(**kwargs)
    with torch.no_grad():
        for conv in mod.children():
            fan_in = conv.in_channels * 9
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            conv.bias.zero_()
    return mod.to(resolve(device))


def extract_feature_maps(mod: VGGFeatures, img: torch.Tensor):
    """img: (H, W) -> list of (C_s, H_s, W_s) feature maps."""
    with torch.no_grad():
        return mod(img)


def feature_patch_descriptors(feat: torch.Tensor, centers: torch.Tensor,
                              psz: int = 8) -> torch.Tensor:
    """Sample (N, psz, psz, C) descriptor patches from a feature map
    ``feat`` (C, H, W) at sub-pixel centres (N, 2) (feature-space NCC
    matching, the reference's NCC-on-conv-features experiment).

    The C maps are edge-padded by psz into one (C, Hp, Wp) stack and the
    centres repeated per plane (C, N, 2): one K5 launch on a CUDA tensor
    (point m on plane m // N), the plain version on a CPU tensor; equal,
    bit for bit, to C one-plane gathers.
    """
    C, N = feat.shape[0], centers.shape[0]
    pad = psz
    planes = F.pad(feat[None], (pad, pad, pad, pad), mode="replicate")[0].contiguous()
    stacked = centers.expand((C, N, 2)).contiguous()
    patches = patch_gather.gather_patches(planes, stacked, psz, pad)  # (C, N, psz, psz)
    return patches.permute(1, 2, 3, 0)
