"""The device the port's entry points run on.

Constructors and entry points (``CameraPyramid.create``, ``convert.*``,
the CLIs) take ``device=None`` and resolve it here: the card, or an
error.  Nothing falls back to the CPU; a caller that wants the CPU (the
tests, a comparison run) passes ``"cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``torch.device("cuda")``; raises where there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "invcompcamtrack_torch runs on an NVIDIA card by default, and "
            "torch.cuda.is_available() is False: no CUDA device (or a torch "
            "built without CUDA).  Pass device='cpu' to run on the CPU.")
    return torch.device("cuda")


def resolve(device: torch.device | str | None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> torch.device."""
    return default_device() if device is None else torch.device(device)
