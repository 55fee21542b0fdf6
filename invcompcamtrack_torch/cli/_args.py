"""The one option the port's CLIs add to the reference's argv."""

from __future__ import annotations


def split_device(argv: list[str], device):
    """Strip an optional leading ``--device NAME`` -> (argv, device).  An
    explicit ``device`` argument of ``main`` wins over the command line."""
    if len(argv) >= 2 and argv[0] == "--device":
        return argv[2:], (argv[1] if device is None else device)
    return argv, device
