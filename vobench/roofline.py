"""The card's published peaks and each kernel's least time, from the
shapes of its call: every input byte read once, every output byte written
once, float32 operations at the float32 rate outside the tensor cores
(``chip_smoke.py::bound`` and PERF.md's "bytes once" counts, frozen)."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit: memory rate and the
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def least_s(bytes_moved: float, flops: float) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the float32 rate, in seconds."""
    return max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def level_dims(wh, level: int, padding: int):
    """(Hp, Wp) of a padded pyramid level (each level halves, dropping an
    odd trailing row or column)."""
    W, H = int(wh[0]), int(wh[1])
    for _ in range(level):
        W, H = W // 2, H // 2
    return H + 2 * padding, W + 2 * padding


def k1(M: int, Hp: int, Wp: int, psz: int = 8, win: int = 16) -> float:
    """K1, the dual gather of M points on one padded level: both planes
    read, centres and origins read, three patches and a window written."""
    npx = psz * psz
    return least_s(2 * Hp * Wp * 4 + M * 16 + M * (3 * npx + win * win) * 4,
                   M * (3 * npx * 7 + 2 * (psz + 1) ** 2))


def k2(M: int, psz: int = 8, win: int = 16) -> float:
    """K2, one GN iteration of M points: window and three patches read,
    offsets, weights and the valid flag read, two sums written."""
    npx = psz * psz
    return least_s(M * (win * win + 3 * npx) * 4 + M * 28 + M * 8, M * npx * 13)


def share_pct(least_total_s: float, measured_s: float) -> float:
    """The kernel's share of its roofline, in %."""
    return 100.0 * least_total_s / measured_s
