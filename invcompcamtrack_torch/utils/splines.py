"""Smoothing splines + integration utilities.

Semantics pinned to the reference's behavior (parity targets):

- ``smoothing_spline`` applies the Reinsch-form natural-cubic smoother
  with the reference's (unconventional) smoother matrix
  ``LL = (I + (1/p) K - K)^{-1}`` (behavioral spec:
  func_util_geom.py:293-327),
- the batched variant smooths overlapping blocks and keeps each block's
  interior, handing half the overlap to each neighbor (spec: :189-222),
- ``smoothing_spline_crossval_p`` picks the smoothing parameter by
  Monte-Carlo leave-out residuals on a grid that zooms around the
  argmin (spec: :225-290),
- spline double integration for accelerometer -> displacement
  (spec: run_csv_parse.py:181-188) via scipy antiderivatives.

Implementation is original: the second-difference operator and the
Gram matrix are assembled as whole diagonals (no index loops), and the
block stitcher is a single uniform trimmed write per block.

The port's own copy of ``invcompcamtrack_tpu/utils/splines.py``: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy import interpolate as scpint


def _reinsch_operators(x: np.ndarray):
    """Second-difference matrix D (n-2, n) and Gram matrix W (n-2, n-2)
    of the natural cubic spline penalty, built diagonal-wise."""
    h = np.diff(x)
    ih = 1.0 / h
    n = x.shape[0]
    m = n - 2
    D = np.zeros((m, n))
    r = np.arange(m)
    D[r, r] = ih[:-1]
    D[r, r + 1] = -(ih[:-1] + ih[1:])
    D[r, r + 2] = ih[1:]
    W = (
        np.diag((h[:-1] + h[1:]) / 3.0)
        + np.diag(h[1:-1] / 6.0, 1)
        + np.diag(h[1:-1] / 6.0, -1)
    )
    return D, W


def smoothing_spline(x: np.ndarray, y: np.ndarray, p: float):
    """x: (n,) strictly increasing; y: (n, d).  Returns (yhat, LL, p).

    LL is the smoother matrix; yhat = LL @ y.  The p-weighting keeps the
    reference's exact (nonstandard) form ``I + (1/p - 1) K``.
    """
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    D, W = _reinsch_operators(x)
    K = D.T @ np.linalg.solve(W, D)
    LL = np.linalg.inv(np.eye(x.shape[0]) + (1.0 / p - 1.0) * K)
    return LL @ y, LL, p


def smoothing_spline_batch(x, y, p, batchsize: int = 2000, overlap: float = 0.49):
    """Block-wise smoothing for long signals.

    Blocks of ``batchsize`` samples advance by ``batchsize - noverlap``;
    each block contributes its interior, trimming floor(noverlap/2)
    samples at a leading edge and ceil(noverlap/2) at a trailing edge —
    except at the signal boundaries, where nothing is trimmed.
    """
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    n = x.shape[0]
    batchsize = min(batchsize, n)
    noverlap = int(batchsize * overlap)
    stride = batchsize - noverlap
    starts = np.arange(0, n - noverlap, stride)
    trim_lead = noverlap // 2
    trim_trail = noverlap - trim_lead  # == ceil(noverlap / 2)

    out = np.zeros_like(y)
    for b, s in enumerate(starts):
        e = min(s + batchsize, n)
        yhat, _, p = smoothing_spline(x[s:e], y[s:e], p)
        lo = 0 if b == 0 else trim_lead
        hi = 0 if b == len(starts) - 1 else trim_trail
        out[s + lo: e - hi] = yhat[lo: (e - s) - hi]
    return out


def smoothing_spline_crossval_p(x, y, crossval_frac: float = 0.1,
                                rounds: int = 50, depth_iters: int = 4,
                                tree_spread: int = 5,
                                rng: np.random.Generator | None = None) -> float:
    """Monte-Carlo cross-validated smoothing parameter.

    Repeatedly holds out ``crossval_frac`` of the samples, smooths the
    rest, and scores the held-out prediction error; the candidate grid
    of ``tree_spread`` values zooms ``depth_iters`` times onto the
    neighborhood of the best candidate.
    """
    rng = rng or np.random.default_rng(0)
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    n = y.shape[0]
    n_out = max(1, int(np.ceil(n * crossval_frac)))

    def heldout_error(p: float) -> float:
        total = 0.0
        for _ in range(rounds):
            held = rng.choice(n, n_out, replace=False)
            kept = np.setdiff1d(np.arange(n), held)
            yhat, _, _ = smoothing_spline(x[kept], y[kept], p)
            pred = np.column_stack([
                np.interp(x[held], x[kept], yhat[:, k])
                for k in range(y.shape[1])
            ])
            total += np.mean(np.sum((pred - y[held]) ** 2, axis=1))
        return total / rounds

    grid = np.linspace(1e-10, 1.0, tree_spread)
    for _ in range(depth_iters + 1):
        errs = [heldout_error(p) for p in grid]
        i = int(np.argmin(errs))
        best = grid[i]
        grid = np.linspace(grid[max(0, i - 1)],
                           grid[min(len(grid) - 1, i + 1)], tree_spread)
    return float(best)


def double_integrate(t: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Acceleration (T, d) -> displacement (T, d) via exact cubic-spline
    double antiderivatives (spec: run_csv_parse.py:181-188)."""
    t = np.asarray(t, float)
    a = np.asarray(a, float)
    cols = []
    for k in range(a.shape[1]):
        tck = scpint.splantider(scpint.splrep(t, a[:, k], s=0.0), 2)
        cols.append(scpint.splev(t, tck))
    return np.stack(cols, axis=1)
