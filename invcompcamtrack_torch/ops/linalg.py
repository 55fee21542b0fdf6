"""Small symmetric solves, unrolled (port of
``invcompcamtrack_tpu/ops/linalg.py::cholesky_solve_sym``).

The GN normal matrix is symmetric positive (semi-)definite, so a
Jacobi-equilibrated Cholesky with clamped pivots solves it in straight
elementwise code that batches over any leading dimensions.  The
arithmetic is the JAX module's, term for term.
"""

from __future__ import annotations

import torch


def cholesky_solve_sym(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for symmetric positive (semi-)definite H.

    H: (..., n, n); b: (..., n) with small n (unrolled).  Non-positive
    pivots are clamped to 1e-30, a tiny Tikhonov regulariser in place of
    inf/NaN.
    """
    n = H.shape[-1]
    eps = 1e-30

    # Jacobi preconditioning: equilibrate by 1/sqrt(diag) first (the GN
    # matrix mixes translation and rotation units).
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)),
                               min=eps))
    H = H / (d[..., :, None] * d[..., None, :])
    b = b / d

    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                L[i][j] = s / L[j][j]

    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]

    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]

    return torch.stack(x, dim=-1) / d
