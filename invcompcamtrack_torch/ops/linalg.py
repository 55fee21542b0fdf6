"""Small symmetric solves and eigendecompositions, unrolled (port of
``invcompcamtrack_tpu/ops/linalg.py``).

The GN normal matrix is symmetric positive (semi-)definite, so a
Jacobi-equilibrated Cholesky with clamped pivots solves it in straight
elementwise code that batches over any leading dimensions.  The BA
landmark blocks are symmetric PSD 3x3 systems whose spectral truncation
gates depth updates (``ba/window.py``): they are decomposed in closed
form (Cardano roots and cross-product eigenvectors, every branch a
``torch.where``), not by ``torch.linalg.eigh``, whose iterative noise on
near-singular blocks, amplified by 1/lambda in the pseudo-inverse, broke
joint BA in the JAX package (``docs/parity.md`` deviation 8).  The
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


# ---------------------------------------------------------------------------
# Closed-form symmetric 3x3 eigendecomposition


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _unit(v: torch.Tensor, eps: float):
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp(n, min=eps), n[..., 0]


def _basis(like: torch.Tensor, i: int) -> torch.Tensor:
    e = torch.zeros_like(like)
    e[..., i] = 1.0
    return e


def _eigvec_from_rows(A: torch.Tensor, lam: torch.Tensor, eps: float) -> torch.Tensor:
    """Eigenvector of symmetric A for eigenvalue lam: the largest cross
    product of two rows of (A - lam I); exact for a simple root."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = A - lam[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01, c12, c20 = _cross(r0, r1), _cross(r1, r2), _cross(r2, r0)
    n01 = torch.sum(c01 * c01, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    n20 = torch.sum(c20 * c20, dim=-1)
    best = torch.where(((n01 >= n12) & (n01 >= n20))[..., None], c01,
                       torch.where((n12 >= n20)[..., None], c12, c20))
    v, n = _unit(best, eps)
    # all rows parallel (double root): a unit vector orthogonal to the
    # largest row
    rn0 = torch.sum(r0 * r0, dim=-1)
    rn1 = torch.sum(r1 * r1, dim=-1)
    rn2 = torch.sum(r2 * r2, dim=-1)
    row = torch.where(((rn0 >= rn1) & (rn0 >= rn2))[..., None], r0,
                      torch.where((rn1 >= rn2)[..., None], r1, r2))
    ex, ey = _basis(row, 0), _basis(row, 1)
    o1 = _cross(row, ex)
    o2 = _cross(row, ey)
    o = torch.where((torch.sum(o1 * o1, dim=-1) >= torch.sum(o2 * o2, dim=-1))[..., None],
                    o1, o2)
    o, _ = _unit(o, eps)
    # triple root (M ~ 0): a basis vector
    o = torch.where((torch.maximum(torch.maximum(rn0, rn1), rn2) > eps * eps)[..., None],
                    o, ex)
    return torch.where((n > eps)[..., None], v, o)


def _eigvec_mid(A: torch.Tensor, v0: torch.Tensor, lam1: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Middle eigenvector: the null vector of the 2x2 restriction of
    (A - lam1 I) to the plane orthogonal to v0 (Eberly's construction)."""
    ex, ey = _basis(v0, 0), _basis(v0, 1)
    seed = torch.where((torch.abs(v0[..., 0]) > 0.9)[..., None], ey, ex)
    U, _ = _unit(_cross(v0, seed), eps)
    W = _cross(v0, U)
    AU = torch.sum(A * U[..., None, :], dim=-1) - lam1[..., None] * U
    AW = torch.sum(A * W[..., None, :], dim=-1) - lam1[..., None] * W
    m00 = torch.sum(U * AU, dim=-1)
    m01 = torch.sum(U * AW, dim=-1)
    m11 = torch.sum(W * AW, dim=-1)
    # null vector of [[m00, m01], [m01, m11]] from the better-scaled row
    use0 = torch.abs(m00) >= torch.abs(m11)
    a = torch.where(use0, m01, m11)
    b = torch.where(use0, -m00, -m01)
    s = torch.sqrt(a * a + b * b)
    ok = s > eps
    a = torch.where(ok, a / torch.clamp(s, min=eps), torch.ones_like(a))
    b = torch.where(ok, b / torch.clamp(s, min=eps), torch.zeros_like(b))
    return a[..., None] * U + b[..., None] * W


def sym3x3_eigh(A: torch.Tensor):
    """Batched closed-form eigendecomposition of symmetric 3x3 matrices.

    Returns ``(lam, V)``: eigenvalues ascending along the last axis and
    eigenvectors in the columns of V (``A ~= V diag(lam) V^T``), the
    convention of ``torch.linalg.eigh``.
    """
    eps = torch.finfo(A.dtype).tiny ** 0.5
    A = 0.5 * (A + A.transpose(-1, -2))
    # scale to unit max-abs so the cubic's intermediates stay in range
    scale = torch.amax(torch.abs(A), dim=(-2, -1))
    s = torch.clamp(scale, min=eps)
    An = A / s[..., None, None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)

    q = (An[..., 0, 0] + An[..., 1, 1] + An[..., 2, 2]) / 3.0
    B = An - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    Bn = B / torch.clamp(p, min=eps)[..., None, None]
    b00, b01, b02 = Bn[..., 0, 0], Bn[..., 0, 1], Bn[..., 0, 2]
    b11, b12, b22 = Bn[..., 1, 1], Bn[..., 1, 2], Bn[..., 2, 2]
    half_det = 0.5 * (b00 * (b11 * b22 - b12 * b12)
                      - b01 * (b01 * b22 - b12 * b02)
                      + b02 * (b01 * b12 - b11 * b02))
    half_det = torch.clamp(half_det, -1.0, 1.0)
    phi = torch.arccos(half_det) / 3.0
    two_pi_3 = 2.0943951023931953
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + two_pi_3)
    lam_mid = 3.0 * q - lam_hi - lam_lo

    # first eigenvector from the better-separated extreme root
    hi_first = half_det >= 0
    lam_a = torch.where(hi_first, lam_hi, lam_lo)
    v_a = _eigvec_from_rows(An, lam_a, eps)
    v_mid = _eigvec_mid(An, v_a, lam_mid, eps)
    v_b = _cross(v_a, v_mid)
    # degenerate scale (A ~ 0 or isotropic): the identity basis
    iso = (p <= eps * torch.clamp(torch.abs(q), min=1.0))[..., None]
    I3 = eye.expand(An.shape)
    hf = hi_first[..., None]
    cols_hi = torch.where(iso, I3[..., 2], torch.where(hf, v_a, v_b))
    cols_mid = torch.where(iso, I3[..., 1], v_mid)
    cols_lo = torch.where(iso, I3[..., 0], torch.where(hf, v_b, v_a))
    lam = torch.stack([lam_lo, lam_mid, lam_hi], dim=-1) * s[..., None]
    V = torch.stack([cols_lo, cols_mid, cols_hi], dim=-1)
    return lam, V


def sym3x3_trunc_pinv(A: torch.Tensor, rel_floor) -> torch.Tensor:
    """Spectral-truncated pseudo-inverse of symmetric PSD 3x3 blocks:
    eigen-directions with eigenvalue below ``rel_floor * lambda_max``
    contribute zero (treated as unobserved)."""
    lam, V = sym3x3_eigh(A)
    lam_max = lam[..., 2:3]
    inv_l = torch.where(lam > rel_floor * lam_max,
                        1.0 / torch.clamp(lam, min=1e-30), torch.zeros_like(lam))
    return torch.einsum("...ij,...j,...kj->...ik", V, inv_l, V)
