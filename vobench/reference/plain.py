"""Plain building blocks of the references, written from the definitions
that the upstream project (catree/InvCompCamTrack) and the system's own
documentation give, in any float type: SE(3) in the ``[t, w]`` form, the
image pyramid, the upstream's sub-pixel patch rule and the pinhole
camera of each pyramid level.

Nothing here is taken from the program.  Matrix products are
``torch.matmul`` or ``torch.einsum``, so that the control (``precision``)
rounds their operands to TF32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# ------------------------------------------------------------- SE(3)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> the cross-product matrices (..., 3, 3)."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(p: torch.Tensor) -> torch.Tensor:
    """p (..., 6) = [t, w] -> [R | V t] (..., 3, 4): Rodrigues' rotation
    and the left Jacobian V, with their Taylor series below 1e-4 rad."""
    t, w = p[..., :3], p[..., 3:]
    th2 = torch.sum(w * w, -1)[..., None, None]
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1 / 6 - th2 / 120, (th - torch.sin(th)) / (th * th * th))
    W = hat(w)
    W2 = torch.matmul(W, W)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    return torch.cat([R, torch.matmul(V, t[..., None])], -1)


def se3_log(G: torch.Tensor) -> torch.Tensor:
    """[R | t] (..., 3, 4) -> p (..., 6) = [V^-1 t, w]."""
    R, t = G[..., :3], G[..., 3]
    cos = torch.clamp(0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1), -1, 1)
    th = torch.arccos(cos)
    zero = th < 1e-10
    ths = torch.where(zero, torch.ones_like(th), th)
    k = torch.where(zero, torch.zeros_like(th), ths / (2 * torch.sin(ths)))
    w = k[..., None] * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                                    R[..., 1, 0] - R[..., 0, 1]], -1)
    small = th < 1e-4
    ths = torch.where(small, torch.ones_like(th), th)
    h = torch.where(small, torch.full_like(th, 1 / 12),
                    (1 - ths / (2 * torch.tan(ths / 2))) / (ths * ths))
    W = hat(w)
    eye = torch.eye(3, dtype=G.dtype, device=G.device)
    Vinv = eye - 0.5 * W + h[..., None, None] * torch.matmul(W, W)
    return torch.cat([torch.matmul(Vinv, t[..., None])[..., 0], w], -1)


def transform(G: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """x_cam = R X + t; G (..., 3, 4), X (..., N, 3) -> (..., N, 3)."""
    return torch.matmul(X, G[..., :3].transpose(-1, -2)) + G[..., None, :, 3]


def nearest_rotation(M: torch.Tensor) -> torch.Tensor:
    """The rotation nearest to M (..., 3, 3) in the Frobenius norm."""
    U, _, Vt = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(torch.matmul(U, Vt)))
    U = torch.cat([U[..., :2], U[..., 2:] * d[..., None, None]], -1)
    return torch.matmul(U, Vt)


# ------------------------------------------------------------ images


def downsample(img: torch.Tensor) -> torch.Tensor:
    """The mean of each 2x2 block; an odd last row or column is dropped."""
    H, W = img.shape[-2] // 2, img.shape[-1] // 2
    return img[..., :2 * H, :2 * W].reshape(img.shape[:-2] + (H, 2, W, 2)).mean((-3, -1))


def central_diff(img: torch.Tensor):
    """I[x+1] - I[x-1] across and down (no halving), the image mirrored
    about its edge pixels (so both differences are 0 on the edges)."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[..., :, 1:-1] = img[..., :, 2:] - img[..., :, :-2]
    dy[..., 1:-1, :] = img[..., 2:, :] - img[..., :-2, :]
    return dx, dy


def pyramid(img: torch.Tensor, levels: int, pad: int) -> list:
    """Level i is level i-1 downsampled; each level's (image, dx, dy),
    padded by ``pad``: the image by its edge pixels, the differences by
    zeros."""
    out, cur = [], img
    for i in range(levels):
        if i:
            cur = downsample(cur)
        dx, dy = central_diff(cur)
        H, W = cur.shape
        rows = torch.clamp(torch.arange(-pad, H + pad, device=img.device), 0, H - 1)
        cols = torch.clamp(torch.arange(-pad, W + pad, device=img.device), 0, W - 1)
        out.append((cur[rows][:, cols], F.pad(dx, (pad,) * 4), F.pad(dy, (pad,) * 4)))
    return out


def camera_level(cam: dict, s: int, dtype, device):
    """(fx, fy, cx, cy, W, H) of level s: every number halves per level."""
    k = 0.5 ** s
    return tuple(torch.tensor(v * k, dtype=dtype, device=device)
                 for v in (*cam["fc"], *cam["cc"], *cam["wh"]))


def project(G, X, lvl):
    """-> pixels (..., N, 2) and the camera-frame points (..., N, 3)."""
    fx, fy, cx, cy = lvl[:4]
    Xc = transform(G, X)
    return torch.stack([Xc[..., 0] / Xc[..., 2] * fx + cx,
                        Xc[..., 1] / Xc[..., 2] * fy + cy], -1), Xc


def support(uv: torch.Tensor, psz: int, pad: int):
    """The upstream's patch rule: the psz x psz patch of centre (x, y)
    samples x - psz/2 + j, y - psz/2 + i bilinearly.  -> the padded
    row and column of its (psz+1)-square support's top-left tap, taken
    from ceil(coordinate + 1e-5), and the fractions x - floor(x),
    y - floor(y)."""
    x, y = uv[..., 0], uv[..., 1]
    far = float(2 ** 30)
    c0 = torch.clamp(torch.ceil(x + 1e-5), -far, far).long() - psz // 2 - 1 + pad
    r0 = torch.clamp(torch.ceil(y + 1e-5), -far, far).long() - psz // 2 - 1 + pad
    return r0, c0, x - torch.floor(x), y - torch.floor(y)


def sample(planes, r0, c0, fx, fy, psz: int) -> list:
    """The bilinear patches (..., psz, psz) of each padded plane from the
    support's top-left taps (r0, c0), moved inside the plane where the
    support would leave it."""
    Hp, Wp = planes[0].shape
    r0 = torch.clamp(r0, 0, Hp - psz - 1)
    c0 = torch.clamp(c0, 0, Wp - psz - 1)
    k = torch.arange(psz + 1, device=r0.device)
    rows, cols = (r0[..., None] + k)[..., :, None], (c0[..., None] + k)[..., None, :]
    fx, fy = fx[..., None, None], fy[..., None, None]
    out = []
    for plane in planes:
        s = plane[rows, cols]
        out.append((1 - fy) * ((1 - fx) * s[..., :-1, :-1] + fx * s[..., :-1, 1:])
                   + fy * ((1 - fx) * s[..., 1:, :-1] + fx * s[..., 1:, 1:]))
    return out


def patches(planes, uv, psz: int, pad: int) -> list:
    """The patches of each padded plane at the centres uv (..., 2)."""
    r0, c0, fx, fy = support(uv, psz, pad)
    return sample(planes, r0, c0, fx, fy, psz)
