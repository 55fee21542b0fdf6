"""The plain reference of the point tracker, and the readings that hold
the program's pairs to it.

Written from the definitions of the upstream's point tracker
(run_OF_point_track, misc_src/classoftrack.py) as the system documents
them, in float64, from the harness's host frames:

- the pyramid: each level the 2x2 mean of the one below;
- the dense flow, coarse to fine: the coarsest level starts from the
  whole-image shift at the peak of the two images' cross-correlation,
  each finer one from the coarser flow doubled and resized bilinearly
  (half-pixel centres, edges clamped); per level ``iters`` Lucas-Kanade
  steps: the second image warped by the flow (bilinear, edges clamped),
  the structure tensor and the mismatch summed over a (2r+1)^2 box of
  zeros beyond the image, the 2x2 solve where its determinant passes
  1e-4;
- the corners: the smaller eigenvalue of the 3x3 mean of the gradients'
  products, 8 pixels of border left out, local maxima over an 11x11
  box, at least 0.001 of the largest, the best of each tile of
  round(sqrt(H W / 4K)) pixels, the K best tiles in descending order;
- the track table: each live track carried by the forward flow and back
  by the backward flow (bilinear in the flow field, both neighbours
  inside it), kept while the round trip misses by under 1 pixel and
  under 0.2 of the step; the k-th free slot seeded with the k-th corner;
  a pair is a track alive across the step.

The control is this reference in float32 with TF32 products
(``precision``): the box sums and the flow's resizing."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vobench.reference import plain
from vobench.reference.precision import matmul_precision

MIN_DET = 1e-4
QUALITY = 0.001
MIN_DISTANCE = 5


def box(x: torch.Tensor, r: int) -> torch.Tensor:
    """The sum over each pixel's (2r+1)^2 box, zeros beyond the image."""
    k = torch.ones((1, 1, 2 * r + 1, 2 * r + 1), dtype=x.dtype, device=x.device)
    return F.conv2d(x[None, None], k, padding=r)[0, 0]


def resize_matrix(n_out: int, n_in: int, dtype, device) -> torch.Tensor:
    """Linear interpolation at half-pixel centres, edges clamped, as an
    (n_out, n_in) matrix."""
    src = torch.clamp((torch.arange(n_out, dtype=dtype, device=device) + 0.5)
                      * (n_in / n_out) - 0.5, min=0)
    i0 = torch.clamp(torch.floor(src).long(), max=n_in - 1)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    f = src - i0.to(dtype)
    M = torch.zeros((n_out, n_in), dtype=dtype, device=device)
    rows = torch.arange(n_out, device=device)
    M.index_put_((rows, i0), 1 - f, accumulate=True)
    M.index_put_((rows, i1), f, accumulate=True)
    return M


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(x) = img(x + flow(x)), bilinear, the position clamped to the
    image."""
    H, W = img.shape
    yy, xx = torch.meshgrid(torch.arange(H, dtype=img.dtype, device=img.device),
                            torch.arange(W, dtype=img.dtype, device=img.device), indexing="ij")
    sx = torch.clamp(xx + flow[..., 0], 0, W - 1)
    sy = torch.clamp(yy + flow[..., 1], 0, H - 1)
    x0 = torch.clamp(torch.floor(sx), max=W - 2)
    y0 = torch.clamp(torch.floor(sy), max=H - 2)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))


def shift(I0: torch.Tensor, I1: torch.Tensor) -> torch.Tensor:
    """The whole-pixel (dx, dy) at the peak of the cross-correlation of
    the mean-removed images: I1(x) ~ I0(x - d)."""
    H, W = I0.shape
    f0, f1 = torch.fft.fft2(I0 - I0.mean()), torch.fft.fft2(I1 - I1.mean())
    xc = torch.fft.ifft2(f1 * torch.conj(f0))
    k = int(torch.argmax(torch.fft.fftshift(xc.real)))
    return torch.tensor([k % W - W // 2, k // W - H // 2], dtype=I0.dtype, device=I0.device)


def dense_flow(pa: list, pb: list, iters: int, r: int) -> torch.Tensor:
    """Flow (H, W, 2) from pyramid a's image to pyramid b's."""
    flow = None
    for I0, I1 in zip(reversed(pa), reversed(pb)):
        H, W = I0.shape
        if flow is None:
            flow = shift(I0, I1).expand(H, W, 2)
        else:
            My = resize_matrix(H, flow.shape[0], I0.dtype, I0.device)
            Mx = resize_matrix(W, flow.shape[1], I0.dtype, I0.device)
            flow = 2 * torch.stack([torch.matmul(torch.matmul(My, flow[..., c]), Mx.T)
                                    for c in range(2)], -1)
        gx, gy = plain.central_diff(I0)
        gx, gy = 0.5 * gx, 0.5 * gy
        a11, a12, a22 = box(gx * gx, r), box(gx * gy, r), box(gy * gy, r)
        det = a11 * a22 - a12 * a12
        good = det > MIN_DET
        det = torch.where(good, det, torch.ones_like(det))
        for _ in range(iters):
            It = warp(I1, flow) - I0
            b1, b2 = box(gx * It, r), box(gy * It, r)
            step = torch.stack([a22 * b1 - a12 * b2, a11 * b2 - a12 * b1], -1) / det[..., None]
            flow = flow - torch.where(good[..., None], step, torch.zeros_like(step))
    return flow


def corners(img: torch.Tensor, K: int, border: int):
    """-> xy (K, 2) and valid (K,): the tiles' best corners, best first."""
    H, W = img.shape
    gx, gy = plain.central_diff(img)
    sxx, sxy, syy = (box(a, 1) / 9 for a in (gx * gx, gx * gy, gy * gy))
    resp = 0.5 * (sxx + syy) - torch.sqrt(torch.clamp(0.25 * (sxx - syy) ** 2 + sxy * sxy, min=0))
    inner = torch.zeros_like(resp, dtype=torch.bool)
    inner[border:H - border, border:W - border] = True
    resp = torch.where(inner, resp, torch.full_like(resp, -np.inf))
    peak = resp >= F.max_pool2d(resp[None, None], 2 * MIN_DISTANCE + 1, stride=1,
                                padding=MIN_DISTANCE)[0, 0]
    score = torch.where(peak & (resp >= QUALITY * resp.max()), resp,
                        torch.full_like(resp, -np.inf))
    if H * W <= 64 * K:
        vals, flat = torch.topk(score.flatten(), K)
    else:
        t = max(8, int(round((H * W / (4.0 * K)) ** 0.5)))
        nty, ntx = -(-H // t), -(-W // t)
        padded = torch.full((nty * t, ntx * t), -np.inf, dtype=img.dtype, device=img.device)
        padded[:H, :W] = score
        tiles = padded.reshape(nty, t, ntx, t).permute(0, 2, 1, 3).reshape(nty * ntx, t * t)
        best, arg = tiles.max(-1)
        ty = torch.arange(nty * ntx, device=img.device) // ntx
        tx = torch.arange(nty * ntx, device=img.device) % ntx
        flat = (ty * t + arg // t) * W + tx * t + arg % t
        k = min(K, nty * ntx)
        vals, sel = torch.topk(best, k)
        flat = flat[sel]
        if k < K:
            vals = torch.cat([vals, torch.full((K - k,), -np.inf, dtype=vals.dtype,
                                               device=vals.device)])
            flat = torch.cat([flat, torch.zeros(K - k, dtype=flat.dtype, device=flat.device)])
    xy = torch.stack([flat % W, flat // W], -1).to(img.dtype)
    return xy, torch.isfinite(vals)


def carry(xy: torch.Tensor, flow: torch.Tensor):
    """Points (C, 2) moved by the flow at them, bilinear in the field;
    valid where both neighbours of each coordinate are inside it."""
    H, W = flow.shape[:2]
    ok = torch.isfinite(xy).all(-1)
    safe = torch.where(ok[:, None], xy, torch.zeros_like(xy))
    x0, y0 = torch.floor(safe[:, 0]), torch.floor(safe[:, 1])
    ok = ok & (x0 >= 0) & (x0 + 1 < W) & (y0 >= 0) & (y0 + 1 < H)
    fx, fy = safe[:, 0] - x0, safe[:, 1] - y0
    xi = torch.clamp(x0.long(), 0, W - 2)
    yi = torch.clamp(y0.long(), 0, H - 2)
    fx, fy = fx[:, None], fy[:, None]
    d = ((1 - fy) * ((1 - fx) * flow[yi, xi] + fx * flow[yi, xi + 1])
         + fy * ((1 - fx) * flow[yi + 1, xi] + fx * flow[yi + 1, xi + 1]))
    return torch.where(ok[:, None], xy + d, torch.full_like(xy, np.nan)), ok


class Tracker:
    """The reference's loop over frame pairs, from an empty track table
    of ``corners`` slots."""

    def __init__(self, pt: dict, device, tf32: bool = False):
        self.pt, self.device, self.tf32 = pt, device, tf32
        self.dt = torch.float32 if tf32 else torch.float64
        C = pt["corners"]
        nan = torch.full((C, 2), np.nan, dtype=self.dt, device=device)
        self.cur, self.prev, self.birth = nan, nan.clone(), nan.clone()
        self.alive = torch.zeros(C, dtype=torch.bool, device=device)
        self.age = torch.zeros(C, dtype=torch.long, device=device)
        self.move = torch.zeros(C, dtype=self.dt, device=device)

    def pyramid(self, frame) -> list:
        out = [torch.from_numpy(frame).to(device=self.device, dtype=self.dt)]
        for _ in range(1, self.pt["levels"]):
            out.append(plain.downsample(out[-1]))
        return out

    def advance(self, flow_f, flow_b, xy, ok) -> None:
        """One step of the track table."""
        xf, okf = carry(self.cur, flow_f)
        xb, okb = carry(xf, flow_b)
        err = torch.linalg.norm(self.cur - xb, dim=-1)
        step = torch.linalg.norm(self.cur - xf, dim=-1)
        alive = (self.alive & okf & okb & (err / torch.clamp(step, min=1e-12) < 0.2)
                 & (err < 1.0))
        self.prev = self.cur
        self.cur = torch.where(alive[:, None], xf, torch.full_like(xf, np.nan))
        self.move = torch.where(alive, torch.linalg.norm(self.birth - xf, dim=-1), self.move)
        self.age = torch.where(alive, self.age + 1, self.age)
        free = torch.nonzero(~alive)[:, 0]
        cand = torch.nonzero(ok)[:, 0]
        m = min(len(free), len(cand))
        slots, seeds = free[:m], xy[cand[:m]].to(self.dt)
        self.cur[slots] = seeds
        self.prev[slots] = np.nan
        self.birth[slots] = seeds
        self.age[slots] = 0
        self.move[slots] = 0
        alive[slots] = True
        self.alive = alive

    def pair(self, pa, pb) -> dict:
        """Flow both ways, the new frame's corners, the table advanced,
        its pairs."""
        pt = self.pt
        with matmul_precision(self.tf32), torch.no_grad():
            flow_f = dense_flow(pa, pb, pt["iters"], pt["radius"])
            flow_b = dense_flow(pb, pa, pt["iters"], pt["radius"])
            xy, ok = corners(pb[0], pt["corners"], pt["border"])
            self.advance(flow_f, flow_b, xy, ok)
        valid = self.alive & (self.age >= 1) & torch.isfinite(self.prev).all(-1) & (self.move > -1)
        return {"flow_f": flow_f, "flow_b": flow_b, "xy": xy, "ok": ok,
                "pairs": torch.stack([self.prev, self.cur], 1), "valid": valid}


def flow_readings(got: dict, ref: dict) -> dict:
    """One pair's dense flows and corners:

    - ``flow_median``: the median over pixels and both directions of the
      largest component gap (px);
    - ``flow_p999``: its 99.9th percentile (px);
    - ``corner_flip_share``: the corners that one side has and the other
      not (or at another pixel), as a share of the corners asked for."""
    gaps = torch.cat([(got[k].to(ref[k].device).double() - ref[k].double()).abs().amax(-1).flatten()
                      for k in ("flow_f", "flow_b")])
    gaps = torch.where(torch.isfinite(gaps), gaps, torch.full_like(gaps, float("inf")))
    sample = gaps[:: max(1, gaps.numel() // 2_000_000)]
    got_c = {tuple(p) for p, o in zip(got["xy"].cpu().tolist(), got["ok"].cpu().tolist()) if o}
    ref_c = {tuple(p) for p, o in zip(ref["xy"].cpu().tolist(), ref["ok"].cpu().tolist()) if o}
    return {"flow_median": float(gaps.median()),
            "flow_p999": float(torch.quantile(sample, 0.999)),
            "corner_flip_share": len(got_c ^ ref_c) / len(ref["ok"])}


MATCH_PX = 0.5


def table_readings(got: dict, ref: dict) -> dict:
    """One step of the track table.  A slot's corner depends on how many
    slots and corners came before it, so one corner more on one side
    moves every later track to another slot: the pairs are compared as
    sets, each pair of one side matched to the pair of the other whose
    first position is nearest, both ways, within ``MATCH_PX``.

    - ``pair_flip_share``: the pairs without a match, on either side, as
      a share of the table's slots;
    - ``pair_gap``: over the matched pairs, the median of the largest
      coordinate gap of their two positions (px)."""
    pg = got["pairs"].cpu().double()[got["valid"].cpu()]
    pr = ref["pairs"].cpu().double()[ref["valid"].cpu()]
    slots = len(ref["valid"])
    if len(pg) == 0 or len(pr) == 0:
        return {"pair_flip_share": (len(pg) + len(pr)) / slots,
                "pair_gap": float("inf") if len(pg) + len(pr) else 0.0}
    d = torch.cdist(pr[:, 0], pg[:, 0])
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    to_g, to_r = d.argmin(1), d.argmin(0)
    mutual = (to_r[to_g] == torch.arange(len(pr))) & (d.min(1).values <= MATCH_PX)
    gap = (pr[mutual] - pg[to_g[mutual]]).abs().flatten(1).amax(1)
    n = int(mutual.sum())
    return {"pair_flip_share": (len(pr) - n + len(pg) - n) / slots,
            "pair_gap": float(gap.median()) if n else float("inf")}
