"""The plain reference of a relocalisation query, and the readings that
hold the program's answer to it.

Written from the definitions of the upstream's relocalisation
(func_ransac_fitcameras_odom.m, run_track_nposes.cpp, odometer.cpp) as
the system documents them:

- the fit: per six-point sample a planar PnP (the plane's frame from the
  points' scatter, the homography by DLT, its columns scaled by their
  mean norm, signed by the points' depth and made a rotation); the
  inliers of every correspondence within the threshold; a refit on them,
  kept where it has as many inliers; a hypothesis is valid with
  ``min_inliers`` inliers;
- the verification: per hypothesis an inverse-compositional
  Gauss-Newton chain one frame forward and one back, over the pyramid
  levels ``lv_f`` to ``lv_l``, on its inliers, with the points and pose
  normalised (centred, divided by their mean squared distance), the
  Jacobians at the starting pose, an additive update of the pose's
  [t, w] and a stop once the update's L1 norm falls to ``normdp_ratio``
  of the first's; a query patch moves at most from -3 to +4 pixels from
  where the level started it (the tracker's window of psz + 8);
- the score: per inlier the normalised cross-correlation of mean-removed
  patches, (back, ref) and (ref, fwd), each weighted by its chain's
  squared length where both patches lie strictly inside the image, and
  per hypothesis the mean over its inliers; the winner is the valid
  hypothesis of the highest mean.

The fit is worked out in float32 with TF32 off, the precision the
configuration states: its eigenvector of a 9x9 normal matrix lies up to
1e-2 from the exact one in float32, which is as far as TF32 takes it
from the float32 one, so only a float32 reference separates the two.
The chains and scores are worked out in float64, from the hypotheses of
the answer under check.  The control is this reference in float32 with
TF32 products (``precision``)."""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

from vobench.reference import plain
from vobench.reference.precision import matmul_precision

# ------------------------------------------------------------------ fit


def pnp_planar(X: torch.Tensor, xn: torch.Tensor, w: torch.Tensor):
    """X (S, n, 3) coplanar points, xn (S, n, 2) normalised pixels, w
    (S, n) weights (0 or 1) -> [R | t] (S, 3, 4) and a flag where the
    homography has no scale."""
    wsum = torch.clamp(w.sum(-1), min=1e-12)[..., None]
    mean = torch.einsum("sn,sni->si", w, X) / wsum
    C = X - mean[:, None]
    scatter = torch.einsum("sn,sni,snj->sij", w, C, C)
    ev, E = torch.linalg.eigh(scatter)
    if bool((ev[:, 0] >= 1e-3 * torch.clamp(ev[:, 1], min=1e-20)).any()):
        raise ValueError("the reference fits coplanar points only")
    e1, e2 = E[..., 2], E[..., 1]
    q = torch.stack([torch.einsum("sni,si->sn", C, e1), torch.einsum("sni,si->sn", C, e2),
                     torch.ones_like(w)], -1)
    # x ~ H q: two rows per point, each row weighted
    u, v = xn[..., :1], xn[..., 1:]
    z = torch.zeros_like(q)
    A = torch.cat([torch.cat([q, z, -u * q], -1), torch.cat([z, q, -v * q], -1)], 1)
    A = A * torch.cat([w, w], 1)[..., None]
    _, V = torch.linalg.eigh(torch.matmul(A.transpose(1, 2), A))
    H = V[..., 0].reshape(-1, 3, 3)
    scale = 0.5 * (torch.linalg.norm(H[..., 0], dim=-1) + torch.linalg.norm(H[..., 1], dim=-1))
    bad = scale < 1e-12
    H = H / torch.where(bad, torch.ones_like(scale), scale)[:, None, None]
    depth = H[:, None, 2, 2] + q[..., 0] * H[:, None, 2, 0] + q[..., 1] * H[:, None, 2, 1]
    H = H * torch.where((depth * w).sum(-1) < 0, -1.0, 1.0).to(H.dtype)[:, None, None]
    h1, h2 = H[..., 0], H[..., 1]
    Rp = plain.nearest_rotation(torch.stack([h1, h2, torch.linalg.cross(h1, h2)], -1))
    R = torch.matmul(Rp, torch.stack([e1, e2, torch.linalg.cross(e1, e2)], -1).transpose(1, 2))
    t = H[..., 2] - torch.matmul(R, mean[..., None])[..., 0]
    return torch.cat([R, t[..., None]], -1), bad


def collinear(p2: torch.Tensor, p3: torch.Tensor) -> torch.Tensor:
    """Any three points of a sample on one line, in the image (as
    homogeneous points) or in space: a triple product under 2.22e-16."""
    p2h = torch.cat([p2, torch.ones_like(p2[..., :1])], -1)
    out = torch.zeros(p2.shape[0], dtype=torch.bool, device=p2.device)
    for i, j, k in combinations(range(p2.shape[1]), 3):
        for p in (p2h, p3):
            out |= torch.linalg.det(torch.stack([p[:, i], p[:, j], p[:, k]], 1)).abs() < 2.22e-16
    return out


def fit(idx, pt2d, pt3d, cam: dict, thresh: float, min_inliers: int):
    """-> G (S, 3, 4), inliers (S, N), valid (S,)."""
    fc = torch.tensor(cam["fc"], dtype=pt2d.dtype, device=pt2d.device)
    cc = torch.tensor(cam["cc"], dtype=pt2d.dtype, device=pt2d.device)
    xn = (pt2d - cc) / fc
    S = idx.shape[0]

    def errors(G):
        Xc = plain.transform(G, pt3d)
        return torch.linalg.norm(Xc[..., :2] / Xc[..., 2:] * fc + cc - pt2d, dim=-1)

    G0, bad0 = pnp_planar(pt3d[idx], xn[idx], torch.ones(idx.shape, dtype=pt2d.dtype,
                                                          device=pt2d.device))
    inl0 = errors(G0) <= thresh
    G1, bad1 = pnp_planar(pt3d.expand(S, -1, -1), xn.expand(S, -1, -1), inl0.to(pt2d.dtype))
    inl1 = errors(G1) <= thresh
    keep = (inl1.sum(-1) >= inl0.sum(-1)) & ~bad1
    G = torch.where(keep[:, None, None], G1, G0)
    inl = torch.where(keep[:, None], inl1, inl0)
    valid = (~collinear(pt2d[idx], pt3d[idx]) & ~bad0 & (inl.sum(-1) >= min_inliers)
             & torch.isfinite(G).flatten(1).all(-1))
    return G, inl, valid


# --------------------------------------------------------- verification


def normalise(X, mask):
    """Centre the masked points and divide by their mean squared
    distance -> (Xn, mean, msd)."""
    m = mask.to(X.dtype)
    cnt = torch.clamp(m.sum(-1), min=1.0)
    mean = (X * m[..., None]).sum(-2) / cnt[..., None]
    d = X - mean[..., None, :]
    msd = ((d * d).sum(-1) * m).sum(-1) / cnt
    return d / msd[..., None, None], mean, msd


def with_centre(p, mean, msd, inverse=False):
    """The pose p whose camera centre c moves to (c - mean) / msd (or
    back, with ``inverse``), its rotation kept."""
    G = plain.se3_exp(p)
    R = G[..., :3]
    c = -torch.matmul(R.transpose(-1, -2), G[..., 3:])[..., 0]
    c = c * msd[..., None] + mean if inverse else (c - mean) / msd[..., None]
    return plain.se3_log(torch.cat([R, -torch.matmul(R, c[..., None])], -1))


def inside(uv, lvl, strict=False):
    W, H = lvl[4], lvl[5]
    x, y = uv[..., 0], uv[..., 1]
    if strict:
        return (x > 0) & (y > 0) & (x < W) & (y < H)
    return (x >= 0) & (y >= 0) & (x <= W) & (y <= H)


def solve6(H, b):
    """H x = b per hypothesis, each scaled by its diagonal first; 0
    where H is singular."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1).abs(), min=1e-30))
    x, info = torch.linalg.solve_ex(H / (d[..., :, None] * d[..., None, :]), (b / d)[..., None])
    x = x[..., 0] / d
    ok = (info == 0)[..., None] & torch.isfinite(x)
    return torch.where(ok, x, torch.zeros_like(x))


def jacobian_rows(Xc, fx, fy):
    """d(u, v) / d[t, w] of a point (..., 3) seen at Xc -> (..., 6) each."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zero = torch.zeros_like(z)
    ju = torch.stack([fx / z, zero, -fx * x / (z * z), -fx * x * y / (z * z),
                      fx * (1 + x * x / (z * z)), -fx * y / z], -1)
    jv = torch.stack([zero, fy / z, -fy * y / (z * z), -fy * (1 + y * y / (z * z)),
                      fy * x * y / (z * z), fy * x / z], -1)
    return ju, jv


def track(pyr_a, pyr_b, X, p, mask, cam: dict, tr: dict):
    """The poses p (S, 6) of frame a carried to frame b by IC-GN on the
    masked points X (N, 3)."""
    psz, pad = tr["psz"], tr["psz"]
    slack, span = (8 - 1) // 2, 8 - 1      # the window: psz + 8 pixels
    Xn, mean, msd = normalise(X.expand(p.shape[0], -1, -1), mask)
    p = with_centre(p, mean, msd)
    G0 = plain.se3_exp(p)   # the Jacobians' pose, at every level
    for s in range(tr["lv_f"], tr["lv_l"] - 1, -1):
        lvl = plain.camera_level(cam, s, X.dtype, X.device)
        uv_r, Xc0 = plain.project(G0, Xn, lvl)
        vr = inside(uv_r, lvl) & (Xc0[..., 2] > 0) & mask
        uv_r = torch.where(vr[..., None], uv_r, torch.zeros_like(uv_r))
        Xs = torch.where(vr[..., None], Xc0, torch.ones_like(Xc0))
        img, dx, dy = pyr_a[s]
        T, Tx, Ty = plain.patches((img, dx, dy), uv_r, psz, pad)
        T = T * vr[..., None, None]
        ju, jv = jacobian_rows(Xs, lvl[0], lvl[1])
        ju, jv = ju * vr[..., None], jv * vr[..., None]
        Txf, Tyf = Tx.flatten(-2), Ty.flatten(-2)
        # steepest-descent images sd_k = ju_k Tx + jv_k Ty; H = sum sd sd^T
        sd = ju[..., :, None] * Txf[..., None, :] + jv[..., :, None] * Tyf[..., None, :]
        H = torch.einsum("snkp,snlp->skl", sd, sd)
        # the query windows, where each point's level starts
        uv_e, _ = plain.project(plain.se3_exp(p), Xn, lvl)
        uv_e = torch.where(torch.isfinite(uv_e) & vr[..., None], uv_e, torch.zeros_like(uv_e))
        er, ec, _, _ = plain.support(uv_e, psz, pad)
        Hp, Wp = pyr_b[s][0].shape
        wr = torch.clamp(er - slack, 0, Hp - psz - 8)
        wc = torch.clamp(ec - slack, 0, Wp - psz - 8)
        active = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
        ndp = first = None
        for it in range(tr["maxiter"]):
            uv, Xc = plain.project(plain.se3_exp(p), Xn, lvl)
            vn = inside(uv, lvl) & vr & (Xc[..., 2] > 0)
            uv = torch.where(vn[..., None], uv, torch.zeros_like(uv))
            r0, c0, frac_x, frac_y = plain.support(uv, psz, pad)
            r0 = wr + torch.clamp(r0 - (er - slack), 0, span)
            c0 = wc + torch.clamp(c0 - (ec - slack), 0, span)
            (Q,) = plain.sample((pyr_b[s][0],), r0, c0, frac_x, frac_y, psz)
            e = ((T - Q) * vn[..., None, None]).flatten(-2)
            delta = solve6(H, torch.einsum("snkp,snp->sk", sd, e)) * active[:, None]
            p = p + delta
            n1 = delta.abs().sum(-1)
            ndp = n1 if it == 0 else torch.where(active, n1, ndp)
            if it == 0:
                first = n1
            active = active & (ndp / first > tr["normdp_ratio"])
    return with_centre(p, mean, msd, inverse=True)


def ncc(a, b):
    """max(0, <a / |a|, b / |b|>) of mean-removed patches (..., p, p)."""
    a = (a - a.mean((-2, -1), keepdim=True)).flatten(-2)
    b = (b - b.mean((-2, -1), keepdim=True)).flatten(-2)
    a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=1e-15)
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-15)
    return torch.clamp((a * b).sum(-1), min=0.0)


def verify(pyrs, poses, X, inl, cam: dict, tr: dict):
    """-> the chains' poses (S, 3, 6), back, start and forward, and each
    hypothesis' mean correlation (S,)."""
    back = track(pyrs[1], pyrs[0], X, poses, inl, cam, tr)
    fwd = track(pyrs[1], pyrs[2], X, poses, inl, cam, tr)
    lvl = plain.camera_level(cam, tr["lv_l"], X.dtype, X.device)
    cs = []
    for k, p in enumerate((back, poses, fwd)):
        uv, _ = plain.project(plain.se3_exp(p), X, lvl)
        ok = inside(uv, lvl, strict=True)
        uv = torch.where(torch.isfinite(uv), uv, torch.zeros_like(uv))
        (P,) = plain.patches((pyrs[k][tr["lv_l"]][0],), uv, tr["psz"], tr["psz"])
        cs.append((P, ok))
    (pb, vb), (pr, vr), (pf, vf) = cs
    wb, wf = vb.to(X.dtype), vf.to(X.dtype)
    corr = torch.clamp((ncc(pb, pr) * wb + ncc(pr, pf) * wf)
                       / torch.clamp(wb + wf, min=1e-15), min=0.0)
    corr = torch.where(vr & inl, corr, torch.full_like(corr, -1.0))
    mean_corr = torch.where(inl, corr, torch.zeros_like(corr)).sum(-1) / torch.clamp(
        inl.sum(-1), min=1).to(X.dtype)
    return torch.stack([back, poses, fwd], 1), mean_corr


def _on(a, dt, device):
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)


def solve_fit(query, config: dict, device, tf32: bool = False) -> dict:
    """The fit of the query's S samples in float32, TF32 off (the
    configuration's precision), or for the control with TF32 products:
    G, inliers, valid flags and the poses' [t, w]."""
    with matmul_precision(tf32), torch.no_grad():
        G, inl, valid = fit(torch.as_tensor(query.idx, device=device),
                            _on(query.pt2d, torch.float32, device),
                            _on(query.pt3d, torch.float32, device),
                            config["camera"], query.thresh, config["ransac"]["min_inliers"])
        return {"G": G, "inl": inl, "valid": valid, "poses": plain.se3_log(G)}


def solve_verify(query, config: dict, device, poses, inliers, valid,
                 tf32: bool = False) -> dict:
    """The chains and scores of the hypotheses ``poses`` (S, 6) on their
    ``inliers`` (S, N), and the winner among the ``valid``: in float64,
    or for the control in float32 with TF32 products."""
    cam, tr = config["camera"], config["tracker"]
    dt = torch.float32 if tf32 else torch.float64
    with matmul_precision(tf32), torch.no_grad():
        frames = _on(query.frames, dt, device)
        pyrs = [plain.pyramid(frames[k], tr["lv_f"] + 1, tr["psz"]) for k in range(3)]
        tracks, corr = verify(pyrs, poses.to(device=device, dtype=dt),
                              _on(query.pt3d, dt, device), inliers.to(device), cam, tr)
        score = torch.where(valid.to(device), corr, torch.full_like(corr, -np.inf))
        return {"tracks": tracks, "corr": corr, "best": int(torch.argmax(score))}


def control(query, config: dict, device) -> dict:
    """The control's answer: the fit and the chains of its own
    hypotheses, in float32 with TF32 products."""
    f = solve_fit(query, config, device, tf32=True)
    return dict(f, **solve_verify(query, config, device, f["poses"], f["inl"], f["valid"],
                                  tf32=True))


def _gap(a, b) -> torch.Tensor:
    """Per hypothesis the largest entry gap; inf where either side is not
    finite."""
    d = (a.cpu().double() - b.cpu().double()).abs().flatten(1).amax(1)
    return torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))


VERIFIED = 0.99


def readings(got: dict, query, config: dict, device) -> dict:
    """The numbers compared for one answer ``got`` (G, inl, valid, poses,
    tracks, corr, best):

    - ``fit_G_p75``: over the hypotheses valid in the reference fit, the
      75th percentile of the largest entry gap of [R|t], a hypothesis
      that the answer holds invalid counting as an infinite gap (a
      valid flag is a count against a threshold, which float32 rounding
      flips for a few hypotheses near it);
    - ``track_median``: over the answer's valid hypotheses that the
      reference verifies (mean correlation ``VERIFIED`` or more in the
      reference's chains of the same hypotheses), the median of the
      largest pose gap along their chains (three frames);
    - ``corr_median``: over those hypotheses, the median gap of the mean
      correlations;
    - ``select_gap``: how far the answer's winner lies below the best of
      the answer's own mean correlations over its valid hypotheses (the
      selection, followed from the answer's scores: 0 where it picks the
      best)."""
    fit_r = solve_fit(query, config, device)
    valid_g, valid_r = got["valid"].cpu(), fit_r["valid"].cpu()
    gap = torch.where(valid_g, _gap(got["G"], fit_r["G"]), torch.tensor(float("inf")))[valid_r]
    out = {"fit_G_p75": float(torch.quantile(gap, 0.75)) if len(gap) else float("inf")}
    # the chains follow the answer's own hypotheses (see PERF.md: a
    # float32 fit lies up to 1e-2 from the exact one, and a chain is not
    # continuous in its start); a chain from a hypothesis that does not
    # converge is not continuous in its float type either, so only the
    # hypotheses that the reference verifies are compared
    ver_r = solve_verify(query, config, device, got["poses"], got["inl"], got["valid"])
    corr_r = ver_r["corr"].cpu().double()
    ok = valid_g & (corr_r >= VERIFIED)
    if int(ok.sum()) == 0:
        return dict(out, track_median=float("inf"), corr_median=float("inf"),
                    select_gap=float("inf"))
    out["track_median"] = float(_gap(got["tracks"], ver_r["tracks"])[ok].median())
    corr_g = got["corr"].cpu().double()
    out["corr_median"] = float((corr_g - corr_r).abs()[ok].median())
    score = torch.where(valid_g, corr_g, torch.tensor(-np.inf, dtype=torch.float64))
    b = int(got["best"])
    out["select_gap"] = float(score.max() - score[b]) if bool(valid_g[b]) else float("inf")
    return out
