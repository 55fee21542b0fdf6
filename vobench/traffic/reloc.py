"""Relocalisation queries, closed loop, one client.

Each query: N 2-D/3-D correspondences of plane points in the query
frame (``outliers`` of them moved by 30-120 px, the inliers with
``noise_px`` of noise), S six-point samples drawn from the seed, and
three frames around the query pose in host memory.  The program fits S
PnP hypotheses (``fit_camera_ransac``), verifies them by IC-GN chains one
frame forward and one back with NCC scores (``track_nposes``) and picks
the winner (``select_best``), whose index comes back to the host.
``queries`` distinct queries are made at set-up and cycled."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from vobench import harness, scenes


def make_queries(seed: int, params: dict, config: dict, device) -> list:
    cam = config["camera"]
    sc = config["scene"]
    rng = scenes.rng(seed, 0)
    scene = scenes.make_scene(rng, cam["wh"], cam["fc"], cam["cc"], z0=sc["z0"],
                              num_waves=sc["num_waves"], freq_range=sc["freq_range"])
    N, S, k = params["points"], params["samples"], config["ransac"]["sample_size"]
    thresh = float(np.hypot(*cam["wh"])) * config["ransac"]["thresh_of_diagonal"]
    queries = []
    for q in range(params["queries"]):
        rq = scenes.rng(seed, 1, q)
        p_ref = np.r_[rq.normal(size=3) * 0.02, rq.normal(size=3) * 0.01]
        back = np.r_[rq.normal(size=3) * 0.02, rq.normal(size=3) * 0.01]
        fwd = np.r_[rq.normal(size=3) * 0.01, rq.normal(size=3) * 0.005]
        Gs = scenes.se3_exp(np.stack([p_ref - back, p_ref, p_ref + fwd]))
        X = scenes.sample_plane_points(scene, rq, N)
        pt2d = scenes.correspondences(scene, Gs[1], X, rq, params["noise_px"],
                                      params["outliers"])
        gen = torch.Generator().manual_seed(int(rq.integers(2**62)))
        idx = torch.argsort(torch.rand((S, N), generator=gen), dim=1)[:, :k]
        queries.append(SimpleNamespace(
            frames=scenes.render_many(scenes.render, scene, Gs, device),
            pt2d=pt2d, pt3d=X.astype(np.float32), idx=idx.numpy(), thresh=thresh,
            pose=p_ref))
    return queries


def setup(ctx):
    from invcompcamtrack_torch import ICGNParams
    from invcompcamtrack_torch.core.camera import CameraPyramid

    cfg = ICGNParams(**ctx.config["tracker"])
    cam_j = ctx.config["camera"]
    t0 = time.perf_counter()
    queries = make_queries(ctx.seed, ctx.params, ctx.config, ctx.device)
    ctx.phases["inputs"] = time.perf_counter() - t0
    st = SimpleNamespace(
        ctx=ctx, cfg=cfg, queries=queries,
        cam=CameraPyramid.create(cam_j["fc"], cam_j["cc"], cam_j["wh"], cfg.num_levels,
                                 cfg.psz, device=ctx.device))
    # the cell's shapes: one query, untimed
    t0 = time.perf_counter()
    for _ in range(ctx.params["warmup"]):
        unit(st, 0, ctx.quiet)
    ctx.phases["warm-up"] = time.perf_counter() - t0
    return st


def unit(st, i: int, trace) -> dict:
    """One query, from its frames in host memory to the winner's index
    on the host."""
    from invcompcamtrack_torch.image.pyramid import build_pyramid
    from invcompcamtrack_torch.sfm.ransac import fit_camera_ransac
    from invcompcamtrack_torch.solver.chain import select_best, track_nposes

    span = trace.span
    q = st.queries[i % len(st.queries)]
    cfg, dev, cam_j = st.cfg, st.ctx.device, st.ctx.config["camera"]
    t0 = time.perf_counter()
    with span("upload"):
        frames = torch.from_numpy(q.frames).to(dev)
        pyrs = [build_pyramid(frames[k], cfg.num_levels, cfg.psz) for k in range(3)]
        pt2d = torch.from_numpy(q.pt2d).to(dev)
        pt3d = torch.from_numpy(q.pt3d).to(dev)
        idx = torch.from_numpy(q.idx).to(dev)
    with span("fit"):
        res = fit_camera_ransac(idx, pt2d, pt3d, cam_j["fc"], cam_j["cc"], inl_thresh=q.thresh,
                                min_inliers=st.ctx.config["ransac"]["min_inliers"])
    with span("verify"):
        ch = track_nposes(pyrs, res.poses, pt3d, res.inliers, st.cam, cfg, (1, 1))
        best, _ = select_best(ch, res.valid)
        b = int(best)
    t1 = time.perf_counter()
    return {"t0": t0, "t1": t1, "work": int(idx.shape[0]), "query": i % len(st.queries),
            "best": b, "G": res.G, "valid": res.valid, "inl": res.inliers, "poses": res.poses,
            "tracks": ch.pose_tracks, "corr": ch.mean_corr}


def end_to_end(run) -> dict:
    hyp = sum(r["work"] for r in run.records)
    return {"hypotheses_per_s": (hyp / run.window_s, "hypotheses/s")}


def release(st) -> None:
    st.cam = None


def check(st, records) -> dict:
    """A sample of the window's answers, drawn from the seed, against the
    reference; each number is the worst over the sample."""
    from vobench.reference import reloc as ref

    ctx = st.ctx
    worst: dict = {}
    for rec in _picks(ctx, records):
        harness.keep_worst(worst, ref.readings(rec, st.queries[rec["query"]], ctx.config,
                                               ctx.device))
    return {name: {"value": v, "limit": ctx.limits[name]} for name, v in worst.items()}


def _picks(ctx, records) -> list:
    rng = scenes.rng(ctx.seed, 2)
    n = min(ctx.params["check_answers"], len(records))
    return [records[int(a)] for a in rng.choice(len(records), size=n, replace=False)]


def control(st, records) -> dict:
    """The control: the reference in float32 with TF32 products, in the
    program's place, on the queries of the same sample -> the worst
    reading of each number."""
    from vobench.reference import reloc as ref

    ctx = st.ctx
    worst: dict = {}
    for rec in _picks(ctx, records):
        q = st.queries[rec["query"]]
        harness.keep_worst(worst, ref.readings(ref.control(q, ctx.config, ctx.device), q,
                                               ctx.config, ctx.device))
    return worst
