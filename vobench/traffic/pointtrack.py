"""Offline point tracking of a video, closed loop over a clip.

``frames`` frames of a textured plane along ``chip_smoke.py`` phase
4e's camera steps are rendered at set-up into host memory and played
forward then backward.  Each unit takes the next frame: its pyramid,
dense LK flow both ways against the previous frame's pyramid
(``dense_flow_lk``), its Shi-Tomasi corners, one step of the track table
(``advance_tracks``) and its verified point pairs (``point_pairs``).  A
unit's latency runs from the frame in host memory to its pairs on the
card."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from vobench import harness, scenes


def make_clip(seed: int, params: dict, config: dict, device) -> np.ndarray:
    cam, sc = config["camera"], config["scene"]
    rng = scenes.rng(seed, 0)
    scene = scenes.make_scene(rng, cam["wh"], cam["fc"], cam["cc"], z0=sc["z0"],
                              num_waves=sc["num_waves"], freq_range=sc["freq_range"])
    poses = scenes.path_clip(params["frames"], scenes.rng(seed, 1))
    return scenes.render_many(scenes.render, scene, scenes.se3_exp(poses), device)


def setup(ctx):
    from invcompcamtrack_torch.image.pyramid import build_pyramid
    from invcompcamtrack_torch.match.track import make_track_table

    pt = ctx.config["pointtrack"]
    t0 = time.perf_counter()
    clip = make_clip(ctx.seed, ctx.params, ctx.config, ctx.device)
    ctx.phases["inputs"] = time.perf_counter() - t0
    st = SimpleNamespace(ctx=ctx, pt=pt, clip=clip, kept=[], seen=0,
                         rng=scenes.rng(ctx.seed, 2), build_pyramid=build_pyramid)
    # the cell's shapes: two pairs on a table of their own, untimed
    t0 = time.perf_counter()
    st.table = make_track_table(pt["corners"], window=pt["track_window"], device=ctx.device)
    st.prev = _pyramid(st, clip[0])
    for i in range(ctx.params["warmup"]):
        _pair(st, clip[i + 1], ctx.quiet)
    # the window starts at frame 0 with a fresh table
    st.table = make_track_table(pt["corners"], window=pt["track_window"], device=ctx.device)
    st.prev = _pyramid(st, clip[0])
    ctx.sync()
    ctx.phases["warm-up"] = time.perf_counter() - t0
    return st


def _pyramid(st, frame):
    return st.build_pyramid(torch.from_numpy(frame).to(st.ctx.device), st.pt["levels"],
                            st.pt["padding"])


def _pair(st, frame, trace) -> dict:
    from invcompcamtrack_torch.match.dense_flow import dense_flow_lk
    from invcompcamtrack_torch.match.features import shi_tomasi_corners
    from invcompcamtrack_torch.match.track import advance_tracks, point_pairs

    pt, pad = st.pt, st.pt["padding"]
    with trace.span("upload"):
        pyr = _pyramid(st, frame)
    with trace.span("dense"):
        flow_f = dense_flow_lk(st.prev, pyr, pad, iters=pt["iters"], radius=pt["radius"])
        flow_b = dense_flow_lk(pyr, st.prev, pad, iters=pt["iters"], radius=pt["radius"])
    with trace.span("tracks"):
        xy, ok = shi_tomasi_corners(pyr[0].img[pad:-pad, pad:-pad], max_corners=pt["corners"],
                                    border=pt["border"])
        st.table = advance_tracks(st.table, flow_f, flow_b, xy, ok)
        pairs, valid = point_pairs(st.table)
        st.ctx.sync()
    st.prev = pyr
    return {"flow_f": flow_f, "flow_b": flow_b, "xy": xy, "ok": ok, "pairs": pairs,
            "valid": valid}


def unit(st, i: int, trace) -> dict:
    """One frame pair: window pair i runs from frame ping_pong(i) to
    ping_pong(i + 1)."""
    n = len(st.clip)
    frame = st.clip[scenes.ping_pong(i + 1, n)]
    t0 = time.perf_counter()
    out = _pair(st, frame, trace)
    t1 = time.perf_counter()
    # a sample of the pairs' flows and corners, kept for the check:
    # reservoir sampling from the seed over however many pairs come
    k = st.ctx.params["check_pairs"]
    st.seen += 1
    if len(st.kept) < k:
        st.kept.append((i, out))
    else:
        j = int(st.rng.integers(st.seen))
        if j < k:
            st.kept[j] = (i, out)
    return {"t0": t0, "t1": t1, "work": 1, "pairs": out["pairs"], "valid": out["valid"]}


def end_to_end(run) -> dict:
    lat = [1e3 * (r["t1"] - r["t0"]) for r in run.records]
    return {"flow_pairs_per_s": (len(run.records) / run.window_s, "pairs/s"),
            "flow_pair_ms_p95": (harness.percentile(lat, 95), "ms")}


def release(st) -> None:
    st.table = st.prev = None


def _readings(st, records, program: bool) -> dict:
    from vobench.reference import pointtrack as ref

    ctx, n = st.ctx, len(st.clip)
    worst: dict = {}

    base = ref.Tracker(st.pt, ctx.device)
    for i, out in st.kept:
        pa = base.pyramid(st.clip[scenes.ping_pong(i, n)])
        pb = base.pyramid(st.clip[scenes.ping_pong(i + 1, n)])
        want = ref.Tracker(st.pt, ctx.device).pair(pa, pb)
        if program:
            got = out
        else:
            ctl = ref.Tracker(st.pt, ctx.device, tf32=True)
            got = ctl.pair(ctl.pyramid(st.clip[scenes.ping_pong(i, n)]),
                           ctl.pyramid(st.clip[scenes.ping_pong(i + 1, n)]))
        harness.keep_worst(worst, ref.flow_readings(got, want))
    # the track table, followed from the window's fresh table over its
    # first pairs
    want_t = ref.Tracker(st.pt, ctx.device)
    got_t = ref.Tracker(st.pt, ctx.device, tf32=True) if not program else None
    steps = min(ctx.params["check_table_pairs"], len(records))
    prev_w = want_t.pyramid(st.clip[0])
    prev_g = got_t.pyramid(st.clip[0]) if got_t else None
    for i in range(steps):
        frame = st.clip[scenes.ping_pong(i + 1, n)]
        cur_w = want_t.pyramid(frame)
        want = want_t.pair(prev_w, cur_w)
        prev_w = cur_w
        if got_t:
            cur_g = got_t.pyramid(frame)
            got = got_t.pair(prev_g, cur_g)
            prev_g = cur_g
        else:
            got = records[i]
        harness.keep_worst(worst, ref.table_readings(got, want))
    return worst


def check(st, records) -> dict:
    """The sampled pairs' flows and corners against the reference's, and
    the track table's pairs over the window's first pairs; each number
    the worst over them."""
    worst = _readings(st, records, True)
    lim = st.ctx.limits
    return {name: {"value": v, "limit": lim[name]} for name, v in worst.items()}


def control(st, records) -> dict:
    """The control: the reference in float32 with TF32 products, in the
    program's place, on the same pairs."""
    return _readings(st, records, False)
