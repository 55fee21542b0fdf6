#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``invcompcamtrack_torch/csrc``, holds
each against its plain PyTorch version at the main paths' shapes, and
drives nine paths, each with the launch counts set to 0 just before it
and read just after:

1. the batched IC-GN tracker ``track_pose_batch`` at the shape of
   ``bench.py::bench_solver`` (B=256 problems x N=100 points on one
   1280x720 pair, psz 8, levels 4 -> 0, maxiter 10): K1 x 5, K2 x 50;
2. the odometry verifier through its CLI's ``run`` (S=256 hypotheses x
   N=100 shared points on three 1280x720 frames, ``fb_frames = (1, 1)``,
   input and result through the reference's file protocol): K1 x 10,
   K2 x 100, K4 x 1; and ``main(argv)`` on PNG files where PIL exists;
3. the tracker's non-fused paths: psz 4 with the window cache (K6 x 5,
   K7 x 5) and psz 8 with ``window_cache=False`` (K6 x 5, K5 x 50);
4. the pair tracker through its CLI's ``run`` (one problem of N=100
   points, input through the reference's point+camera file) at psz 8
   (K1 x 5, K2 x 50) and psz 4 (K6 x 5, K7 x 5);
5. the optical-flow point tracker (the loop of
   ``examples/run_of_point_track.py``) on a 6-frame 1280x720 clip: 5-level
   pyramids, dense LK flow forward and backward (K8 x 40 per frame
   pair), 1000 Shi-Tomasi corners, the track table; then sparse LK with
   the forward/backward gate at those corners (K6 x 10 and K7 x 10, or
   K6 x 10 and K5 x 80 without the window cache), the flow-quality
   benchmark's ``evaluate_pair`` on one 640x480 pair at patch side 32
   (K8 x 16, K5 x 4), and the tracker of path 1 with
   ``gather_prefetch=True`` (K9 x 5, K1 x 0, K2 x 50), whose poses must
   equal path 1's bit for bit;
6. the visual-odometry engine, one stream, at ``bench.py::bench_engine``'s
   workload (66 frames of 1280x720, 400 seeds, 512 landmarks, a
   5-keyframe window): bootstrap from the true poses, frames 2-33 through
   ``run_frames``, frames 34-65 timed (per frame K1 x 5, K2 x 50; per
   keyframe K6 x 20, K7 x 20), the ATE against the true centres, the card
   against the port's CPU run, and the GT-free bootstrap and
   ``examples/run_kitti_vo_torch.py``'s synthetic fallback at small sizes;
7. the multi-stream engine ``VisualOdometryBatch`` at
   ``bench.py::bench_engine_streams``' workload (4 streams of that clip's
   scene, each on its own pose path, 400 seeds each): frames 34-65 of all
   streams timed, with one stream's launches (per frame K1 x 5, K2 x 50,
   per keyframe K6 x 20, K7 x 20: the kernels read the streams' planes as
   one stack), each stream's ATE over the timed chunk, the device ops of a
   step beside phase 6's one stream, and each stream against its own
   engine alone on the card;
8. the RANSAC pose path (the reference's ``func_ransac_fitcameras_odom`` at
   the verifier's workload): ``fit_camera_ransac`` draws S=256 six-point
   PnP hypotheses from N=100 plane points seen in frame 1 (20 of them
   outliers), ``track_nposes`` verifies them on the verifier's three
   frames and ``select_best`` picks the winner: K1 x 10, K2 x 100, K4 x 1;
   the winner's centre error and inlier set, the fit against the port's
   CPU run of it, the verification of 16 hypotheses against the CPU, and
   hypotheses/s of the fit alone and of the whole path with its host syncs;
9. this slice's smaller paths, not timed: the stereo chain of
   ``examples/run_stereo_track_torch.py`` (K6, K7), the NVM replay through
   the pair tracker's CLI (K1 x 5, K2 x 50 per frame pair), the VGG
   feature descriptors on a stack of 32 maps (K5 x 1, equal to 32
   one-plane calls), and a checkpoint round trip of a small VO engine.

It checks that each path went through its kernels and solved its
problem, compares the card with the port's CPU run, then times the paths
and every kernel beside its plain version and its bound, K5 and K6 also
at the other patch sides their callers use and K4 at psz 4 and 16.  The
kernels that take the centres (K1, K4, K5, K6, K9) are also held at
centres on, just below and just above integers and not finite, and each
of their wrappers, and K7's, must be one device op.  K1, K5, K6, K7 and
K9 are also held on a stack of 4 planes, against their plain versions
and against 4 calls on one plane each; K7 also at every square side it
is compiled for and at sides given at run time, with origins beyond
every border, and timed at 12x12 and 16x16 windows and at the engine's
512 points.

It imports no JAX.  It exits non-zero, and prints no result, when no
CUDA card is present, when the package is missing, or when any phase
fails.  The last line is one JSON object naming the device.
"""

import contextlib
import dataclasses
import importlib.util
import io as io_module
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

B, N = 256, 100
S_WRONG = 8      # catastrophically wrong hypotheses among the S = B
SEED = 0
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Tolerances (kernel vs plain version on the card, same inputs):
# K1, K5, K6 perform the plain version's float operations in its order
# (taps and gradient differences with the non-contracting _rn
# intrinsics) and K7 copies: expected bit-exact; 1e-4 bounds ~8 ulp of
# intensities < 256.
K1_TOL = 1e-4
GATHER_TOL = 0.0
# The centres at which K1, K4, K5, K6 and K9, which compute the support
# start and the weights themselves, must still equal the plain version
# (K4 within its tolerance): on an integer, within 1e-5 below one (first
# column from ceil(x + 1e-5), weights from x - floor(x)), just above one,
# at negative fractions, and not finite (NaN patches and NaN scores, read
# from inside the plane).
EDGE_CENTERS = ([[k + d, 0.5 * k + d] for k in (0.0, 1.0, 7.0, 300.0, 1279.0)
                 for d in (0.0, -5e-6, 1e-5, -1e-5, 2e-5, -0.25)]
                + [[-0.3, -0.7], [-1.5, 3.25], [-2.0, -3.0], [float("nan"), 5.0],
                   [5.0, float("nan")], [float("nan")] * 2, [float("inf"), 3.0],
                   [3.0, float("-inf")]])
# K8 performs the plain version's float operations in its order through
# the _rn intrinsics: bit-exact, NaN pixels at the same places.  K9 runs
# K1's device functions on the same floats: equal to K1 bit for bit.
WARP_TOL = 0.0
PREFETCH_TOL = 0.0
# Dense LK flow, card vs the port's CPU run of one 1280x720 pair: the box
# convolutions sum 81 products, and a pixel whose 2x2 determinant is small
# amplifies a last-bit difference through five levels of four iterations.
# Measured on an H100 (torch 2.11, CUDA 12.8): 0.0 at every pixel, the
# card's and the CPU's convolutions summing in one order; another cuDNN
# algorithm need not, so the limits are those of two float32 runs of the
# same flow (the CPU tests measure 1e-5 px between the port and the JAX
# package): the median pixel within FLOW_MEDIAN_TOL px, 99.9 % of the
# pixels within FLOW_TOL px.
FLOW_TOL = 1e-3
FLOW_MEDIAN_TOL = 1e-5
# The point tracker's checks: the forward flow's median endpoint error
# against the plane's analytic flow; the share of the tracks seeded on
# the first pair that give a verified pair on the second (the gate asks
# a forward/backward error under a fifth of a ~1.5 px step of a flow
# whose median error is ~0.45 px: just under half pass on the CPU); the
# verified pairs' median step against the analytic flow there.
EPE_LIMIT = 1.0
PAIRS_SHARE = 1.0 / 3.0
STEP_TOL = 0.5
# K2 sums the 64 pixels of the mean and of (gx, gy) in a warp butterfly:
# the gap is relative to the magnitudes summed.
K2_RTOL = 1e-5
# K3's error image is exact without the mean, ~1 ulp of it with one.
K3_TOL = 4e-5
# K4 takes three sums (mean, squares, dot) per patch in a warp butterfly
# and divides by the product of the norms where the plain version
# normalises first: 2e-5 of sum|p_a p_b| / (n_a n_b) (<= 1).  The other
# summation order of the mean shifts every pixel of a patch by up to
# MEAN_EPS (2 ulp of 256), which moves a unit-normalised patch by at most
# 8 MEAN_EPS / n: negligible for a textured patch, and the whole score
# for a flat one, whose direction is rounding noise.  Both versions must
# stay in [0, 1].
K4_RTOL = 2e-5
MEAN_EPS = 6.2e-5
# Poses of the card's run vs the port's CPU run (plain versions): the
# sums of H, rhs and (gx, gy) are taken in other orders; 5x the CPU
# tests' port-vs-JAX tolerance.
POSE_TOL = 1e-4
# The tracker is not continuous in its inputs, in the JAX package as here:
# a patch's first column comes from ceil(x + 1e-5) and its weights from
# x - floor(x), which disagree by one pixel for a centre on or within 1e-5
# below an integer; a point on the frustum border counts or not; a lane
# freezes when its step falls under normdp_ratio of its first one.  A
# last-bit difference between two runs decides each of these, and a GN
# iteration that meets one takes a kicked step.  So the card is held to
# the CPU as the CPU holds to itself: the median lane within
# POSE_TOL / 10, at most a quarter of the lanes beyond POSE_TOL, none
# beyond REPRO_TOL (a tenth of the accuracy limit 0.05); and each
# comparison prints, beside the card's gap, the gap of two CPU runs whose
# initial poses differ by 1e-7.
REPRO_TOL = 5e-3
# The verifier's poses through its CLI must equal the direct tracker
# calls on which its chains are compared:
TIE_TOL = 1e-6
# Correlations, card vs CPU: the chains' poses differ by up to POSE_TOL,
# which moves a reprojection by up to ~0.1 px at fc ~ 1000.
CORR_TOL = 5e-3
# The VO engine (path 6) at bench.py::bench_engine's workload: 66 frames of
# 1280x720, 400 seeds, 512 landmarks, a 5-keyframe window.
ENGINE_FRAMES, ENGINE_CHUNK = 66, 32
# bench_engine's tripwire on the ATE against the true centres (unaligned)
ENGINE_ATE_LIMIT = 0.01
# The engine, card vs the port's CPU run (bootstrap + frames 2-11 at full
# width), per-frame pose gap (max abs coefficient).  The tracker and BA's
# accept/reject are not continuous in their inputs, and the engine carries
# each frame's state into the next, so the card is held to the CPU as the
# CPU holds to itself: the median frame within ENGINE_MEDIAN_TOL, the worst
# within ENGINE_WORST_TOL; beside the card's gaps the phase prints those of
# two CPU runs whose seeds differ by ENGINE_SEED_SHIFT (1e-6, a float32 ulp
# or two at depth 8: 1e-7 would leave most coordinates unmoved).  Measured
# on an H100 (torch 2.11, CUDA 12.8): the card 2.7e-6 from the CPU at the
# median frame and 1.7e-5 at the worst; the two CPU runs 4.9e-6 and 2.5e-5.
# The median frame is held to 10 x the CPU's median spread.  The worst is
# held to REPRO_TOL: a tracker call on a plane at one depth is float32-
# sensitive in its normalised coordinates (JAX f32 and f64 part by 9.3e-5
# at 320x240, tests/test_torch_icgn.py), and the engine carries a call's
# gap into the frames after it.
ENGINE_MEDIAN_TOL = 5e-5
ENGINE_WORST_TOL = REPRO_TOL
ENGINE_SEED_SHIFT = 1e-6
# Phase 3b's plane stack: K1, K5, K6, K7 and K9 read P_STACK planes in
# one launch (the multi-stream engine's S streams).
P_STACK = 4
# The multi-stream VO engine (path 7) at bench.py::bench_engine_streams'
# workload: ENGINE_STREAMS streams of bench_engine's scene and chunks, each
# on its own pose path; bench_engine_streams' guard on every stream's ATE
# over the timed chunk (unaligned, bench.py:224-233).  Each stream is held
# to its own engine run alone on the card over its first STREAM_CMP_FRAMES
# frames, as the card is held to the CPU (ENGINE_MEDIAN_TOL at the median
# frame, ENGINE_WORST_TOL at the worst): on the card two operations of the
# tracker sum a batch of streams in another order than one stream
# (examples/stream_batch_gap_torch.py: the points' sum in
# core/pose.py::normalize_points and the Hessian's bmm in
# solver/icgn.py::_outer_sum), 4e-5 per step at most from equal states, and
# the tracker's discontinuity carries that into the frames after it.
# Measured on an H100: median frame 2.2e-6, worst 3.8e-4 (stream 1).  The
# device ops of a step at ENGINE_STREAMS streams within OPS_SHARE of phase
# 6's one stream.
ENGINE_STREAMS = 4
STREAM_ATE_LIMIT = 0.08
STREAM_CMP_FRAMES = 8
OPS_SHARE = 0.05
# K7's timing: launches per pass (two warm passes); the engine's points
# per stream (VOConfig.corners_per_kf)
K7_REPS = 24
K7_ENGINE_POINTS = 512
# examples/run_stereo_track.py (the JAX example) on the CPU: its frames'
# camera-centre errors 0.1311, 0.0036, 0.0704, 0.0361 (jax 0.9.0); the port's
# example draws other RANSAC samples, so each solved frame is held to twice
# the JAX example's worst and their mean to twice its mean.
STEREO_JAX_ERR_MAX = 0.1311
STEREO_JAX_ERR_MEAN = 0.0603
# The RANSAC pose path (path 8, the reference's func_ransac_fitcameras_odom
# at the verifier's workload): S = B hypotheses from RANSAC_SAMPLE-point
# samples of the verifier's N plane points seen in frame 1 with
# RANSAC_NOISE px of noise, RANSAC_OUTLIERS of them moved by 30-120 px;
# inliers within the image diagonal / 100 (run_ransac_test.m:85), at least
# RANSAC_MIN_INLIERS; the hypotheses verified by the odometry chain.  The
# winner's inlier set holds at most OUTLIER_SHARE of the outliers and at
# least INLIER_SHARE of the inliers (tests/test_ransac.py:83-84).
RANSAC_SAMPLE = 6
# The card's fit against the port's CPU run of it, over the hypotheses
# valid in both: the gaps of the hypotheses' G ([R|t], max abs entry) at
# the median, the 90th percentile and the worst hypothesis, each within
# twice the JAX package's own float32-vs-float64 gap of the same call on
# the CPU (two float32 runs, each within that gap of the float64 answer).
# Measured on the CPU (jax 0.9.0, float32 vs float64, the port's indices;
# tests/test_torch_ransac.py::test_phase8_limits_cover_the_jax_gap):
# median 4.11e-5, 90th percentile 5.78e-3, max 3.33 over the 134 valid
# hypotheses: float32 eigensolvers of the 9x9 homography DLT part widely on
# samples near degeneracy, and 11 of 256 refit decisions flip.
JAX_F32_G_GAP = {"median": 4.11e-5, "p90": 5.78e-3, "max": 3.33}
RANSAC_G_LIMITS = {q: 2.0 * v for q, v in JAX_F32_G_GAP.items()}
# The discrete part: a hypothesis whose refit rests on a few points (an
# outlier in its sample) is ill-conditioned, and two float32 runs can take
# the refit or not, which moves its inlier count across min_inliers.  The
# same JAX comparison flips 11 of the 256 refit decisions (and no valid
# flag); the card's valid flags may differ from the CPU's at up to twice
# that many hypotheses.
JAX_F32_REFIT_FLIPS = 11
RANSAC_VALID_FLIPS = 2 * JAX_F32_REFIT_FLIPS
RANSAC_NOISE = 0.3
RANSAC_OUTLIERS = 20
RANSAC_MIN_INLIERS = 5
OUTLIER_SHARE = 0.1
INLIER_SHARE = 0.9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=10, warmup=3):
    """Median over ``reps`` calls of the card's time for one call (ms)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


PROFILE_PAD = 256


def device_ms(torch, fn, reps=10, what="", per_call=None, top=0):
    """The card's busy time for one call (ms; every device op that the
    profiler records, summed over the calls / their number), the number of
    device ops per call, and the ms per call of the port's own kernels by
    name (the ``icgn::`` kernels of ``csrc/``).

    A profile of a few short calls can come back without some or all of
    their device events, and with one stale event of the profile before it
    (seen on an H100, in a process that had taken profiles of tens of
    thousands of events: a profile of 5 launches gave 0 to 4 of them, one of
    170 all of them; the first launch of a profile can go missing too).  So
    the calls stand between throw-away spin kernels, a few before them and
    PROFILE_PAD after them, which take the losses at both ends (the stale
    event is then one of them) and are left out by name.
    Where the caller states how many device ops of a name one call launches
    (``per_call``: a part of the name and the number, ``("icgn::", 1)`` for
    one kernel of ``csrc/``, ``("", 1)`` for a call that is one op), the
    calls are counted from those events and not taken from ``reps``.  ``top`` prints that many device ops by
    their share of the busy time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # (a profile can come back without one device event, seen once in
    # eight runs on an H100: it is then taken again, at most twice)
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.001)
            for _ in range(reps):
                fn()
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = list(prof.events())
        ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.name]
        # (every call launches the same ops: a count that the calls do not
        # divide means that the profile missed some)
        if ops and len(ops) % reps == 0:
            break
        print(f"torch.profiler recorded {len(ops)} device events for {reps} calls of "
              f"{what} ({len(events)} events in all), attempt {attempt + 1}")
    check(len(ops) > 0, f"torch.profiler recorded no device time for {what}")
    calls = reps
    if per_call:
        part, per = per_call
        n_named = sum(1 for e in ops if part in e.name)
        check(n_named >= per, f"torch.profiler recorded no '{part}' op for {what}")
        calls = n_named / per
        if calls != reps:
            print(f"torch.profiler recorded {calls:g} of the {reps} calls of {what}")
    own, by_name = {}, {}
    for e in ops:
        ms = e.time_range.elapsed_us() / calls / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        if "icgn::" in e.name:
            kernel = e.name.split("icgn::")[1].split("(")[0].split("<")[0]
            own[kernel] = own.get(kernel, 0.0) + ms
    busy_ms = sum(by_name.values())
    if top:
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        print(f"{what}: device ops by time: " + "; ".join(
            f"{name.split('(')[0][-60:]} {ms:.3f} ms ({ms / busy_ms:.1%})"
            for name, ms in ranked))
    return busy_ms, len(ops) / calls, own


def kernel_launch_ms(torch, fn, reps, what):
    """Each launch's own time (ms) of the kernel of ``csrc/`` that one call
    of ``fn`` launches once, over ``reps`` calls in one profile (between
    throw-away spin kernels, as ``device_ms`` takes them).

    Such a profile can come back with none of its launches (seen on an H100
    in two of four runs of this script, both times at K7's 512 windows: 0
    of 24, with no device event at all, the spin kernels' neither, and the
    profile taken next recorded all of them): it is then taken again, at
    most four times, and the fullest of the profiles is kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        ms = [e.time_range.elapsed_us() / 1e3 for e in events if "icgn::" in e.name]
        if len(ms) > len(best):
            best = ms
        if len(ms) >= reps:
            break
        print(f"{what}: the profile recorded {len(ms)} of {reps} launches "
              f"({len(events)} device events in all), attempt {attempt + 1}")
    check(len(best) >= reps // 2,
          f"{what}: the profile recorded {len(best)} of {reps} launches")
    return best


def host_syncs(torch, fn) -> dict:
    """The host's waits on the card in one call of ``fn``: the runtime's
    synchronize calls and its device-to-host reads (``aten::item`` /
    ``_local_scalar_dense``, e.g. the ``info`` checks of ``torch.linalg``),
    counted in a profile of one call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    events = list(prof.events())
    syncs = [e for e in events if e.name in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")]

    def outermost(e):
        while getattr(e, "cpu_parent", None) is not None:
            e = e.cpu_parent
        return e.name

    by_op = {}
    for e in syncs:
        by_op[outermost(e)] = by_op.get(outermost(e), 0) + 1
    return {"synchronize": len(syncs),
            "scalar_reads": sum(1 for e in events if e.name == "aten::_local_scalar_dense"),
            "memcpy": sum(1 for e in events if e.name.startswith("cudaMemcpy")),
            "synchronize_by_op": by_op}


def bound(bytes_moved: float, flops: float):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the float32 operations over their peak."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def problem_geometry():
    """bench.py::bench_solver's scene, pose and points, from SEED, and a
    third pose one more step along for the verifier: (scene, p_gt, X
    (B, N, 3) float32, p2)."""
    from invcompcamtrack_torch import synthetic

    rng = np.random.default_rng(SEED)
    scene = synthetic.make_scene(rng, wh=(1280, 720), fc=(1000.0, 1200.0), z0=8.0)
    p_gt = np.r_[rng.normal(size=3) * 0.02, rng.normal(size=3) * 0.01]
    X = np.stack([synthetic.sample_plane_points(scene, rng, N) for _ in range(B)])
    # half the first step's size: at a full-size second step the coarsest
    # level sends some of the 256 chains into a wrong basin
    rng2 = np.random.default_rng(SEED + 2)
    p2 = p_gt + np.r_[rng2.normal(size=3) * 0.01, rng2.normal(size=3) * 0.005]
    return scene, p_gt, X.astype(np.float32), p2


def make_problem():
    """problem_geometry()'s scene rendered at its three poses."""
    import torch

    from invcompcamtrack_torch import synthetic
    from invcompcamtrack_torch.core import lie

    def exp_np(p):
        return lie.se3_exp(torch.tensor(p, dtype=torch.float32)).double().numpy()

    scene, p_gt, X, p2 = problem_geometry()
    img_ref, img_new, img_2 = (synthetic.render(scene, exp_np(p)).astype(np.float32)
                               for p in (np.zeros(6), p_gt, p2))
    return scene, p_gt, p2, img_ref, img_new, img_2, X


def ransac_problem(scene, p_gt, X):
    """Phase 8's correspondences: the verifier's N shared plane points
    X[0] observed in frame 1 (pose p_gt) with RANSAC_NOISE px of noise,
    the first RANSAC_OUTLIERS of them moved by 30-120 px, from SEED + 8.
    Returns (pt2d, pt3d) float32, and the inlier threshold: the image
    diagonal / 100 (run_ransac_test.m:85)."""
    import torch

    from invcompcamtrack_torch.core import lie

    rng = np.random.default_rng(SEED + 8)
    pt3d = X[0].astype(np.float64)
    G1 = lie.se3_exp(torch.tensor(p_gt, dtype=torch.float64)).numpy()
    Xc = pt3d @ G1[:, :3].T + G1[:, 3]
    pt2d = Xc[:, :2] / Xc[:, 2:] * np.asarray(scene.fc) + np.asarray(scene.cc)
    pt2d += rng.normal(size=pt2d.shape) * RANSAC_NOISE
    sign = rng.choice([-1.0, 1.0], size=(RANSAC_OUTLIERS, 2))
    pt2d[:RANSAC_OUTLIERS] += sign * rng.uniform(30.0, 120.0, size=(RANSAC_OUTLIERS, 2))
    thresh = float(np.hypot(*scene.wh)) / 100.0
    return pt2d.astype(np.float32), pt3d.astype(np.float32), thresh


def reset(*count_dicts) -> None:
    for counts in count_dicts:
        for k in counts:
            counts[k] = 0


def held_to_repro(name, gaps):
    """gaps: per-lane max abs pose difference between the card's run and
    the CPU's -> the number of lanes beyond POSE_TOL; fails beyond
    REPRO_TOL's rule."""
    apart = int((gaps > POSE_TOL).sum())
    check(float(gaps.median()) <= POSE_TOL / 10 and 4 * apart <= len(gaps)
          and float(gaps.max()) <= REPRO_TOL,
          f"{name}: card vs CPU poses differ by {float(gaps.max())} (median "
          f"{float(gaps.median())}), {apart} of {len(gaps)} lanes beyond {POSE_TOL}")
    return apart


def engine_workload(torch):
    """bench.py::bench_engine's scene, pose path and seeds (from its
    generator, seeded with 1), with two more frames along the path (from a
    generator of their own) for the single-step timings."""
    from concurrent.futures import ThreadPoolExecutor

    from invcompcamtrack_torch import synthetic
    from invcompcamtrack_torch.core import lie

    rng = np.random.default_rng(1)
    scene = synthetic.make_scene(rng, wh=(1280, 720), fc=(1000.0, 1200.0), z0=8.0,
                                 freq_range=(0.5, 6.0))
    poses = [np.zeros(6)]
    for i in range(1, ENGINE_FRAMES):
        poses.append(poses[-1] + np.r_[0.02, 0.01 * np.sin(i * 0.3), 0.01,
                                       rng.normal(size=3) * 0.001])
    seeds = synthetic.sample_plane_points(scene, rng, 400, margin=24)
    rng_x = np.random.default_rng(SEED + 6)
    for i in range(ENGINE_FRAMES, ENGINE_FRAMES + 2):
        poses.append(poses[-1] + np.r_[0.02, 0.01 * np.sin(i * 0.3), 0.01,
                                       rng_x.normal(size=3) * 0.001])
    poses = np.stack(poses)
    Gs = [lie.se3_exp(torch.tensor(p, dtype=torch.float64)).numpy() for p in poses]
    with ThreadPoolExecutor(8) as ex:
        frames = np.stack(list(ex.map(
            lambda G: synthetic.render(scene, G).astype(np.float32), Gs)))
    centers = np.stack([-G[:, :3].T @ G[:, 3] for G in Gs])
    return scene, poses, frames, seeds, centers


def engine_phase(torch, dev, card, all_counts, read_counts, expect_counts):
    """Path 6: the VO engine, one stream, at bench_engine's workload on the
    card (bootstrap from the true poses, frames 2-33 through run_frames
    untimed, frames 34-65 timed with the launch counts set to 0 just
    before), then single-step timings and profiles, the card against the
    port's CPU run, and the GT-free bootstrap at a small size."""
    from invcompcamtrack_torch import ICGNParams, synthetic
    from invcompcamtrack_torch.core import lie
    from invcompcamtrack_torch.core.camera import CameraPyramid
    from invcompcamtrack_torch.image.pyramid import build_pyramid
    from invcompcamtrack_torch.vo import engine
    from invcompcamtrack_torch.vo.metrics import ate_rmse

    t_phase = time.perf_counter()
    scene, poses, frames, seeds, centers = engine_workload(torch)
    render_s = time.perf_counter() - t_phase
    tracker = ICGNParams(lv_f=4, lv_l=0, psz=8, maxiter=10)
    cfg = engine.VOConfig(tracker=tracker, max_landmarks=512, window=5, keyframe_stride=2,
                          corners_per_kf=512, min_parallax_px=1.0)
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, tracker.num_levels, tracker.psz)
    vo = engine.VisualOdometry(cam, scene.fc, scene.cc, cfg)
    check(vo.device.type == dev.type, "VisualOdometry did not default to the card")
    vo.bootstrap(frames[0], frames[1], poses[0], poses[1], seeds)
    n_boot = int(vo.lm_valid.sum())
    chunks = [torch.from_numpy(frames[a:a + ENGINE_CHUNK]).to(dev)
              for a in (2, 2 + ENGINE_CHUNK)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vo.run_frames(chunks[0])
    warm_s = time.perf_counter() - t0
    reset(*all_counts)
    t0 = time.perf_counter()
    vo.run_frames(chunks[1])          # returns the poses on the host: synced
    chunk_s = time.perf_counter() - t0
    launches = read_counts()
    L, n_kf = tracker.num_levels, ENGINE_CHUNK // cfg.keyframe_stride
    # per frame K1 once per level and K2 once per iteration of every level
    # (the port's loop runs maxiter iterations, frozen or not); per
    # keyframe two forward/backward LK passes (re-observation and corner
    # tracks), each K6 and K7 once per level both ways
    expect_counts(f"engine, run_frames over {ENGINE_CHUNK} frames ({n_kf} keyframes)",
                  launches, {"K1": L * ENGINE_CHUNK,
                             "K2": L * tracker.maxiter * ENGINE_CHUNK,
                             "K6": 4 * L * n_kf, "K7": 4 * L * n_kf})
    traj = np.stack(vo.trajectory)
    check(traj.shape == (ENGINE_FRAMES, 3) and np.isfinite(traj).all(),
          f"engine: trajectory {traj.shape}, finite {np.isfinite(traj).all()}")
    ate = float(ate_rmse(torch.tensor(traj, dtype=torch.float64),
                         torch.tensor(centers[:ENGINE_FRAMES]), with_scale=False))
    n_live = int(vo.lm_valid.sum())
    print(f"[{card}] engine: ATE {ate:.6f} (limit {ENGINE_ATE_LIMIT}) over {ENGINE_FRAMES} frames; "
          f"live landmarks {n_live} (bootstrap {n_boot})")
    check(np.isfinite(ate) and ate < ENGINE_ATE_LIMIT, f"engine: ATE {ate}")
    check(n_live > n_boot, f"engine: {n_live} live landmarks, not more than the "
          f"bootstrap's {n_boot}")

    # one keyframe step and one track step from the state after frame 65
    # (frame 66 a keyframe, frame 67 tracked against frame 64's keyframe).
    # Each call starts from the same state: a keyframe step writes its
    # pyramid into the ring slot it evicts, which no step of this state
    # reads, so the calls repeat.
    st0 = vo.states
    img_kf = torch.from_numpy(frames[ENGINE_FRAMES]).to(dev)[None]
    img_tr = torch.from_numpy(frames[ENGINE_FRAMES + 1]).to(dev)[None]

    def kf_call():
        return engine._keyframe_step(st0, img_kf, vo.cam, cfg)

    def tr_call():
        return engine._track_step(st0, img_tr, vo.cam, cfg)

    kf_ms = cuda_ms(torch, kf_call, reps=5, warmup=1)
    tr_ms = cuda_ms(torch, tr_call, reps=5, warmup=1)
    kf_busy, kf_ops, kf_own = device_ms(torch, kf_call, reps=1,
                                        what="the engine's keyframe step", top=10)
    tr_busy, tr_ops, tr_own = device_ms(torch, tr_call, reps=1,
                                        what="the engine's track step", top=5)
    # the keyframe step stage by stage, from the same state and frame
    pyr_kf = build_pyramid(img_kf, L, tracker.psz)
    p_kf = engine._track_frame(st0, pyr_kf, vo.cam, tracker)
    ro = engine._promote_reobserve(st0, pyr_kf, p_kf, vo.cam, cfg)
    tri = engine._promote_triangulate(st0, pyr_kf, p_kf, vo.cam, cfg, ro)
    stages = {
        "track": lambda: engine._track_frame(st0, pyr_kf, vo.cam, tracker),
        "re-observation (fb LK)": lambda: engine._promote_reobserve(
            st0, pyr_kf, p_kf, vo.cam, cfg),
        "corners, fb LK, triangulation": lambda: engine._promote_triangulate(
            st0, pyr_kf, p_kf, vo.cam, cfg, ro),
        "ring write, gates, window BA": lambda: engine._promote_commit(
            st0, pyr_kf, p_kf, vo.cam, cfg, tri)}
    stage_prof = {}
    for k, f in stages.items():
        busy, ops, _ = device_ms(torch, f, reps=1, what=f"the engine's keyframe stage {k}")
        stage_prof[k] = {"wall_ms": cuda_ms(torch, f, reps=3, warmup=1), "device_busy_ms": busy,
                         "device_ops": ops}
    print(f"[{card}] engine keyframe step by stage: " + "; ".join(
        f"{k} wall {v['wall_ms']:.1f} ms, device busy {v['device_busy_ms']:.2f} ms in "
        f"{v['device_ops']:.0f} ops" for k, v in stage_prof.items()))
    n_tr = ENGINE_CHUNK - n_kf
    busy_share = (n_kf * kf_busy + n_tr * tr_busy) / (chunk_s * 1e3)
    fps = ENGINE_CHUNK / chunk_s
    print(f"[{card}] engine 1280x720, 512 landmarks, window 5: {fps:.2f} frames/s over "
          f"frames 34-65 ({chunk_s * 1e3:.1f} ms for {ENGINE_CHUNK} frames; frames 2-33 "
          f"took {warm_s * 1e3:.1f} ms); keyframe step wall {kf_ms:.2f} ms, device busy "
          f"{kf_busy:.2f} ms in {kf_ops:.0f} device ops ({kf_busy / kf_ms:.1%}); track "
          f"step wall {tr_ms:.2f} ms, device busy {tr_busy:.2f} ms in {tr_ops:.0f} device "
          f"ops ({tr_busy / tr_ms:.1%}); device busy {busy_share:.1%} of the timed chunk "
          f"(the steps' busy time over its wall)")
    print(f"[{card}] engine: the port's kernels, device ms per keyframe step: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(kf_own.items()))
          + "; per track step: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(tr_own.items())))

    # the card vs the port's CPU run, bootstrap + frames 2-11
    n_cmp = 10

    def engine_run(device, sd):
        c = cam if device is None else cam.to(device)
        v = engine.VisualOdometry(c, scene.fc, scene.cc, cfg, device=device)
        v.bootstrap(frames[0], frames[1], poses[0], poses[1], sd)
        return np.stack([v.process_frame(frames[i]) for i in range(2, 2 + n_cmp)])

    p_card = engine_run(None, seeds)
    t0 = time.perf_counter()
    p_cpu = engine_run("cpu", seeds)
    cpu_s = time.perf_counter() - t0
    moved = seeds + np.random.default_rng(SEED + 7).normal(size=seeds.shape) * ENGINE_SEED_SHIFT
    p_cpu2 = engine_run("cpu", moved)
    gaps = np.abs(p_card - p_cpu).max(axis=1)
    own = np.abs(p_cpu2 - p_cpu).max(axis=1)
    print(f"[{card}] engine, card vs CPU, {n_cmp} frames: per-frame gaps "
          + " ".join(f"{g:.2e}" for g in gaps)
          + f" (median {np.median(gaps):.2e}, limit {ENGINE_MEDIAN_TOL}; worst limit "
          f"{ENGINE_WORST_TOL}); CPU vs CPU with the seeds {ENGINE_SEED_SHIFT} apart: "
          + " ".join(f"{g:.2e}" for g in own) + f" (median {np.median(own):.2e}); "
          f"the CPU run took {cpu_s:.1f} s")
    check(np.median(gaps) <= ENGINE_MEDIAN_TOL and gaps.max() <= ENGINE_WORST_TOL,
          f"engine: card vs CPU per-frame gaps {gaps}")

    # GT-free bootstrap on the card (tests/test_vo_engine.py::
    # test_vo_engine_self_initialization's scene and motion), then the
    # synthetic fallback of examples/run_kitti_vo_torch.py (320x240)
    rng = np.random.default_rng(0)
    scene_s = synthetic.make_scene(rng, wh=(256, 192), fc=(240.0, 245.0),
                                   freq_range=(0.8, 8.0))
    ps = [np.zeros(6)]
    for _ in range(1, 8):
        ps.append(ps[-1] + np.r_[0.02, 0.008, -0.03, rng.normal(size=3) * 0.001])
    Gs = [lie.se3_exp(torch.tensor(p, dtype=torch.float64)).numpy() for p in ps]
    imgs = [synthetic.render(scene_s, G) for G in Gs]
    tr_s = ICGNParams(lv_f=2, lv_l=0, psz=8, maxiter=8)
    cfg_s = engine.VOConfig(tracker=tr_s, max_landmarks=256, window=4, keyframe_stride=2,
                            corners_per_kf=256, min_parallax_px=0.5)
    cam_s = CameraPyramid.create(scene_s.fc, scene_s.cc, scene_s.wh, tr_s.num_levels,
                                 tr_s.psz)
    vo_s = engine.VisualOdometry(cam_s, scene_s.fc, scene_s.cc, cfg_s)
    n_seeds = vo_s.bootstrap_from_images(imgs[0], imgs[1])
    for img in imgs[2:]:
        vo_s.process_frame(img)
    c_s = np.stack([-G[:, :3].T @ G[:, 3] for G in Gs])
    ate_s = float(ate_rmse(torch.tensor(np.stack(vo_s.trajectory), dtype=torch.float64),
                           torch.tensor(c_s), with_scale=True))
    extent_s = float(np.linalg.norm(c_s[-1] - c_s[0]))
    print(f"[{card}] engine, GT-free bootstrap 256x192: {n_seeds} seeds (limit > 50), scale-aligned "
          f"ATE {ate_s:.5f} (limit {0.05 * extent_s + 0.01:.5f})")
    check(n_seeds > 50 and ate_s < 0.05 * extent_s + 0.01,
          f"engine, GT-free bootstrap: {n_seeds} seeds, ATE {ate_s}")
    spec = importlib.util.spec_from_file_location(
        "run_kitti_vo_torch", Path(__file__).resolve().parent / "examples" / "run_kitti_vo_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with contextlib.redirect_stdout(io_module.StringIO()) as out:
        traj_x, ate_x = example.main(["--frames", "20"])
    c_x = example.synthetic_sequence(20)[2]
    limit_x = 0.05 * float(np.linalg.norm(c_x[-1] - c_x[0])) + 0.01
    print(f"[{card}] examples/run_kitti_vo_torch.py (synthetic fallback, on the card): "
          + " | ".join(out.getvalue().strip().splitlines()[1:]))
    check(traj_x.shape == (20, 3) and np.isfinite(traj_x).all() and ate_x < limit_x,
          f"examples/run_kitti_vo_torch.py: ATE {ate_x} (limit {limit_x})")

    return launches, {
        "card": card, "frames_per_s": fps, "ms_per_frame": chunk_s * 1e3 / ENGINE_CHUNK,
        "keyframe_step_ms": kf_ms, "track_step_ms": tr_ms,
        "keyframe_device_busy_ms": kf_busy, "keyframe_device_ops": kf_ops,
        "track_device_busy_ms": tr_busy, "track_device_ops": tr_ops,
        "device_busy_share": busy_share, "kernel_ms_per_keyframe": kf_own,
        "kernel_ms_per_track_frame": tr_own, "keyframe_stages": stage_prof,
        "launches": launches,
        "ate": ate, "live_landmarks": n_live, "bootstrap_landmarks": n_boot,
        "cpu_gaps": gaps.tolist(), "cpu_vs_moved_cpu_gaps": own.tolist(),
        "self_init_seeds": n_seeds, "self_init_ate": ate_s, "example_ate": ate_x,
        "render_s": render_s, "seconds": time.perf_counter() - t_phase}


def streams_workload(torch):
    """bench.py::bench_engine_streams' workload: bench_engine's scene (its
    generator seeded with 1) and ENGINE_STREAMS pose paths, stream s from
    a generator seeded with 10 + s, which then draws the stream's 400
    seeds; two more frames along each path (drawn after the seeds) for the
    single-step timings.  -> scene, poses (S, 68, 6), frames (S, 68, H, W),
    seeds (S, 400, 3), centres (S, 68, 3)."""
    from concurrent.futures import ThreadPoolExecutor

    from invcompcamtrack_torch import synthetic
    from invcompcamtrack_torch.core import lie

    rng = np.random.default_rng(1)
    scene = synthetic.make_scene(rng, wh=(1280, 720), fc=(1000.0, 1200.0), z0=8.0,
                                 freq_range=(0.5, 6.0))
    poses, seeds = [], []
    for s in range(ENGINE_STREAMS):
        rr = np.random.default_rng(10 + s)
        path = [np.zeros(6)]
        for i in range(1, ENGINE_FRAMES):
            path.append(path[-1] + np.r_[0.02, 0.01 * np.sin(i * 0.3), 0.01,
                                         rr.normal(size=3) * 0.001])
        seeds.append(synthetic.sample_plane_points(scene, rr, 400, margin=24))
        for i in range(ENGINE_FRAMES, ENGINE_FRAMES + 2):
            path.append(path[-1] + np.r_[0.02, 0.01 * np.sin(i * 0.3), 0.01,
                                         rr.normal(size=3) * 0.001])
        poses.append(np.stack(path))
    poses = np.stack(poses)
    Gs = [lie.se3_exp(torch.tensor(p, dtype=torch.float64)).numpy() for p in poses.reshape(-1, 6)]
    with ThreadPoolExecutor(8) as ex:
        frames = np.stack(list(ex.map(
            lambda G: synthetic.render(scene, G).astype(np.float32), Gs)))
    centers = np.stack([-G[:, :3].T @ G[:, 3] for G in Gs])
    S, F = poses.shape[:2]
    return (scene, poses, frames.reshape((S, F) + frames.shape[1:]), np.stack(seeds),
            centers.reshape(S, F, 3))


def streams_phase(torch, dev, card, all_counts, read_counts, expect_counts, one_stream):
    """Path 7: the multi-stream engine, VisualOdometryBatch over
    ENGINE_STREAMS streams at bench_engine_streams' workload on the card
    (each stream bootstrapped from its true poses, frames 2-33 untimed,
    frames 34-65 timed with the launch counts set to 0 just before), each
    stream's ATE over the timed chunk, single-step timings and profiles at
    S streams beside phase 6's one stream (``one_stream``), and each
    stream against its own engine run alone on the card."""
    from invcompcamtrack_torch import ICGNParams
    from invcompcamtrack_torch.core import lie
    from invcompcamtrack_torch.core.camera import CameraPyramid
    from invcompcamtrack_torch.vo import engine
    from invcompcamtrack_torch.vo.metrics import ate_rmse

    t_phase = time.perf_counter()
    scene, poses, frames, seeds, centers = streams_workload(torch)
    render_s = time.perf_counter() - t_phase
    S = ENGINE_STREAMS
    tracker = ICGNParams(lv_f=4, lv_l=0, psz=8, maxiter=10)
    cfg = engine.VOConfig(tracker=tracker, max_landmarks=512, window=5, keyframe_stride=2,
                          corners_per_kf=512, min_parallax_px=1.0)
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, tracker.num_levels, tracker.psz)
    engines = []
    for s in range(S):
        vo = engine.VisualOdometry(cam, scene.fc, scene.cc, cfg)
        vo.bootstrap(frames[s, 0], frames[s, 1], poses[s, 0], poses[s, 1], seeds[s])
        engines.append(vo)
    batch = engine.VisualOdometryBatch(engines)
    check(batch.states.landmarks.device.type == dev.type, "VisualOdometryBatch is not on the card")
    chunks = [torch.from_numpy(frames[:, a:a + ENGINE_CHUNK]).to(dev)
              for a in (2, 2 + ENGINE_CHUNK)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = batch.run_frames(chunks[0])
    warm_s = time.perf_counter() - t0
    reset(*all_counts)
    t0 = time.perf_counter()
    timed = batch.run_frames(chunks[1])   # returns the poses on the host: synced
    chunk_s = time.perf_counter() - t0
    launches = read_counts()
    L, n_kf = tracker.num_levels, ENGINE_CHUNK // cfg.keyframe_stride
    # the launches of one stream: the S streams' planes are one stack per call
    expect_counts(f"engine, {S} streams, run_frames over {ENGINE_CHUNK} frames ({n_kf} "
                  f"keyframes)", launches,
                  {"K1": L * ENGINE_CHUNK, "K2": L * tracker.maxiter * ENGINE_CHUNK,
                   "K6": 4 * L * n_kf, "K7": 4 * L * n_kf})
    check(timed.shape == (S, ENGINE_CHUNK, 6) and np.isfinite(timed).all()
          and np.isfinite(warm).all(), f"streams: poses {timed.shape}")
    ates = []
    for s in range(S):
        c = lie.camera_center(lie.se3_exp(torch.tensor(timed[s], dtype=torch.float64)))
        ates.append(float(ate_rmse(c,
                                   torch.tensor(centers[s, 2 + ENGINE_CHUNK:2 + 2 * ENGINE_CHUNK]),
                                   with_scale=False)))
    n_live = [int(batch.state_of(s).lm_valid.sum()) for s in range(S)]
    fps = S * ENGINE_CHUNK / chunk_s
    print(f"[{card}] engine, {S} streams: ATE over the timed chunk per stream "
          + " ".join(f"{a:.6f}" for a in ates) + f" (limit {STREAM_ATE_LIMIT}); live landmarks "
          f"{n_live}")
    check(all(np.isfinite(a) and a < STREAM_ATE_LIMIT for a in ates), f"streams: ATE {ates}")

    # one keyframe step and one track step of all S streams from the state
    # after frame 65 (frame 66 a keyframe, 67 tracked), repeatable as in
    # phase 6
    st0 = batch.states
    img_kf = torch.from_numpy(np.ascontiguousarray(frames[:, ENGINE_FRAMES])).to(dev)
    img_tr = torch.from_numpy(np.ascontiguousarray(frames[:, ENGINE_FRAMES + 1])).to(dev)

    def kf_call():
        return engine._keyframe_step(st0, img_kf, batch.cam, cfg)

    def tr_call():
        return engine._track_step(st0, img_tr, batch.cam, cfg)

    kf_ms = cuda_ms(torch, kf_call, reps=3, warmup=1)
    tr_ms = cuda_ms(torch, tr_call, reps=3, warmup=1)
    kf_busy, kf_ops, kf_own = device_ms(torch, kf_call, reps=1,
                                        what=f"the {S}-stream keyframe step", top=10)
    tr_busy, tr_ops, tr_own = device_ms(torch, tr_call, reps=1,
                                        what=f"the {S}-stream track step", top=5)
    n_tr = ENGINE_CHUNK - n_kf
    busy_share = (n_kf * kf_busy + n_tr * tr_busy) / (chunk_s * 1e3)
    ops_1 = {"keyframe": one_stream["keyframe_device_ops"],
             "track": one_stream["track_device_ops"]}
    print(f"[{card}] engine, {S} streams x 1280x720, 512 landmarks, window 5: {fps:.2f} frames/s "
          f"({S} x {ENGINE_CHUNK} frames in {chunk_s * 1e3:.1f} ms over frames 34-65; frames "
          f"2-33 took {warm_s * 1e3:.1f} ms; one stream (phase 6): "
          f"{one_stream['frames_per_s']:.2f} frames/s); keyframe step wall {kf_ms:.2f} ms, "
          f"device busy {kf_busy:.2f} ms in {kf_ops:.0f} device ops (one stream "
          f"{ops_1['keyframe']:.0f}); track step wall {tr_ms:.2f} ms, device busy "
          f"{tr_busy:.2f} ms in {tr_ops:.0f} device ops (one stream {ops_1['track']:.0f}); "
          f"device busy {busy_share:.1%} of the timed chunk")
    print(f"[{card}] engine, {S} streams: the port's kernels, device ms per keyframe step: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(kf_own.items()))
          + "; per track step: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(tr_own.items())))
    for what, ops in (("keyframe", kf_ops), ("track", tr_ops)):
        check(abs(ops - ops_1[what]) <= OPS_SHARE * ops_1[what],
              f"streams: a {what} step at {S} streams is {ops:.0f} device ops, one stream's "
              f"{ops_1[what]:.0f}")

    # each stream against its own engine alone on the card (the batch
    # stacked copies of the engines' states, which are still at frame 2)
    gaps = []
    for s, vo in enumerate(engines):
        alone = vo.run_frames(chunks[0][s, :STREAM_CMP_FRAMES])
        gaps.append(np.abs(warm[s, :STREAM_CMP_FRAMES] - alone).max(axis=1))
    gaps = np.stack(gaps)
    print(f"[{card}] engine, {S} streams vs each stream alone on the card, first "
          f"{STREAM_CMP_FRAMES} frames, per-frame pose gaps: "
          + " | ".join(" ".join(f"{g:.1e}" for g in row) for row in gaps)
          + f" (median {np.median(gaps):.2e}, limit {ENGINE_MEDIAN_TOL}; worst limit "
          f"{ENGINE_WORST_TOL})")
    check(np.median(gaps) <= ENGINE_MEDIAN_TOL and gaps.max() <= ENGINE_WORST_TOL,
          f"streams vs alone: per-frame gaps {gaps}")
    return launches, {
        "card": card, "streams": S, "frames_per_s": fps,
        "ms_per_frame": chunk_s * 1e3 / (S * ENGINE_CHUNK),
        "keyframe_step_ms": kf_ms, "track_step_ms": tr_ms,
        "keyframe_device_busy_ms": kf_busy, "keyframe_device_ops": kf_ops,
        "track_device_busy_ms": tr_busy, "track_device_ops": tr_ops,
        "one_stream_device_ops": ops_1, "device_busy_share": busy_share,
        "kernel_ms_per_keyframe": kf_own, "kernel_ms_per_track_frame": tr_own,
        "launches": launches, "ate_per_stream": ates, "live_landmarks": n_live,
        "gaps_vs_alone": gaps.tolist(), "render_s": render_s,
        "seconds": time.perf_counter() - t_phase}


def small_paths_phase(torch, dev, card, all_counts, read_counts, expect_counts):
    """Path 9: this slice's smaller paths, each with the launch counts set
    to 0 just before it and read just after; none is timed.

    - ``examples/run_stereo_track_torch.py``'s chain (LK stereo match,
      temporal LK, F-RANSAC split, PnP RANSAC on 4 frame pairs of 320x240):
      K6 and K7 once per level of each of its 12 LK calls, every solved
      frame's centre error within twice the JAX example's worst and its
      mean within twice the JAX example's mean;
    - ``vo/replay.py::replay_sequence`` on ``make_synthetic_nvm_scenario``'s
      defaults (5 frames of 256x192, through the pair tracker's CLI): K1 5
      and K2 50 per frame pair, every centre error under
      tests/test_nvm_replay.py's 0.01;
    - ``VGGFeatures`` on one 1280x720 frame and ``feature_patch_descriptors``
      at 512 points on stage 0's 32 maps: one K5 launch, equal bit for bit
      to 32 one-plane K5 calls and to the plain version;
    - a checkpoint round trip of the GT-free bootstrap engine of phase 6
      (256x192): saved after a keyframe, restored into a fresh engine, 4
      frames on, equal bit for bit to the engine run on without a pause."""
    from invcompcamtrack_torch import ICGNParams, synthetic
    from invcompcamtrack_torch.core import lie
    from invcompcamtrack_torch.core.camera import CameraPyramid
    from invcompcamtrack_torch.ops import patch_gather
    from invcompcamtrack_torch.utils import checkpoint
    from invcompcamtrack_torch.vo import engine, features_dnn, replay

    out, launches = {}, {}
    root = Path(__file__).resolve().parent

    # (a) the stereo chain of examples/run_stereo_track_torch.py
    spec = importlib.util.spec_from_file_location(
        "run_stereo_track_torch", root / "examples" / "run_stereo_track_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    reset(*all_counts)
    with contextlib.redirect_stdout(io_module.StringIO()):
        rows = example.run(dev)
    torch.cuda.synchronize()
    launches["stereo"] = read_counts()
    lk_levels = 12 * 3
    expect_counts("stereo chain (examples/run_stereo_track_torch.py)", launches["stereo"],
                  {"K6": lk_levels, "K7": lk_levels})
    errs = [r[2] for r in rows if r[2] is not None]
    print(f"[{card}] stereo chain: frames " + " | ".join(
        f"{f}: {n} tracks, centre err {e if e is None else f'{e:.4f}'}" for f, n, e, _ in rows)
        + f" (limits: each {2 * STEREO_JAX_ERR_MAX:.4f}, mean {2 * STEREO_JAX_ERR_MEAN:.4f})")
    check(len(errs) == len(rows) and max(errs) <= 2 * STEREO_JAX_ERR_MAX
          and float(np.mean(errs)) <= 2 * STEREO_JAX_ERR_MEAN,
          f"stereo chain: centre errors {errs}")
    out["stereo_center_errs"] = errs

    # (b) the NVM replay through the pair tracker's CLI (PNG files)
    check(importlib.util.find_spec("PIL") is not None,
          "the NVM replay writes and reads PNG frames: PIL is not installed")
    with tempfile.TemporaryDirectory() as tmp:
        nvm_path, paths, fc_n, cc_n, wh_n = replay.make_synthetic_nvm_scenario(
            np.random.default_rng(SEED), Path(tmp) / "scn")
        reset(*all_counts)
        _, rerr = replay.replay_sequence(nvm_path, paths, Path(tmp) / "wk", fc_n, cc_n, wh_n)
        launches["replay"] = read_counts()
    pairs = len(paths) - 1
    expect_counts(f"NVM replay ({pairs} frame pairs)", launches["replay"],
                  {"K1": 5 * pairs, "K2": 50 * pairs})
    print(f"[{card}] NVM replay, {len(paths)} frames of {wh_n[0]}x{wh_n[1]}: centre errors "
          + " ".join(f"{e:.5f}" for e in rerr) + " (limit 0.01)")
    check(rerr[0] < 1e-9 and bool(np.all(rerr[1:] < 0.01)), f"NVM replay: {rerr}")
    out["replay_center_errs"] = rerr.tolist()

    # (c) VGG features of one 1280x720 frame; descriptors on stage 0's maps
    rng = np.random.default_rng(SEED + 9)
    scene_f = synthetic.make_scene(rng, wh=(1280, 720), fc=(1000.0, 1200.0), z0=8.0)
    img_f = torch.tensor(synthetic.render(scene_f, np.eye(3, 4)), dtype=torch.float32,
                         device=dev)
    mod = features_dnn.init_features(torch.Generator().manual_seed(SEED), device=dev)
    maps = features_dnn.extract_feature_maps(mod, img_f)
    feat = maps[0].contiguous()
    C, Hf, Wf = feat.shape
    cen = torch.tensor(np.c_[rng.uniform(-2.0, Wf + 1.0, 512), rng.uniform(-2.0, Hf + 1.0, 512)],
                       dtype=torch.float32, device=dev)
    cen[:4] = torch.tensor([[0.0, 0.0], [Wf - 1.0, Hf - 1.0], [7.0, 3.0], [100.5, 50.25]],
                           device=dev)
    reset(*all_counts)
    desc = features_dnn.feature_patch_descriptors(feat, cen)
    torch.cuda.synchronize()
    launches["features"] = read_counts()
    expect_counts("feature_patch_descriptors", launches["features"], {"K5": 1})
    planes = torch.nn.functional.pad(feat[None], (8, 8, 8, 8), mode="replicate")[0].contiguous()
    one = torch.stack([patch_gather.gather_patches(planes[c].contiguous(), cen, 8, 8)
                       for c in range(C)], dim=-1)
    plain = patch_gather.gather_patches_plain(planes, cen.expand(C, -1, -1), 8, 8)
    check(tuple(desc.shape) == (512, 8, 8, C) and bool(torch.isfinite(desc).all()),
          f"descriptors: shape {tuple(desc.shape)}")
    check(bool(torch.equal(desc, one)), "descriptors: the stacked K5 launch differs from "
          f"{C} one-plane calls by {float((desc - one).abs().max())}")
    check(bool(torch.equal(desc, plain.permute(1, 2, 3, 0))),
          "descriptors: the stacked K5 launch differs from the plain version")
    print(f"[{card}] VGGFeatures on 1280x720: stages "
          + ", ".join(str(tuple(m.shape)) for m in maps) + f"; descriptors of 512 points on "
          f"{C} maps: one K5 launch, equal bit for bit to {C} one-plane calls and to the "
          "plain version")
    out["features_maps"] = [list(m.shape) for m in maps]

    # (d) a checkpoint round trip of the GT-free bootstrap engine
    rng = np.random.default_rng(0)
    scene_s = synthetic.make_scene(rng, wh=(256, 192), fc=(240.0, 245.0),
                                   freq_range=(0.8, 8.0))
    ps = [np.zeros(6)]
    for _ in range(1, 8):
        ps.append(ps[-1] + np.r_[0.02, 0.008, -0.03, rng.normal(size=3) * 0.001])
    imgs = [synthetic.render(scene_s, lie.se3_exp(torch.tensor(p, dtype=torch.float64)).numpy())
            for p in ps]
    tr_s = ICGNParams(lv_f=2, lv_l=0, psz=8, maxiter=8)
    cfg_s = engine.VOConfig(tracker=tr_s, max_landmarks=256, window=4, keyframe_stride=2,
                            corners_per_kf=256, min_parallax_px=0.5)
    cam_s = CameraPyramid.create(scene_s.fc, scene_s.cc, scene_s.wh, tr_s.num_levels,
                                 tr_s.psz)

    def fresh():
        return engine.VisualOdometry(cam_s, scene_s.fc, scene_s.cc, cfg_s)

    vo_a = fresh()
    vo_a.bootstrap_from_images(imgs[0], imgs[1])
    vo_a.process_frame(imgs[2])   # frame 2: a keyframe
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_checkpoint(Path(tmp) / "vo", checkpoint.vo_state_dict(vo_a))
        saved = checkpoint.restore_checkpoint(Path(tmp) / "vo")
    poses_a = np.stack([vo_a.process_frame(im) for im in imgs[3:7]])
    vo_b = fresh()
    checkpoint.restore_vo_state(vo_b, saved)
    poses_b = np.stack([vo_b.process_frame(im) for im in imgs[3:7]])
    check(np.array_equal(poses_a, poses_b)
          and np.array_equal(np.stack(vo_a.trajectory), np.stack(vo_b.trajectory)),
          f"checkpoint: the restored engine parts by {np.abs(poses_a - poses_b).max()}")
    print(f"[{card}] checkpoint round trip (256x192 engine, saved after the keyframe at "
          f"frame 2, {len(saved)} arrays): frames 3-6 equal bit for bit")
    out["checkpoint_arrays"] = len(saved)
    return launches, out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import invcompcamtrack_torch  # noqa: F401  (sets TF32 off)
    from invcompcamtrack_torch import ICGNParams, convert, synthetic
    from invcompcamtrack_torch.cli import track_nposes as cli_nposes
    from invcompcamtrack_torch.cli import track_pair as cli_pair
    from invcompcamtrack_torch.core import lie
    from invcompcamtrack_torch.core.camera import CameraPyramid
    from invcompcamtrack_torch.device import default_device
    from invcompcamtrack_torch.image.pyramid import PyramidLevel, build_pyramid
    from invcompcamtrack_torch.match import dense_flow, features, flow_bench, lk, track
    from invcompcamtrack_torch.ops import (_build, icgn_iter, ncc3, patch_gather,
                                           patch_prefetch, warp)
    from invcompcamtrack_torch.ops import window_sample as ws
    from invcompcamtrack_torch.solver import chain
    from invcompcamtrack_torch.solver.icgn import track_pose, track_pose_batch
    from invcompcamtrack_torch.utils import io

    dev = default_device()
    card = gpu_line()
    print(card)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernels built and loaded in {build_s:.1f} s | "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    cfg = ICGNParams(lv_f=4, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01,
                     donorm=True, dopatchnorm=False)
    psz, pad, win = cfg.psz, cfg.psz, cfg.window_size
    scene, p_gt, p2, img_ref, img_new, img_2, X = make_problem()
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, cfg.num_levels, pad)
    check(cam.fx.device.type == dev.type, "CameraPyramid.create did not default to the card")
    pyr_ref = build_pyramid(convert.tensor_from_numpy(img_ref), cfg.num_levels, pad)
    pyr_new = build_pyramid(convert.tensor_from_numpy(img_new), cfg.num_levels, pad)
    pyr_2 = build_pyramid(convert.tensor_from_numpy(img_2), cfg.num_levels, pad)
    Xd = convert.tensor_from_numpy(X)
    p0 = torch.zeros((B, 6), device=dev)
    gen = np.random.default_rng(SEED + 1)
    M = B * N

    def on_card(a):
        return convert.tensor_from_numpy(np.asarray(a, np.float32), dev)

    def level_uv(s):
        """The 25,600 projections at level s, the first 8 on the border."""
        fx, fy, cx, cy, swo, sho = (float(v) for v in cam.level(s))
        uv = torch.stack([Xd[..., 0] / Xd[..., 2] * fx + cx,
                          Xd[..., 1] / Xd[..., 2] * fy + cy], -1).reshape(-1, 2)
        border = torch.tensor([[swo, sho], [0.2, sho], [swo, 0.5 * sho], [0.0, 0.0],
                               [0.0, 0.3 * sho], [0.4 * swo, 0.0], [swo, 0.0],
                               [0.0, sho]], device=dev)
        uv[: len(border)] = border
        return uv

    # ---- phase 2: K1 vs its plain version, all 5 levels, 25,600 points
    k1_err = k9_err = 0.0
    k1_in = {}
    for s in range(cfg.num_levels):
        uv = level_uv(s)
        entry = uv + on_card(gen.uniform(-2.0, 2.0, tuple(uv.shape)))
        origins = ws.window_origin(entry, psz, win, pad)
        got = patch_gather.gather_ref_grad_windows(pyr_ref[s], pyr_new[s].img, uv,
                                                   origins, psz, pad, win)
        want = patch_gather.gather_ref_grad_windows_plain(pyr_ref[s], pyr_new[s].img,
                                                          uv, origins, psz, pad, win)
        got9 = patch_prefetch.gather_ref_grad_windows_prefetch(
            pyr_ref[s], pyr_new[s].img, uv, origins, psz, pad, win)
        torch.cuda.synchronize()
        for name, g, w, g9 in zip(("p_img", "p_dx", "p_dy", "qwin"), got, want, got9):
            err = float((g - w).abs().max())
            check(err <= (0.0 if name == "qwin" else K1_TOL),
                  f"K1 level {s} {name}: max abs err {err}")
            k1_err = max(k1_err, err)
            err9 = max(float((g9 - g).abs().max()), float((g9 - w).abs().max()))
            check(err9 <= PREFETCH_TOL, f"K9 level {s} {name}: differs from K1 or from "
                  f"its plain version by {err9} (expected bit-exact)")
            k9_err = max(k9_err, err9)
        if s == 0:
            k1_in = dict(level=pyr_ref[0], qimg=pyr_new[0].img, uv=uv,
                         origins=origins, out=got)
    print(f"K1 vs plain: 5 levels x {M} points (8 on the border each), "
          f"max abs err {k1_err} (tol {K1_TOL}, windows exact)")
    print(f"K9 vs K1 and vs plain: the same 5 levels x {M} points, max abs err {k9_err} "
          f"(tol {PREFETCH_TOL})")

    # ---- phase 3: K2 / K3 vs plain at 25,600 points, f32 and bf16 storage
    p_img, p_dx, p_dy, qwin = k1_in["out"]
    moved = k1_in["uv"] + on_card(gen.uniform(-4.5, 4.5, (M, 2)))
    row_w, col_w, wts = ws.window_taps(moved, k1_in["origins"], psz, pad, win)
    valid = on_card(gen.uniform(size=M) > 0.1)
    taps = (row_w.contiguous(), col_w.contiguous(), wts.contiguous(), valid)
    k2_in = {}
    k2_err = k3_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        planes = [a.reshape(M, -1).to(dt).contiguous() for a in (qwin, p_img, p_dx, p_dy)]
        k2_in[dt] = planes
        for pn in (False, True):
            got = icgn_iter.fused_resample_project(*planes, *taps, patch_norm=pn)
            want = icgn_iter.fused_resample_project_plain(*planes, *taps, patch_norm=pn)
            d = icgn_iter.fused_resample_pdiff_plain(*planes[:2], *taps, pn)
            scale = torch.stack([(planes[2].float() * d).abs().sum(-1),
                                 (planes[3].float() * d).abs().sum(-1)], -1)
            bad = int(((got - want).abs() > K2_RTOL * scale + 1e-6).sum())
            check(bad == 0, f"K2 {dt} patch_norm={pn}: {bad} points out of tolerance")
            k2_err = max(k2_err, float((got - want).abs().max()))
            got3 = icgn_iter.fused_resample_pdiff(*planes[:2], *taps, patch_norm=pn)
            err3 = float((got3 - d).abs().max())
            check(err3 <= (K3_TOL if pn else 0.0),
                  f"K3 {dt} patch_norm={pn}: max abs err {err3}")
            k3_err = max(k3_err, err3)
    torch.cuda.synchronize()
    print(f"K2 vs plain: {M} points, f32 and bf16, max abs err {k2_err} "
          f"(tol {K2_RTOL} x sum|p_d * pdiff|); K3 max abs err {k3_err} (tol {K3_TOL})")

    # ---- phase 3b: K4-K7 vs their plain versions, 25,600 points on level
    # 0 (border and far-outside centers included); K4 at psz 8 (the
    # verifier's), 4 and 16, K5-K7 at the three shapes: psz 8 (the
    # ``window_cache=False`` path), psz 4 on the pad-4 pyramid with 12x12
    # windows (the psz-4 path) and psz 6.  K1, K4, K5, K6 and K9 compute
    # each point's support start and weights from its centre, so they are
    # also held at the centres where the reference's rule bites
    # (EDGE_CENTERS), which stand in for points 8 onwards
    uv0 = k1_in["uv"]
    far = torch.tensor([[-50.0, -50.0], [-50.0, 3.0], [1e9, 5.0], [7.0, -1e12],
                        [1400.0, 800.0]], device=dev)
    uv0 = torch.cat([uv0[:-len(far)], far])
    img0, img1, img2 = pyr_ref[0].img, pyr_new[0].img, pyr_2[0].img
    uv_b = uv0 + on_card(gen.uniform(-1.5, 1.5, (M, 2)))
    uv_f = uv0 + on_card(gen.uniform(-1.5, 1.5, (M, 2)))
    uv_b[-len(far):] = far      # flat in all three planes: the pad corner
    uv_f[-len(far):] = far
    k4_args = (img0, img1, img2, uv_b, uv0, uv_f, psz, pad)
    n_edge = len(EDGE_CENTERS)
    edge_t = torch.tensor(EDGE_CENTERS, device=dev)
    n_nonfinite = sum(1 for c in EDGE_CENTERS if not np.isfinite(c).all())
    nonfinite = torch.zeros(M, dtype=torch.bool, device=dev)
    nonfinite[8:8 + n_edge] = ~torch.isfinite(edge_t).all(-1)

    def with_edges(uv):
        out = uv.clone()
        out[8:8 + n_edge] = edge_t
        return out

    uv_e = with_edges(uv0)
    k4_err, k4_flat = 0.0, {}
    for q in (psz, 4, 16):
        planes4 = ((img0, img1, img2) if q == psz else
                   tuple(build_pyramid(convert.tensor_from_numpy(im), 1, q)[0].img
                         for im in (img_ref, img_new, img_2)))
        uvs4 = (with_edges(uv_b), uv_e, with_edges(uv_f))
        got4 = ncc3.ncc3_scores(*planes4, *uvs4, q, q)
        want4 = ncc3.ncc3_scores_plain(*planes4, *uvs4, q, q)
        pats = [patch_gather.gather_patches_plain(im, uv, q, q, patch_norm=True)
                .reshape(M, -1) for im, uv in zip(planes4, uvs4)]
        nrm = [torch.clamp(torch.linalg.vector_norm(p, dim=-1), min=1e-15) for p in pats]
        for (a, b), g, w in zip(((0, 1), (1, 2)), got4, want4):
            # NaN exactly at the non-finite centres, in both versions
            check(bool(torch.equal(torch.isnan(g), torch.isnan(w)))
                  and bool(torch.equal(torch.isnan(g), nonfinite)),
                  f"K4 psz {q} pair {a}{b}: NaN at other places than plain or than the "
                  f"{n_nonfinite} non-finite centres")
            ok = ~nonfinite
            g, w, na, nb = g[ok], w[ok], nrm[a][ok], nrm[b][ok]
            scale = (pats[a][ok] * pats[b][ok]).abs().sum(-1) / (na * nb)
            tol = K4_RTOL * scale + 8.0 * MEAN_EPS * (1.0 / na + 1.0 / nb)
            err = (g - w).abs()
            bad = int((err > tol).sum())
            check(bad == 0, f"K4 psz {q} pair {a}{b}: {bad} points out of tolerance, "
                  f"worst {float((err - tol).max())}")
            check(bool(torch.isfinite(g).all()) and float(g.min()) >= 0.0
                  and float(g.max()) <= 1.0 + 1e-5,
                  f"K4 psz {q} pair {a}{b}: scores outside [0, 1]")
            textured = (na > 1.0) & (nb > 1.0)
            k4_err = max(k4_err, float(err[textured].max()))
        k4_flat[q] = int(((nrm[0] < 1e-3) | (nrm[1] < 1e-3) | (nrm[2] < 1e-3)).sum())
        check(k4_flat[q] >= 2, f"K4 psz {q}: only {k4_flat[q]} flat patches among the inputs")
        check(float(got4[0][-len(far):].max()) <= 1.0, f"K4 psz {q}: flat patches out of range")
    del got4, want4, pats
    print(f"K4 vs plain: {M} points x 3 planes ({n_edge} of them at EDGE_CENTERS, "
          f"{n_nonfinite} not finite: NaN in both versions), psz 8, 4 and 16 on level 0 "
          f"padded by the side (points with a flat patch: {k4_flat}), max abs err on "
          f"textured patches {k4_err} (tol {K4_RTOL} x sum|p_a p_b|/(n_a n_b) "
          f"+ {8 * MEAN_EPS:.1e} x (1/n_a + 1/n_b))")

    def exact_gap(got, want, what):
        """max |got - want| over the numbers; NaN must stand at the same
        places, and exactly at the points whose centre is not finite."""
        nan_g, nan_w = torch.isnan(got), torch.isnan(want)
        check(bool(torch.equal(nan_g, nan_w)), f"{what}: NaN at other places than plain")
        n_nan = int(nan_w.reshape(M, -1).any(-1).sum())
        check(n_nan == n_nonfinite, f"{what}: {n_nan} NaN points, not {n_nonfinite}")
        return float((torch.nan_to_num(got) - torch.nan_to_num(want)).abs().max())

    # K1 and K9 at the edge centres, with and without the patch mean: bit
    # for bit with the plain version and with each other
    origins_e = ws.window_origin(uv_e + on_card(gen.uniform(-2.0, 2.0, (M, 2))), psz,
                                 win, pad)
    for pn in (False, True):
        e_args = (pyr_ref[0], pyr_new[0].img, uv_e, origins_e, psz, pad, win, pn)
        g1 = patch_gather.gather_ref_grad_windows(*e_args)
        w1 = patch_gather.gather_ref_grad_windows_plain(*e_args)
        g9 = patch_prefetch.gather_ref_grad_windows_prefetch(*e_args)
        for part, a, b, c9 in zip(("p_img", "p_dx", "p_dy"), g1, w1, g9):
            err = exact_gap(a, b, f"K1 at EDGE_CENTERS, patch_norm={pn}, {part}")
            err9 = max(exact_gap(c9, a, f"K9 vs K1 at EDGE_CENTERS, {part}"),
                       exact_gap(c9, b, f"K9 at EDGE_CENTERS, {part}"))
            check(err == 0.0 and err9 == 0.0, f"K1 / K9 at EDGE_CENTERS, patch_norm={pn}, "
                  f"{part}: max abs err {err} / {err9} (expected bit-exact)")
        check(bool(torch.equal(g1[3], w1[3])) and bool(torch.equal(g9[3], w1[3])),
              "K1 / K9 at EDGE_CENTERS: windows differ from the plain version's")
    del g1, w1, g9
    torch.cuda.synchronize()
    print(f"K1, K9 vs plain and K9 vs K1 at level 0, {M} points ({n_edge} of them at "
          f"EDGE_CENTERS), with and without the patch mean: 0.0, NaN exactly at the "
          f"{n_nonfinite} points whose centre is not finite")

    gather_err = {"K5": 0.0, "K6": 0.0, "K7": 0.0}
    gather_in = {}
    for q in (psz, 4, 6, 16, 18, 20, 32):
        lvl = (pyr_ref[0] if q == psz
               else build_pyramid(convert.tensor_from_numpy(img_ref), 1, q)[0])
        for pn in (False, True):
            g5 = patch_gather.gather_patches(lvl.img, uv_e, q, q, pn)
            w5 = patch_gather.gather_patches_plain(lvl.img, uv_e, q, q, pn)
            gather_err["K5"] = max(gather_err["K5"], exact_gap(g5, w5, f"K5 psz {q}"))
            if q > patch_gather.MAX_PSZ:
                continue
            g6 = patch_gather.gather_patches_grad(lvl.img, lvl.dx, lvl.dy, uv_e, q, q, pn)
            w6 = patch_gather.gather_patches_grad_plain(lvl.img, lvl.dx, lvl.dy, uv_e,
                                                        q, q, pn)
            gather_err["K6"] = max(gather_err["K6"], *(
                exact_gap(a, b, f"K6 psz {q} {part}")
                for a, b, part in zip(g6, w6, ("p_img", "p_dx", "p_dy"))))
        gather_in[q] = dict(lvl=lvl)
        if q not in (psz, 4, 6):
            continue
        origins_q = ws.window_origin(uv0 + on_card(gen.uniform(-2.0, 2.0, (M, 2))),
                                     q, q + 8, q)
        g7 = patch_gather.gather_windows(lvl.img, origins_q, q + 8, q + 8)
        w7 = patch_gather.gather_windows_plain(lvl.img, origins_q, q + 8, q + 8)
        gather_err["K7"] = max(gather_err["K7"], float((g7 - w7).abs().max()))
        gather_in[q].update(origins=origins_q, windows=w7)
    del g5, w5, g6, w6
    torch.cuda.synchronize()
    for k, err in gather_err.items():
        check(err <= GATHER_TOL, f"{k} vs plain: max abs err {err} (expected bit-exact)")
    print(f"K5, K6, K7 vs plain: {M} points ({len(EDGE_CENTERS)} of them on, just below "
          f"and just above integers, at negative fractions and not finite for K5 and K6), "
          f"psz 8, 4 (pad 4, 12x12 windows), 6 and 16 (K5, K6), K5 also at psz 18, 20 and "
          f"32, with and without the patch mean, max abs err {gather_err} (tol {GATHER_TOL}; NaN "
          f"exactly at the {n_nonfinite} points whose centre is not finite)")

    # K1, K9, K5, K6 and K7 on a stack of P_STACK planes (the multi-stream
    # engine's call: each stream's keyframe and frame, one launch for all),
    # at the engine's shapes (psz 8, 16x16 windows), the M points in P_STACK
    # groups with the edge centres among them: against the plain version,
    # exactly as on one plane, and against P_STACK calls on one plane each,
    # bit for bit
    stack_in = torch.stack([convert.tensor_from_numpy(im) for im in
                            (img_ref, img_new, img_2, np.ascontiguousarray(img_ref[:, ::-1]))])
    check(len(stack_in) == P_STACK, "the plane stack")
    lvl_st = build_pyramid(stack_in, 1, pad)[0]
    q_st = lvl_st.img.flip(0).contiguous()      # each plane's query: another plane
    uv_st = uv_e.reshape(P_STACK, -1, 2)
    or_st = origins_e.reshape(P_STACK, -1, 2)

    def plane(p):
        return PyramidLevel(*(a[p] for a in lvl_st))

    stack_calls = {
        "K1": lambda pn, p=None: (
            patch_gather.gather_ref_grad_windows(lvl_st, q_st, uv_st, or_st, psz, pad, win, pn)
            if p is None else patch_gather.gather_ref_grad_windows(
                plane(p), q_st[p], uv_st[p], or_st[p], psz, pad, win, pn)),
        "K9": lambda pn, p=None: (
            patch_prefetch.gather_ref_grad_windows_prefetch(lvl_st, q_st, uv_st, or_st, psz,
                                                            pad, win, pn)
            if p is None else patch_prefetch.gather_ref_grad_windows_prefetch(
                plane(p), q_st[p], uv_st[p], or_st[p], psz, pad, win, pn)),
        "K5": lambda pn, p=None: (patch_gather.gather_patches(lvl_st.img, uv_st, psz, pad, pn)
                                  if p is None else patch_gather.gather_patches(
                                      lvl_st.img[p], uv_st[p], psz, pad, pn)),
        "K6": lambda pn, p=None: (
            patch_gather.gather_patches_grad(lvl_st.img, lvl_st.dx, lvl_st.dy, uv_st, psz,
                                             pad, pn)
            if p is None else patch_gather.gather_patches_grad(
                lvl_st.img[p], lvl_st.dx[p], lvl_st.dy[p], uv_st[p], psz, pad, pn)),
        "K7": lambda pn, p=None: (patch_gather.gather_windows(lvl_st.img, or_st, win, win)
                                  if p is None else patch_gather.gather_windows(
                                      lvl_st.img[p], or_st[p], win, win)),
    }
    stack_plain = {
        "K1": lambda pn: patch_gather.gather_ref_grad_windows_plain(
            lvl_st, q_st, uv_st, or_st, psz, pad, win, pn),
        "K5": lambda pn: patch_gather.gather_patches_plain(lvl_st.img, uv_st, psz, pad, pn),
        "K6": lambda pn: patch_gather.gather_patches_grad_plain(
            lvl_st.img, lvl_st.dx, lvl_st.dy, uv_st, psz, pad, pn),
        "K7": lambda pn: patch_gather.gather_windows_plain(lvl_st.img, or_st, win, win),
    }
    stack_plain["K9"] = stack_plain["K1"]
    stack_err = {}
    for k, call in stack_calls.items():
        stack_err[k] = 0.0
        for pn in ((False,) if k == "K7" else (False, True)):
            got, want = call(pn), stack_plain[k](pn)
            got, want = ((got,), (want,)) if k in ("K5", "K7") else (got, want)
            for part, (g, w) in enumerate(zip(got, want)):
                err = (float((g - w).abs().max()) if k == "K7" or part == 3
                       else exact_gap(g, w, f"{k} on {P_STACK} planes, part {part}"))
                stack_err[k] = max(stack_err[k], err)
                for p in range(P_STACK):
                    one = call(pn, p)
                    one = one[part] if isinstance(one, tuple) else one
                    check(bool(torch.equal(torch.nan_to_num(g[p]), torch.nan_to_num(one)))
                          and bool(torch.equal(torch.isnan(g[p]), torch.isnan(one))),
                          f"{k} on {P_STACK} planes, plane {p}, part {part}, patch_norm={pn}: "
                          f"differs from the call on that plane alone")
    torch.cuda.synchronize()
    for k, err in stack_err.items():
        check(err == 0.0, f"{k} on {P_STACK} planes vs plain: max abs err {err} (expected "
              f"bit-exact)")
    print(f"K1, K9, K5, K6, K7 on a stack of {P_STACK} planes (level 0, {M // P_STACK} points "
          f"per plane, the edge centres among them; psz 8, 16x16 windows), with and without "
          f"the patch mean: vs plain {stack_err} (tol 0.0), and equal bit for bit to "
          f"{P_STACK} calls on one plane each")

    # K7 at every square side it is compiled for (psz + 8 of every even psz
    # up to 16) and at two sides given at run time, on level 0 and on the
    # plane stack, with origins beyond every border and corner and a number
    # of windows that leaves a ragged last run: bit for bit, one launch each
    k7_sides = [(q, q) for q in range(10, 25, 2)] + [(3, 16), (16, 5)]
    Hs, Ws = lvl_st.img.shape[-2:]
    m7 = M - 3
    gen7 = np.random.default_rng(SEED + 7)
    o7 = np.c_[gen7.integers(-40, Hs + 40, m7), gen7.integers(-40, Ws + 40, m7)]
    o7[:8] = [[-1, 5], [-60, -60], [Hs, 3], [Hs + 60, Ws + 60], [7, -1], [9, Ws],
              [-5, Ws + 9], [Hs - 9, Ws - 9]]
    o7 = torch.tensor(o7.astype(np.int32), device=dev)
    per7 = m7 // P_STACK
    k7_in = {"plane": (lvl_st.img[0], o7),
             "stack": (lvl_st.img, o7[:P_STACK * per7].reshape(P_STACK, per7, 2))}
    k7_side_err = {}
    for where, (img7, org7) in k7_in.items():
        for wh, ww in k7_sides:
            n7 = patch_gather.launches["gather_windows"]
            got = patch_gather.gather_windows(img7, org7, wh, ww)
            check(patch_gather.launches["gather_windows"] == n7 + 1,
                  f"K7 {wh}x{ww} on the {where}: not one launch")
            want = patch_gather.gather_windows_plain(img7, org7, wh, ww)
            err = float((got - want).abs().max())
            check(bool(torch.equal(got, want)), f"K7 {wh}x{ww} on the {where} vs plain: "
                  f"max abs err {err} (expected bit-exact)")
            k7_side_err[f"{where} {wh}x{ww}"] = err
    del got, want
    print(f"K7 vs plain at {', '.join(f'{a}x{b}' for a, b in k7_sides)} on level 0 "
          f"({m7} windows) and on the {P_STACK}-plane stack ({P_STACK} x {per7}), origins "
          f"beyond every border and corner: max abs err "
          f"{max(k7_side_err.values())} (tol 0.0), one launch per call")
    k7_stack = (lvl_st.img, or_st[:, :K7_ENGINE_POINTS].contiguous())
    del lvl_st, q_st, stack_in

    # ---- phase 3c: K8 vs its plain version at 1280x720 and at the
    # coarsest level's 45x80: (a) a smooth flow, (b) a 10 px step across
    # an (8, 128) tile, where the TPU kernel clamps, (c) flow that leaves
    # the image on every side, (d) integer flow, (e) infinite and NaN flow
    def test_flows(H, W):
        yy, xx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                                torch.arange(W, device=dev, dtype=torch.float32),
                                indexing="ij")
        smooth = torch.stack([1.3 * torch.sin(yy / 17.0) + 0.7 * torch.cos(xx / 43.0) + 4.0,
                              1.1 * torch.cos(yy / 13.0) - 0.9 * torch.sin(xx / 39.0) - 6.0],
                             dim=-1)
        step = smooth.clone()
        step[:, W // 2 + 5:, 0] += 10.0
        leaves = smooth.clone()
        leaves[:6] -= 40.0
        leaves[-6:] += 55.0
        leaves[:, :5, 0] -= 300.0
        leaves[:, -5:, 0] += 1e6
        integer = torch.zeros_like(smooth)
        integer[..., 0], integer[..., 1] = 3.0, -2.0
        nonfinite = smooth.clone()
        nonfinite[3, 4, 0] = float("inf")
        nonfinite[5, 6, 1] = float("-inf")
        nonfinite[7, 8, 0] = float("nan")
        return dict(smooth=smooth, step=step, leaves=leaves, integer=integer,
                    nonfinite=nonfinite)

    k8_err = 0.0
    for s_lvl in (0, cfg.lv_f):
        plane = pyr_new[s_lvl].img[pad:-pad, pad:-pad]
        Hs, Ws = plane.shape
        for kind, fl in test_flows(Hs, Ws).items():
            g8 = warp.warp_image(plane, fl)
            w8 = warp.warp_image_plain(plane, fl)
            check(bool(torch.equal(torch.isnan(g8), torch.isnan(w8))),
                  f"K8 {Hs}x{Ws} {kind}: NaN pixels differ")
            check(int(torch.isnan(w8).sum()) == (1 if kind == "nonfinite" else 0),
                  f"K8 {Hs}x{Ws} {kind}: unexpected NaN pixels")
            err = float(torch.nan_to_num(g8 - w8, nan=0.0).abs().max())
            check(err <= WARP_TOL, f"K8 {Hs}x{Ws} {kind}: max abs err {err} "
                  f"(expected bit-exact)")
            k8_err = max(k8_err, err)
    torch.cuda.synchronize()
    print(f"K8 vs plain: 720x1280 and {Hs}x{Ws}, smooth / step / leaving the image / "
          f"integer / non-finite flow, max abs err {k8_err} (tol {WARP_TOL})")

    # ---- phase 4: main path 1, counts set to 0 just before it
    all_counts = (patch_gather.launches, icgn_iter.launches, ncc3.launches,
                  warp.launches, patch_prefetch.launches)

    def read_counts():
        return {"K1": patch_gather.launches["gather_ref_grad_windows"],
                "K2": icgn_iter.launches["project"], "K3": icgn_iter.launches["pdiff"],
                "K4": ncc3.launches["ncc3_scores"],
                "K5": patch_gather.launches["gather_patches"],
                "K6": patch_gather.launches["gather_patches_grad"],
                "K7": patch_gather.launches["gather_windows"],
                "K8": warp.launches["warp_image"],
                "K9": patch_prefetch.launches["gather_ref_grad_windows_prefetch"]}

    def expect_counts(path, got, want):
        print(f"{path} launches: {got}")
        for k, n in got.items():
            check(n == want.get(k, 0), f"{path}: {k} launched {n} times, not {want.get(k, 0)}")

    reset(*all_counts)
    p_out = track_pose_batch(pyr_ref, pyr_new, Xd, p0, cam, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts("main path (track_pose_batch)", launches,
                  {"K1": cfg.num_levels, "K2": cfg.num_levels * cfg.maxiter})
    check(bool(torch.isfinite(p_out).all()), "non-finite poses")
    c_gt = lie.camera_center(lie.se3_exp(torch.tensor(p_gt, dtype=torch.float32,
                                                      device=dev)))

    def center_err(p):
        return (lie.camera_center(lie.se3_exp(p)) - c_gt).norm(dim=-1)

    err = center_err(p_out)
    med_err = float(err.median())
    print(f"median camera-centre error {med_err:.6f} (limit 0.05), max {float(err.max()):.6f}")
    check(med_err < 0.05, f"median camera-centre error {med_err}")

    # the port's CPU run (plain versions) of the first 16 problems
    n_ref = 16
    cpu_cam = cam.to("cpu")
    cpu_ref = build_pyramid(torch.from_numpy(img_ref), cfg.num_levels, pad)
    cpu_new = build_pyramid(torch.from_numpy(img_new), cfg.num_levels, pad)
    p_cpu = track_pose_batch(cpu_ref, cpu_new, torch.from_numpy(X[:n_ref]),
                             torch.zeros((n_ref, 6)), cpu_cam, cfg)
    pose_err = float((p_out[:n_ref].cpu() - p_cpu).abs().max())
    print(f"card vs CPU (plain versions), first {n_ref} poses: max abs err {pose_err} "
          f"(tol {POSE_TOL})")
    check(pose_err <= POSE_TOL, f"card vs CPU poses differ by {pose_err}")

    def card_vs_cpu(name, card_args, cpu_args, c, mask=None):
        """One tracker call, (pyr_a, pyr_b, X, p_init, cam), on the card and
        on the CPU, and on the CPU once more from initial poses moved by
        1e-7 (see REPRO_TOL's note) -> the readings, and the two poses."""
        m_cpu = None if mask is None else torch.from_numpy(mask)
        m_card = None if mask is None else m_cpu.to(dev)
        p_card, aux_card = track_pose(*card_args, c, point_mask=m_card, return_aux=True)
        p_host = track_pose(*cpu_args, c, point_mask=m_cpu)
        p_card = p_card.cpu()
        check(bool(torch.isfinite(aux_card.hessian).all())
              and bool(torch.isfinite(aux_card.normdp).all()), f"{name}: non-finite aux")
        gaps = (p_card - p_host).abs().amax(-1)
        apart = held_to_repro(name, gaps)
        moved = cpu_args[3] + 1e-7 * torch.randn(cpu_args[3].shape,
                                                 generator=torch.Generator().manual_seed(SEED))
        own = (track_pose(*cpu_args[:3], moved, cpu_args[4], c, point_mask=m_cpu)
               - p_host).abs().amax(-1)
        print(f"{name}: card vs CPU, {len(gaps)} poses: {float(gaps.max())}, median "
              f"{float(gaps.median())} ({apart} lanes beyond {POSE_TOL}; limits "
              f"{REPRO_TOL}, median {POSE_TOL / 10}, a quarter of the lanes); CPU vs CPU "
              f"from initial poses 1e-7 apart: {float(own.max())}, median "
              f"{float(own.median())} ({int((own > POSE_TOL).sum())} lanes beyond "
              f"{POSE_TOL})")
        return ({"cpu_pose_err": float(gaps.max()), "cpu_pose_err_median": float(gaps.median()),
                 "lanes_apart": apart, "cpu_vs_moved_cpu_pose_err": float(own.max())},
                p_card, p_host)

    # ---- phase 4b: main path 2, the verifier through its CLI's run().
    # Frame 1 (pose p_gt) is the reference frame; hypotheses: p_gt with
    # small seeded perturbations, the last S_WRONG catastrophically wrong
    # (on a plane a mildly wrong pose is homography-consistent).
    S = B
    hyp = p_gt + np.c_[gen.normal(size=(S, 3)) * 5e-4, gen.normal(size=(S, 3)) * 2e-4]
    hyp[0] = p_gt
    wrong = np.array([0.6, -0.5, 0.3, 0.25, -0.2, 0.15])
    hyp[S - S_WRONG:] = p_gt + wrong * gen.choice([-1.0, 1.0], size=(S_WRONG, 6))
    masks = gen.uniform(size=(S, N)) < 0.8
    masks[:, :8] = True
    pt3d = X[0].astype(np.float64)
    fxy, cxy = np.asarray(scene.fc), np.asarray(scene.cc)
    G1 = lie.se3_exp(torch.tensor(p_gt, dtype=torch.float64)).numpy()
    Xc = pt3d @ G1[:, :3].T + G1[:, 3]
    pt2d = Xc[:, :2] / Xc[:, 2:] * fxy + cxy
    frames = [img_ref, img_new, img_2]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        names = [str(tmp / f"frame{i}.png") for i in range(3)]
        io.write_nposes_input(tmp / "in.txt", io.NPosesInput(
            params=dict(lv_f=cfg.lv_f, lv_l=cfg.lv_l, psz=cfg.psz, maxiter=cfg.maxiter,
                        normdp_ratio=cfg.normdp_ratio, donorm=1, dopatchnorm=0,
                        maxpttrack=N, verbosity=0),
            fc=fxy, cc=cxy, wh=np.asarray(scene.wh), fb_frames=(1, 1), filenames=names,
            pt2d=pt2d, pt3d=pt3d, poses=hyp,
            inlier_ids=[np.flatnonzero(m) + 1 for m in masks]))
        data = io.read_nposes_input(tmp / "in.txt")
        check(data.poses.shape == (S, 6) and len(data.inlier_ids) == S
              and data.fb_frames == (1, 1), "the verifier's input did not read back")
        reset(*all_counts)
        tracks, corr_rows, res = cli_nposes.run(data, frames)   # on the card
        torch.cuda.synchronize()
        v_launches = read_counts()
        io.write_nposes_result(tmp / "out.txt", tracks, corr_rows)
        tracks_f, corr_f = io.read_nposes_result(tmp / "out.txt", num_images=3)

        # main(argv) itself needs an image decoder for its PNG files
        have_pil = importlib.util.find_spec("PIL") is not None
        if have_pil:
            import PIL

            from invcompcamtrack_torch.utils import image

            for name, im in zip(names, frames):
                image.save_gray(name, im)
            rc = cli_nposes.main([str(tmp / "in.txt"), str(tmp / "out_main.txt")])
            check(rc == 0, f"cli.track_nposes.main returned {rc}")
            tracks_m, corr_m = io.read_nposes_result(tmp / "out_main.txt", num_images=3)
            mean_m = np.array([c.mean() for c in corr_m])
            check(tracks_m.shape == (S, 3, 6) and bool(np.isfinite(tracks_m).all()),
                  "main(argv): malformed result file")
            check(mean_m[:S - S_WRONG].min() > 0.8
                  and mean_m[:S - S_WRONG].min() > mean_m[S - S_WRONG:].max(),
                  "main(argv) on PNG files: a wrong hypothesis verified")
            print(f"verifier main(argv) on PNG files (PIL {PIL.__version__}): near-true "
                  f"mean corr >= {mean_m[:S - S_WRONG].min():.4f}, wrong <= "
                  f"{mean_m[S - S_WRONG:].max():.4f}")
        else:
            print("verifier main(argv): PIL is not installed here; run() was driven "
                  "with the rendered arrays instead")
    expect_counts("verifier (cli.track_nposes.run)", v_launches,
                  {"K1": 2 * cfg.num_levels, "K2": 2 * cfg.num_levels * cfg.maxiter,
                   "K4": 1})
    check(tuple(res.pose_tracks.shape) == (S, 3, 6)
          and bool(torch.isfinite(res.pose_tracks).all()), "verifier: bad pose_tracks")
    check(tracks_f.shape == (S, 3, 6) and [len(c) for c in corr_f] == list(masks.sum(1)),
          "verifier: the result file did not read back")
    check(float(np.abs(tracks_f - tracks).max()) < 1e-6, "verifier: result file poses")
    mean_corr = res.mean_corr.cpu().numpy()
    near, bad_h = mean_corr[:S - S_WRONG], mean_corr[S - S_WRONG:]
    print(f"verifier: near-true mean corr in [{near.min():.4f}, {near.max():.4f}], "
          f"wrong in [{bad_h.min():.4f}, {bad_h.max():.4f}]")
    check(near.min() > 0.8, f"verifier: a near-true hypothesis scored {near.min()}")
    check(near.min() > bad_h.max(), "verifier: a wrong hypothesis beat a near-true one")
    best, best_score = chain.select_best(res, torch.ones(S, dtype=torch.bool, device=dev))
    check(int(best) < S - S_WRONG, f"select_best picked wrong hypothesis {int(best)}")
    c2 = lie.camera_center(lie.se3_exp(torch.tensor(p2, dtype=torch.float32, device=dev)))
    fwd = (lie.camera_center(lie.se3_exp(res.pose_tracks[:S - S_WRONG, 2])) - c2).norm(dim=-1)
    back = lie.camera_center(lie.se3_exp(res.pose_tracks[:S - S_WRONG, 0])).norm(dim=-1)
    print(f"verifier chains: median camera-centre error fwd {float(fwd.median()):.6f}, "
          f"back {float(back.median()):.6f} (limit 0.05)")
    check(float(fwd.median()) < 0.05 and float(back.median()) < 0.05,
          "verifier: a chain did not reach its frame")
    # card vs the port's CPU run of the first 16 hypotheses: the CLI's
    # run() on both, and each chain as the direct tracker call it is
    cpu_2 = build_pyramid(torch.from_numpy(img_2), cfg.num_levels, pad)
    data16 = io.NPosesInput(**{**data.__dict__, "poses": data.poses[:n_ref],
                               "inlier_ids": data.inlier_ids[:n_ref]})
    tracks16, _, res16 = cli_nposes.run(data16, frames)
    tracks_c, _, res_c = cli_nposes.run(data16, frames, device="cpu")
    X16 = np.broadcast_to(data.pt3d.astype(np.float32), (n_ref, N, 3)).copy()
    hyp16 = data.poses[:n_ref].astype(np.float32)
    v_cmp = {}
    for chain_name, frame, to_card, to_cpu in (("forward", 2, pyr_2, cpu_2),
                                               ("backward", 0, pyr_ref, cpu_ref)):
        v_cmp[chain_name], p_card, p_host = card_vs_cpu(
            f"verifier {chain_name} chain",
            (pyr_new, to_card, on_card(X16), on_card(hyp16), cam),
            (cpu_new, to_cpu, torch.from_numpy(X16), torch.from_numpy(hyp16), cpu_cam),
            cfg, masks[:n_ref])
        tie = max(float(np.abs(p_card.numpy() - tracks16[:, frame]).max()),
                  float(np.abs(p_host.numpy() - tracks_c[:, frame]).max()))
        check(tie <= TIE_TOL, f"verifier {chain_name} chain: the CLI's poses differ from "
              f"the direct tracker call by {tie}")
    v_pose_err = float(np.abs(tracks16 - tracks_c).max())
    v_corr_err = float((res16.correlations.cpu() - res_c.correlations).abs().max())
    print(f"verifier card vs CPU, first {n_ref} hypotheses through the CLI: poses "
          f"{v_pose_err} (each chain held above), correlations {v_corr_err} (tol "
          f"{CORR_TOL}); the S={S} run's first {n_ref} poses vs the CPU's: "
          f"{float(np.abs(tracks[:n_ref] - tracks_c).max())}")
    check(v_corr_err <= CORR_TOL, f"verifier card vs CPU correlations differ by {v_corr_err}")
    check(bool(((res16.correlations.cpu() == -1) == (res_c.correlations == -1)).all()),
          "verifier card vs CPU: the -1 entries differ")

    # ---- phase 4c: main path 3, the non-fused tracker at B=256 x N=100
    nf_launches, nf_med, nf_cmp = {}, {}, {}
    nf_cases = {
        "psz4": (ICGNParams(lv_f=4, lv_l=0, psz=4, maxiter=10, normdp_ratio=0.01),
                 {"K6": 5, "K7": 5}),
        "psz8_nocache": (ICGNParams(lv_f=4, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01,
                                    window_cache=False), {"K6": 5, "K5": 50}),
    }
    nf_calls = {}
    for name, (c, want) in nf_cases.items():
        cam_c = CameraPyramid.create(scene.fc, scene.cc, scene.wh, c.num_levels, c.psz)
        pr = build_pyramid(convert.tensor_from_numpy(img_ref), c.num_levels, c.psz)
        pn_ = build_pyramid(convert.tensor_from_numpy(img_new), c.num_levels, c.psz)
        reset(*all_counts)
        p_nf = track_pose_batch(pr, pn_, Xd, p0, cam_c, c)
        torch.cuda.synchronize()
        nf_launches[name] = read_counts()
        expect_counts(f"non-fused tracker ({name})", nf_launches[name], want)
        check(bool(torch.isfinite(p_nf).all()), f"{name}: non-finite poses")
        nf_med[name] = float(center_err(p_nf).median())
        check(nf_med[name] < 0.05, f"{name}: median camera-centre error {nf_med[name]}")
        print(f"non-fused tracker ({name}): median camera-centre error "
              f"{nf_med[name]:.6f} (limit 0.05)")
        nf_cmp[name], _, _ = card_vs_cpu(
            f"non-fused tracker ({name})",
            (pr, pn_, Xd[:n_ref], p0[:n_ref], cam_c),
            (build_pyramid(torch.from_numpy(img_ref), c.num_levels, c.psz),
             build_pyramid(torch.from_numpy(img_new), c.num_levels, c.psz),
             torch.from_numpy(X[:n_ref]), torch.zeros((n_ref, 6)), cam_c.to("cpu")), c)
        nf_calls[name] = (lambda pr=pr, pn_=pn_, cam_c=cam_c, c=c:
                          track_pose_batch(pr, pn_, Xd, p0, cam_c, c))

    # ---- phase 4d: main path 4, the pair tracker through its CLI's run():
    # problem 0 (N points) from a point+camera file, verbosity 2 for the
    # per-scale lines of ICGNAux, at psz 8 (fused) and psz 4 (non-fused)
    pair_out = {}
    with tempfile.TemporaryDirectory() as tmp:
        io.write_pointcam(Path(tmp) / "pair.bin", io.PointCamFile(
            pose=np.zeros(6), fc=np.asarray(scene.fc, np.float32),
            cc=np.asarray(scene.cc, np.float32), wh=np.asarray(scene.wh, np.uint32),
            pt3d=X[0].astype(np.float64), pt2d=np.zeros((N, 2), np.float32)))
        pair_data = io.read_pointcam(Path(tmp) / "pair.bin")
    check(pair_data.pt3d.shape == (N, 3), "the pair tracker's input did not read back")

    def pair_run(argv, device):
        """run() with its per-scale lines parsed: pose (6,), |dp| per scale."""
        out = io_module.StringIO()
        with contextlib.redirect_stdout(out):
            pose = cli_pair.run(cli_pair.parse_cfg(argv), pair_data, [img_ref, img_new],
                                device)
        scales = [ln for ln in out.getvalue().splitlines() if ": iters " in ln]
        return pose, [float(ln.split("|dp| ")[1]) for ln in scales]

    for name, q, want in (("psz8", 8, {"K1": 5, "K2": 50}), ("psz4", 4, {"K6": 5, "K7": 5})):
        argv = ["4", "0", str(q), "10", "0.01", "1", "0", str(N), "2"]
        reset(*all_counts)
        pose_card, ndp_card = pair_run(argv, None)      # on the card
        torch.cuda.synchronize()
        pair_launches = read_counts()
        expect_counts(f"pair tracker (cli.track_pair.run, {name})", pair_launches, want)
        check(pose_card.shape == (6,) and pose_card.dtype == np.float64
              and bool(np.isfinite(pose_card).all()), f"pair tracker {name}: bad pose")
        check(len(ndp_card) == 5 and bool(np.isfinite(ndp_card).all()),
              f"pair tracker {name}: per-scale lines {ndp_card}")
        pair_center = float(center_err(on_card(pose_card)))
        check(pair_center < 0.05, f"pair tracker {name}: camera-centre error {pair_center}")
        pose_host, _ = pair_run(argv, "cpu")
        pair_gap = float(np.abs(pose_card - pose_host).max())
        print(f"pair tracker ({name}): camera-centre error {pair_center:.6f} (limit 0.05); "
              f"card vs CPU {pair_gap} (limit {REPRO_TOL})")
        check(pair_gap <= REPRO_TOL,
              f"pair tracker {name}: card vs CPU poses differ by {pair_gap}")
        pair_out[name] = {"launches": pair_launches, "center_err": pair_center,
                          "cpu_pose_err": pair_gap}

    # ---- phase 4e: main path 5a, the optical-flow point tracker: the loop
    # of examples/run_of_point_track.py on a 6-frame clip of the tracker's
    # scene at 1280x720 with the example's pose steps
    FL, fpad, f_iters, n_corners, n_frames = 5, 8, 4, 1000, 6
    rng_clip = np.random.default_rng(SEED + 3)
    p_clip, clip, clip_G = np.zeros(6), [], []
    for _ in range(n_frames):
        clip_G.append(lie.se3_exp(torch.tensor(p_clip, dtype=torch.float64)).numpy())
        clip.append(synthetic.render(scene, clip_G[-1]).astype(np.float32))
        p_clip = p_clip + np.r_[0.01, 0.004, 0.004, rng_clip.normal(size=3) * 0.001]
    Hc, Wc = clip[0].shape

    def flow_pair(pa, pb):
        return (dense_flow.dense_flow_lk(pa, pb, fpad, iters=f_iters, radius=4),
                dense_flow.dense_flow_lk(pb, pa, fpad, iters=f_iters, radius=4))

    def corners_of(pyr):
        return features.shi_tomasi_corners(pyr[0].img[fpad:-fpad, fpad:-fpad],
                                           max_corners=n_corners, border=fpad)

    def in_frame(gt):
        yy, xx = np.mgrid[0:Hc, 0:Wc]
        tx, ty = xx + gt[..., 0], yy + gt[..., 1]
        return (tx >= 0) & (tx < Wc) & (ty >= 0) & (ty < Hc)

    clip_pyrs = [build_pyramid(convert.tensor_from_numpy(f), FL, fpad) for f in clip]
    table = track.make_track_table(n_corners, window=6)
    check(table.xy.device.type == dev.type, "make_track_table did not default to the card")
    track_rows, flow_01, corners_1 = [], None, None
    for i in range(n_frames - 1):
        reset(*all_counts)
        flow_f, flow_b = flow_pair(clip_pyrs[i], clip_pyrs[i + 1])
        xy_c, ok_c = corners_of(clip_pyrs[i + 1])
        seeded_before = int(table.alive.sum())
        table = track.advance_tracks(table, flow_f, flow_b, xy_c, ok_c)
        pairs_t, pairs_ok = track.point_pairs(table)
        torch.cuda.synchronize()
        pt_launches = read_counts()
        expect_counts(f"point tracker, frame pair {i}", pt_launches,
                      {"K8": 2 * FL * f_iters})
        check(tuple(flow_f.shape) == (Hc, Wc, 2) and bool(torch.isfinite(flow_f).all())
              and bool(torch.isfinite(flow_b).all()), f"frame pair {i}: bad flow")
        gt = flow_bench.plane_gt_flow(scene, clip_G[i], clip_G[i + 1])
        epe = np.linalg.norm(flow_f.cpu().numpy() - gt, axis=-1)
        med_epe = float(np.median(epe[in_frame(gt)]))
        check(med_epe < EPE_LIMIT, f"frame pair {i}: median EPE {med_epe} px")
        n_pairs = int(pairs_ok.sum())
        row = {"median_epe": med_epe, "corners": int(ok_c.sum()),
               "live": int(table.alive.sum()), "pairs": n_pairs}
        if n_pairs:
            prev = pairs_t[pairs_ok][:, 0].cpu().numpy()
            step = pairs_t[pairs_ok][:, 1].cpu().numpy() - prev
            gt_at = gt[np.round(prev[:, 1]).astype(int), np.round(prev[:, 0]).astype(int)]
            row["median_step"] = float(np.median(np.linalg.norm(step, axis=1)))
            row["median_step_err"] = float(np.median(np.linalg.norm(step - gt_at, axis=1)))
            check(row["median_step_err"] < STEP_TOL, f"frame pair {i}: verified pairs "
                  f"miss the analytic flow by {row['median_step_err']} px at the median")
        if i == 0:
            flow_01, corners_1 = flow_f, (xy_c, ok_c)
            check(n_pairs == 0 and row["live"] == row["corners"] >= n_corners // 2,
                  f"frame pair 0: {row}")
        if i == 1:
            check(n_pairs >= PAIRS_SHARE * seeded_before, f"frame pair 1: {n_pairs} "
                  f"verified pairs of {seeded_before} seeded tracks")
        track_rows.append(row)
        print(f"point tracker, frame pair {i}: {row}")
    check(int(table.frame) == n_frames - 1, "the track table lost count of its frames")

    # the forward flow of pair 0 on the card vs the port's CPU run
    cpu_flow = dense_flow.dense_flow_lk(build_pyramid(torch.from_numpy(clip[0]), FL, fpad),
                                        build_pyramid(torch.from_numpy(clip[1]), FL, fpad),
                                        fpad, iters=f_iters, radius=4)
    flow_gap = (flow_01.cpu() - cpu_flow).abs().amax(-1).flatten()
    flow_gap_999 = float(torch.quantile(flow_gap[::7], 0.999))
    print(f"dense flow, card vs CPU, one {Wc}x{Hc} pair: median {float(flow_gap.median())} "
          f"px (tol {FLOW_MEDIAN_TOL}), 99.9 % within {flow_gap_999} px (tol {FLOW_TOL}), "
          f"max {float(flow_gap.max())} px")
    check(float(flow_gap.median()) <= FLOW_MEDIAN_TOL and flow_gap_999 <= FLOW_TOL,
          "dense flow: card vs CPU out of tolerance")

    # ---- phase 4f: main path 5b, sparse LK with the forward/backward gate
    # on the clip's first pair, psz 8, at the 1000 corners of frame 0 and at
    # 1000 seeded random points.  (The corners of this sum-of-sinusoids
    # texture sit on its finest detail, where the coarse levels carry no
    # signal and the finest level under-shoots a ~2.5 px step: the gate
    # rejects most of them, which is what it is for; the random points are
    # the accuracy check.)
    lk_pyrs = [build_pyramid(convert.tensor_from_numpy(f), FL, psz) for f in clip[:2]]
    xy_0, ok_0 = corners_of(clip_pyrs[0])
    rng_lk = np.random.default_rng(SEED + 5)
    xy_r = on_card(np.c_[rng_lk.uniform(20, Wc - 20, n_corners),
                         rng_lk.uniform(20, Hc - 20, n_corners)])
    gt01 = flow_bench.plane_gt_flow(scene, clip_G[0], clip_G[1])
    lk_out, lk_xy = {}, {}
    for pts_name, pts, ok_pts, min_share in (
            ("corners", xy_0, ok_0, 0.03),
            ("random", xy_r, torch.ones(n_corners, dtype=torch.bool, device=dev), 0.9)):
        for name, kw, want in (("cache", {}, {"K6": 2 * FL, "K7": 2 * FL}),
                               ("nocache", {"window_cache": False},
                                {"K6": 2 * FL, "K5": 2 * FL * 8})):
            reset(*all_counts)
            xy_b, ok_b = lk.lk_forward_backward(lk_pyrs[0], lk_pyrs[1], pts, **kw)
            torch.cuda.synchronize()
            expect_counts(f"sparse LK ({pts_name}, {name})", read_counts(), want)
            lk_xy[pts_name, name] = (xy_b.cpu(), ok_b.cpu())
            keep = (ok_b & ok_pts).cpu().numpy()
            at = pts.cpu().numpy()[keep]
            moved = xy_b.cpu().numpy()[keep] - at
            lk_err = np.linalg.norm(
                moved - gt01[at[:, 1].astype(int), at[:, 0].astype(int)], axis=1)
            row = {"verified": int(keep.sum()), "of": int(ok_pts.sum()),
                   "median_err": float(np.median(lk_err))}
            lk_out[f"{pts_name}_{name}"] = row
            print(f"sparse LK ({pts_name}, {name}): {row}")
            check(row["verified"] >= min_share * row["of"] and row["median_err"] < STEP_TOL,
                  f"sparse LK ({pts_name}, {name}): {row}")
    lk_cpu = lk.lk_forward_backward(
        *(build_pyramid(torch.from_numpy(f), FL, psz) for f in clip[:2]), xy_r.cpu())
    both = lk_cpu[1] & lk_xy["random", "cache"][1]
    lk_gap = float((lk_cpu[0] - lk_xy["random", "cache"][0]).abs().amax(-1)[both].median())
    lk_out["cpu_median_gap"] = lk_gap
    print(f"sparse LK (random, cache), card vs CPU: median gap {lk_gap} px over "
          f"{int(both.sum())} points verified by both (limit 1e-3)")
    check(lk_gap <= 1e-3 and int(both.sum()) >= 0.9 * n_corners,
          f"sparse LK: card vs CPU median gap {lk_gap} over {int(both.sum())} points")

    # ---- phase 4g: main path 5c, the flow-quality benchmark's evaluate_pair
    # on one 640x480 pair (run_benchmark's size) at patch side 32
    rng_b = np.random.default_rng(SEED + 4)
    wh_b = (640, 480)
    scene_b = synthetic.make_scene(rng_b, wh=wh_b, fc=(0.9 * wh_b[0], 0.95 * wh_b[0]),
                                   freq_range=(0.3, 4.0))
    m_b = 0.19      # the second of run_benchmark's six pose steps
    G_b = [lie.se3_exp(torch.tensor(q, dtype=torch.float64)).numpy()
           for q in (np.zeros(6), np.r_[m_b * 0.8, m_b * 0.35, m_b * 0.1, 0.004 * m_b,
                                        0.006 * m_b, 0.003 * m_b])]
    imgs_b = [synthetic.render(scene_b, G) for G in G_b]
    reset(*all_counts)
    bench_row = flow_bench.evaluate_pair(scene_b, G_b[0], G_b[1], *imgs_b)
    torch.cuda.synchronize()
    expect_counts("flow benchmark (evaluate_pair, psz 32)", read_counts(),
                  {"K8": 4 * 4, "K5": 4})
    bench_epe = {k: bench_row[k]["all"] for k in ("lk", "ncc", "mosse")}
    print(f"flow benchmark, one {wh_b[0]}x{wh_b[1]} pair, mean GT flow "
          f"{bench_row['gt_mag_mean']:.2f} px: EPE {bench_epe}")
    check(all(np.isfinite(v) for v in bench_epe.values()), "flow benchmark: non-finite EPE")
    check(bench_epe["ncc"] <= 1.5 * bench_epe["lk"] and bench_epe["mosse"] <= 1.5 * bench_epe["lk"],
          f"flow benchmark: a refinement is worse than 1.5 x its seed: {bench_epe}")

    # ---- phase 4h: main path 5d, the tracker of path 1 with the dual
    # gather through K9
    cfg9 = dataclasses.replace(cfg, gather_prefetch=True)
    reset(*all_counts)
    p_out9 = track_pose_batch(pyr_ref, pyr_new, Xd, p0, cam, cfg9)
    torch.cuda.synchronize()
    pre_launches = read_counts()
    expect_counts("tracker with gather_prefetch=True", pre_launches,
                  {"K9": cfg.num_levels, "K2": cfg.num_levels * cfg.maxiter})
    check(bool(torch.equal(p_out9, p_out)), "gather_prefetch=True: poses differ from "
          f"path 1's by {float((p_out9 - p_out).abs().max())} (expected bit for bit)")
    print("tracker with gather_prefetch=True: poses equal path 1's bit for bit")

    # ---- phase 8: main path 8, the RANSAC pose path (the reference's
    # func_ransac_fitcameras_odom at the verifier's workload): S = B
    # hypotheses from fit_camera_ransac, verified by track_nposes on the
    # verifier's three frames (frame 1 the reference), select_best
    from invcompcamtrack_torch.sfm import pnp
    from invcompcamtrack_torch.sfm.epipolar import sample_indices
    from invcompcamtrack_torch.sfm.ransac import fit_camera_ransac

    t_phase8 = time.perf_counter()
    pt2d_r, pt3d_r, r_thresh = ransac_problem(scene, p_gt, X)
    idx_r = sample_indices(N, B, k=RANSAC_SAMPLE,
                           generator=torch.Generator().manual_seed(SEED))
    pt2d_rd, pt3d_rd = on_card(pt2d_r), on_card(pt3d_r)
    pyrs_v = [pyr_ref, pyr_new, pyr_2]

    def ransac_fit(on_card=True):
        pts = ((pt2d_rd, pt3d_rd) if on_card
               else (torch.from_numpy(pt2d_r), torch.from_numpy(pt3d_r)))
        return fit_camera_ransac(idx_r, *pts, scene.fc, scene.cc, inl_thresh=r_thresh,
                                 min_inliers=RANSAC_MIN_INLIERS)

    def ransac_verify(res):
        return chain.track_nposes(pyrs_v, res.poses, pt3d_rd, res.inliers, cam, cfg, (1, 1))

    def ransac_path():
        res = ransac_fit()
        ch = ransac_verify(res)
        return res, ch, chain.select_best(ch, res.valid)

    reset(*all_counts)
    rres, rchain, (r_best, r_score) = ransac_path()
    torch.cuda.synchronize()
    r_launches = read_counts()
    expect_counts("RANSAC pose path (fit_camera_ransac, track_nposes, select_best)",
                  r_launches, {"K1": 2 * cfg.num_levels,
                               "K2": 2 * cfg.num_levels * cfg.maxiter, "K4": 1})
    n_valid = int(rres.valid.sum())
    check(n_valid > 10, f"RANSAC: {n_valid} valid hypotheses (limit > 10)")
    check(bool(torch.isfinite(rres.G[rres.valid]).all())
          and bool(torch.isfinite(rres.poses[rres.valid]).all()),
          "RANSAC: a valid hypothesis is not finite")
    planar = pnp.planarity(pt3d_rd[idx_r.to(dev)]) < 1e-3
    check(bool(planar.all()), "RANSAC: a sample of the plane did not route to pnp_planar")
    b = int(r_best)
    check(bool(rres.valid[b]), "select_best picked an invalid hypothesis")
    c2_gt = lie.camera_center(lie.se3_exp(torch.tensor(p2, dtype=torch.float32, device=dev)))
    r_cerr = center_err(rres.poses)                                    # (S,)
    r_fwd_err = (lie.camera_center(lie.se3_exp(rchain.pose_tracks[:, 2])) - c2_gt).norm(dim=-1)
    near_true = rres.valid & (r_cerr < 0.05)
    # bench.py:105-111's guard, the median camera-centre error over the
    # batch: here over the valid hypotheses
    r_med = float(r_cerr[rres.valid].median())
    # tests/test_ransac.py:79-84: the hypothesis with the most inliers, its
    # pose and its inlier set
    bc = int(torch.argmax(torch.where(rres.valid, rres.num_inliers,
                                      torch.full_like(rres.num_inliers, -1))))
    inl_bc = rres.inliers[bc].cpu().numpy()
    out_share = float(inl_bc[:RANSAC_OUTLIERS].mean())
    in_share = float(inl_bc[RANSAC_OUTLIERS:].mean())
    r_fwd_near = float(r_fwd_err[near_true].median())
    print(f"RANSAC: {n_valid} of {B} hypotheses valid, {int(near_true.sum())} of them within "
          f"0.05 of the true centre; median camera-centre error of the valid ones "
          f"{r_med:.6f} (limit 0.05); the most inliers ({int(rres.num_inliers[bc])}, hypothesis "
          f"{bc}): centre error {float(r_cerr[bc]):.6f} (limit 0.05), outliers in its inlier "
          f"set {out_share:.2f} (limit {OUTLIER_SHARE}), inliers kept {in_share:.2f} (limit "
          f"{INLIER_SHARE}); the near-true hypotheses' forward chains: median centre error "
          f"{r_fwd_near:.6f} at frame 2 (limit 0.05)")
    check(r_med < 0.05, f"RANSAC: median centre error of the valid hypotheses {r_med}")
    check(float(r_cerr[bc]) < 0.05 and out_share <= OUTLIER_SHARE and in_share >= INLIER_SHARE,
          f"RANSAC, the most inliers: centre error {float(r_cerr[bc])}, outliers {out_share}, "
          f"inliers {in_share}")
    check(r_fwd_near < 0.05, f"RANSAC verification: near-true chains end {r_fwd_near} off")
    # the reference's selection (func_ransac_fitcameras_odom.m:151-154): the
    # highest mean correlation; every chain that converges scores > 0.9999
    # on this scene, wrong hypotheses with few inliers among them, so the
    # winner is reported, not held to the true pose (ROADMAP Queue 3)
    r_err = float(r_cerr[b])
    print(f"RANSAC verification winner (select_best): hypothesis {b}, mean corr "
          f"{float(r_score):.6f}, {int(rres.num_inliers[b])} inliers, camera-centre error "
          f"{r_err:.6f}; the near-true hypotheses' mean corr "
          f"{float(rchain.mean_corr[near_true].min()):.6f}-{float(rchain.mean_corr[near_true].max()):.6f}")
    # the card against the port's CPU run of the same fit, all B hypotheses
    rres_c = ransac_fit(on_card=False)
    v_flips = int((rres.valid.cpu() != rres_c.valid).sum())
    both = rres.valid.cpu() & rres_c.valid
    g_gap = (rres.G.cpu() - rres_c.G).abs().amax((1, 2))[both]
    g_q = {"median": float(g_gap.median()), "p90": float(torch.quantile(g_gap, 0.9)),
           "max": float(g_gap.max())}
    cnt_gap = int((rres.num_inliers.cpu() - rres_c.num_inliers).abs().max())
    print(f"RANSAC card vs CPU: valid flags differ at {v_flips} of {B} hypotheses (limit "
          f"{RANSAC_VALID_FLIPS}); {int(both.sum())} valid in both: G gap median "
          f"{g_q['median']:.3g}, 90th percentile {g_q['p90']:.3g}, max {g_q['max']:.3g} (limits "
          + ", ".join(f"{v:.3g}" for v in RANSAC_G_LIMITS.values())
          + f"); inlier counts part by up to {cnt_gap}")
    check(v_flips <= RANSAC_VALID_FLIPS, f"RANSAC card vs CPU: {v_flips} valid flags differ")
    for q, lim in RANSAC_G_LIMITS.items():
        check(g_q[q] <= lim, f"RANSAC card vs CPU: G gap {q} {g_q[q]} (limit {lim})")
    # the verification on 16 hypotheses, card vs CPU, as phase 4b: the
    # winner and the next valid ones, from the card's fit
    lanes = [b] + [i for i in torch.nonzero(rres.valid)[:, 0].tolist() if i != b][:n_ref - 1]
    X16r = np.broadcast_to(pt3d_r, (len(lanes), N, 3)).copy()
    p16r = rres.poses[lanes].cpu()
    m16r = rres.inliers[lanes].cpu().numpy()
    r_cmp = {}
    for chain_name, to_card, to_cpu in (("forward", pyr_2, cpu_2), ("backward", pyr_ref, cpu_ref)):
        r_cmp[chain_name], _, _ = card_vs_cpu(
            f"RANSAC verification {chain_name} chain",
            (pyr_new, to_card, on_card(X16r), p16r.to(dev), cam),
            (cpu_new, to_cpu, torch.from_numpy(X16r), p16r, cpu_cam), cfg, m16r)

    r_seconds = time.perf_counter() - t_phase8

    # ---- phase 9: this slice's smaller paths, for correctness and launches
    t_phase9 = time.perf_counter()
    small_launches, small_out = small_paths_phase(torch, dev, card, all_counts, read_counts,
                                                  expect_counts)
    small_out["seconds"] = time.perf_counter() - t_phase9
    print(f"phases 8 and 9 took {r_seconds:.1f} s and {small_out['seconds']:.1f} s")

    # ---- phase 5: times.  "wall": median of the calls between CUDA
    # events, which for these small, host-launched calls is mostly the
    # host's launch time; "device": the card's own kernel time per call
    # (torch.profiler, sum over every device op of the calls / their count).
    def main_call():
        return track_pose_batch(pyr_ref, pyr_new, Xd, p0, cam, cfg)

    main_ms = cuda_ms(torch, main_call)
    main_dev_ms, main_ops, main_own = device_ms(torch, main_call, reps=1, what="the main path")
    pyrs_v = [pyr_ref, pyr_new, pyr_2]
    poses_v = convert.tensor_from_numpy(hyp, dev, torch.float32)
    pt3d_v = convert.tensor_from_numpy(pt3d, dev, torch.float32)
    masks_v = convert.tensor_from_numpy(masks, dev)

    def verifier_call():
        return chain.track_nposes(pyrs_v, poses_v, pt3d_v, masks_v, cam, cfg, (1, 1))

    ver_ms = cuda_ms(torch, verifier_call, reps=5, warmup=1)
    ver_dev_ms, ver_ops, ver_own = device_ms(torch, verifier_call, reps=1, what="the verifier")
    # path 8: the fit alone and fit + verification + selection
    fit_ms = cuda_ms(torch, ransac_fit, reps=10, warmup=2)
    fit_dev_ms, fit_ops, _ = device_ms(torch, ransac_fit, reps=1, what="the RANSAC fit", top=6)
    fit_syncs = host_syncs(torch, ransac_fit)
    rp_ms = cuda_ms(torch, ransac_path, reps=5, warmup=1)
    rp_dev_ms, rp_ops, rp_own = device_ms(torch, ransac_path, reps=1, what="the RANSAC path")
    rp_syncs = host_syncs(torch, ransac_path)
    nf_ms = {k: cuda_ms(torch, f, reps=3, warmup=1) for k, f in nf_calls.items()}
    nf_dev = {k: device_ms(torch, f, reps=1, what=f"the non-fused tracker ({k})")[:2]
              for k, f in nf_calls.items()}

    def prefetch_call():
        return track_pose_batch(pyr_ref, pyr_new, Xd, p0, cam, cfg9)

    # the two dual gathers end to end, in turns: K1, K9, K9, K1
    ab_ms = [cuda_ms(torch, f, reps=5, warmup=1)
             for f in (main_call, prefetch_call, prefetch_call, main_call)]
    _, _, pre_own = device_ms(torch, prefetch_call, reps=1, what="the prefetch tracker")

    def point_tracker_call():
        ff, fb = flow_pair(clip_pyrs[0], clip_pyrs[1])
        xy_c, ok_c = corners_of(clip_pyrs[1])
        return track.advance_tracks(table, ff, fb, xy_c, ok_c)

    pt_ms = cuda_ms(torch, point_tracker_call, reps=5, warmup=1)
    pt_dev_ms, pt_ops, pt_own = device_ms(torch, point_tracker_call, reps=1,
                                          what="the point tracker", top=8)
    k8_plane = clip_pyrs[1][0].img[fpad:-fpad, fpad:-fpad].contiguous()

    k1_args = (k1_in["level"], k1_in["qimg"], k1_in["uv"], k1_in["origins"], psz, pad, win)
    f32, b16 = k2_in[torch.float32], k2_in[torch.bfloat16]
    # K5 and K6 at psz 8 on level 0 (the window_cache=False path's shape);
    # K7 at the 12x12 windows of the pad-4 level 0 (the psz-4 path's shape)
    g_lvl = gather_in[psz]["lvl"]
    w_lvl, w_or, win4 = gather_in[4]["lvl"], gather_in[4]["origins"], 4 + 8
    pairs = {
        "K1": (lambda: patch_gather.gather_ref_grad_windows(*k1_args),
               lambda: patch_gather.gather_ref_grad_windows_plain(*k1_args)),
        "K2": (lambda: icgn_iter.fused_resample_project(*f32, *taps),
               lambda: icgn_iter.fused_resample_project_plain(*f32, *taps)),
        "K2_bf16": (lambda: icgn_iter.fused_resample_project(*b16, *taps),
                    lambda: icgn_iter.fused_resample_project_plain(*b16, *taps)),
        "K3": (lambda: icgn_iter.fused_resample_pdiff(*f32[:2], *taps),
               lambda: icgn_iter.fused_resample_pdiff_plain(*f32[:2], *taps)),
        "K4": (lambda: ncc3.ncc3_scores(*k4_args),
               lambda: ncc3.ncc3_scores_plain(*k4_args)),
        "K5": (lambda: patch_gather.gather_patches(g_lvl.img, uv0, psz, pad),
               lambda: patch_gather.gather_patches_plain(g_lvl.img, uv0, psz, pad)),
        "K6": (lambda: patch_gather.gather_patches_grad(g_lvl.img, g_lvl.dx, g_lvl.dy,
                                                        uv0, psz, pad),
               lambda: patch_gather.gather_patches_grad_plain(g_lvl.img, g_lvl.dx,
                                                              g_lvl.dy, uv0, psz, pad)),
        "K7": (lambda: patch_gather.gather_windows(w_lvl.img, w_or, win4, win4),
               lambda: patch_gather.gather_windows_plain(w_lvl.img, w_or, win4, win4)),
        "K8": (lambda: warp.warp_image(k8_plane, flow_01),
               lambda: warp.warp_image_plain(k8_plane, flow_01)),
        "K9": (lambda: patch_prefetch.gather_ref_grad_windows_prefetch(*k1_args),
               lambda: patch_prefetch.gather_ref_grad_windows_prefetch_plain(*k1_args)),
    }
    # "ms": the kernel's own time; "wrapper_ms" and "wrapper_ops": every
    # device op of one wrapper call (the kernel and any torch ops that
    # prepare its indices and weights); "plain_ms": every device op of the
    # plain version
    times = {}
    for k, (kern, plain) in pairs.items():
        wrapper_ms, wrapper_ops, own = device_ms(torch, kern, reps=5, what=k,
                                                 per_call=("icgn::", 1))
        check(len(own) == 1, f"{k}: expected one kernel of csrc/ per call, saw {own}")
        times[k] = {"ms": sum(own.values()), "wrapper_ms": wrapper_ms,
                    "wrapper_ops": wrapper_ops,
                    "plain_ms": device_ms(torch, plain, reps=5, what=k + " plain")[0],
                    "wall_ms": cuda_ms(torch, kern, reps=5, warmup=1),
                    "plain_wall_ms": cuda_ms(torch, plain, reps=5, warmup=1)}
    # K1, K4, K5, K6 and K9 take the centres and K7 the window origins as
    # they are: a call without the patch mean is one op
    for k in ("K1", "K4", "K5", "K6", "K7", "K9"):
        check(times[k]["wrapper_ops"] == 1, f"{k}: a call is {times[k]['wrapper_ops']} "
              f"device ops, not 1")

    # K5 and K6 at the other patch sides their callers use, K4 at psz 4 and
    # 16 and K7 at the windows of psz 4 and 8 (12x12, 16x16), on level 0
    # padded by the side: kernel and wrapper ms beside the bound
    def gather_bound(k, q, plane_bytes, m=M):
        npx_q = q * q
        if k == "K7":
            # reads: the planes, or the windows where they need less of them
            win_bytes = m * (q + 8) ** 2 * 4
            return bound(min(plane_bytes, win_bytes) + m * 8 + win_bytes, 0)
        if k == "K4":
            return bound(3 * plane_bytes + M * 24 + M * 8, M * (3 * npx_q * 11 + 4 * npx_q))
        if k == "K5":
            return bound(plane_bytes + M * 8 + M * npx_q * 4, M * npx_q * 7)
        return bound(plane_bytes + M * 8 + M * 3 * npx_q * 4,
                     M * (3 * npx_q * 7 + 2 * (q + 1) ** 2))

    size_times = []
    for k, q in (("K5", 4), ("K5", 16), ("K5", 18), ("K5", 20), ("K5", 32), ("K6", 4),
                 ("K6", 16), ("K4", 4), ("K4", 16), ("K7", 4), ("K7", psz)):
        lv = gather_in[q]["lvl"]
        if k == "K7":
            def call(lv=lv, q=q):
                return patch_gather.gather_windows(lv.img, gather_in[q]["origins"], q + 8,
                                                   q + 8)
        elif k == "K4":
            planes4 = (lv.img, *(build_pyramid(convert.tensor_from_numpy(im), 1, q)[0].img
                                 for im in (img_new, img_2)))

            def call(planes4=planes4, q=q):
                return ncc3.ncc3_scores(*planes4, uv_b, uv0, uv_f, q, q)
        elif k == "K5":
            def call(lv=lv, q=q):
                return patch_gather.gather_patches(lv.img, uv0, q, q)
        else:
            def call(lv=lv, q=q):
                return patch_gather.gather_patches_grad(lv.img, lv.dx, lv.dy, uv0, q, q)
        w_ms, w_ops, own = device_ms(torch, call, reps=5, what=f"{k} psz {q}",
                                     per_call=("icgn::", 1))
        b_ms, b_by = gather_bound(k, q, lv.img.numel() * 4)
        size_times.append({"kernel": k, "psz": q, "ms": sum(own.values()),
                           "wrapper_ms": w_ms, "wrapper_ops": w_ops, "bound_ms": b_ms,
                           "bound_by": b_by})
        check(w_ops == 1, f"{k} psz {q}: a call is {w_ops} device ops, not 1")

    # one PyTorch call that computes K5's function: grid_sample over the
    # per-pixel sample positions (built outside the timed call; its taps
    # round differently, so it is a yardstick, not a reference)
    import torch.nn.functional as F

    Hp, Wp = g_lvl.img.shape
    ar = torch.arange(psz, device=dev, dtype=torch.float32) - psz // 2 + pad
    gx = (uv0[:, None, None, 0] + ar[None, None, :]).expand(M, psz, psz)
    gy = (uv0[:, None, None, 1] + ar[None, :, None]).expand(M, psz, psz)
    grid = torch.stack([gx / (Wp - 1) * 2 - 1, gy / (Hp - 1) * 2 - 1], -1)
    grid = grid.reshape(1, M * psz, psz, 2).contiguous()
    plane4 = g_lvl.img[None, None]

    def k5_library():
        return F.grid_sample(plane4, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    # (the reference's ceil(x + 1e-5), taken in float32, puts a center on
    # or within 1e-5 of an integer one pixel off; grid_sample does not:
    # such centers are left out of this check)
    frac = uv0 - torch.floor(uv0)
    plain_at = ((frac > 1e-4) & (frac < 1.0 - 1e-4)).all(-1)
    plain_at[:8] = False
    plain_at[-len(far):] = False
    lib_diff = float((k5_library().reshape(M, psz, psz)
                      - patch_gather.gather_patches_plain(g_lvl.img, uv0, psz, pad)
                      )[plain_at].abs().max())
    check(lib_diff < 0.05, f"grid_sample is not K5's function: differs by {lib_diff}")
    library_ms = {"K5": device_ms(torch, k5_library, reps=5, what="grid_sample", per_call=("", 1))[0]}
    # (a grid_sample call is one device op; the indexing call below is a few)

    # one PyTorch call that computes K6's function: grid_sample over the
    # stack of the image and its two gradient planes (stacked, and the grid
    # built, outside the timed call)
    stack6 = torch.stack([g_lvl.img, g_lvl.dx, g_lvl.dy])[None].contiguous()

    def k6_library():
        return F.grid_sample(stack6, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    lib6 = k6_library()[0].reshape(3, M, psz, psz)
    lib6_diff = max(float((lib6[i] - w)[plain_at].abs().max()) for i, w in enumerate(
        patch_gather.gather_patches_grad_plain(g_lvl.img, g_lvl.dx, g_lvl.dy, uv0, psz, pad)))
    check(lib6_diff < 0.05, f"grid_sample is not K6's function: differs by {lib6_diff}")
    library_ms["K6"] = device_ms(torch, k6_library, reps=5, what="grid_sample (K6)",
                                 per_call=("", 1))[0]
    del lib6

    # one PyTorch call that computes K7's function: advanced indexing of
    # the plane at row and column indices built outside the timed call
    Hp4, Wp4 = w_lvl.img.shape
    ar4 = torch.arange(win4, device=dev)
    rows7 = (torch.clamp(w_or[:, 0], 0, Hp4 - win4).long()[:, None] + ar4)[:, :, None]
    cols7 = (torch.clamp(w_or[:, 1], 0, Wp4 - win4).long()[:, None] + ar4)[:, None, :]

    def k7_library():
        return w_lvl.img[rows7, cols7]

    check(bool(torch.equal(k7_library(), gather_in[4]["windows"])),
          "advanced indexing is not K7's function")
    library_ms["K7"] = device_ms(torch, k7_library, reps=5, what="aten::index")[0]

    # one PyTorch call that computes K8's function: grid_sample on the
    # normalised sample positions (built outside the timed call)
    yy8, xx8 = torch.meshgrid(torch.arange(Hc, device=dev, dtype=torch.float32),
                              torch.arange(Wc, device=dev, dtype=torch.float32),
                              indexing="ij")
    grid8 = torch.stack([(xx8 + flow_01[..., 0]) / (Wc - 1) * 2 - 1,
                         (yy8 + flow_01[..., 1]) / (Hc - 1) * 2 - 1], -1)[None].contiguous()
    plane8 = k8_plane[None, None]

    def k8_library():
        return F.grid_sample(plane8, grid8, mode="bilinear", padding_mode="border",
                             align_corners=True)

    lib8_diff = float((k8_library()[0, 0] - warp.warp_image_plain(k8_plane, flow_01)
                       ).abs().max())
    check(lib8_diff < 0.05, f"grid_sample is not K8's function: differs by {lib8_diff}")
    library_ms["K8"] = device_ms(torch, k8_library, reps=5, what="grid_sample (K8)", per_call=("", 1))[0]

    # bounds from this run's inputs: each input read once, each output
    # written once (float32 = 4 bytes), and the float32 operations
    plane_b = Hp * Wp * 4
    npx = psz * psz
    bounds = {
        "K1": bound(2 * plane_b + M * 16 + M * (3 * npx + win * win) * 4,
                    M * (3 * npx * 7 + 2 * (psz + 1) ** 2)),
        "K2": bound(M * (win * win + 3 * npx) * 4 + M * 28 + M * 8, M * npx * 13),
        "K2_bf16": bound(M * (win * win + 3 * npx) * 2 + M * 28 + M * 8, M * npx * 13),
        "K3": bound(M * (win * win + npx) * 4 + M * 28 + M * npx * 4, M * npx * 9),
        "K4": bound(3 * plane_b + M * 24 + M * 8, M * (3 * npx * 11 + 4 * npx)),
        "K5": bound(plane_b + M * 8 + M * npx * 4, M * npx * 7),
        "K6": bound(plane_b + M * 8 + M * 3 * npx * 4,
                    M * (3 * npx * 7 + 2 * (psz + 1) ** 2)),
        "K7": gather_bound("K7", 4, Hp4 * Wp4 * 4),
        # K8: the plane and the flow read, the plane written; ~20 float
        # operations per pixel (two adds, two floors and clamps, the weights
        # and the four-tap sum)
        "K8": bound(Hc * Wc * 16, Hc * Wc * 20),
    }
    bounds["K9"] = bounds["K1"]

    # K7 timed: its kernel's median over K7_REPS launches in each of two
    # warm passes, and the wrapper's device ops and ms, at M windows of
    # 12x12 (level 0 padded by 4: the psz-4 tracker's) and 16x16 (padded by
    # 8: sparse LK's), and at the engine's own size, 512 windows of 16x16 on
    # one plane and 4 x 512 on the plane stack
    o16 = gather_in[psz]["origins"]
    k7_cases = {f"{win4}x{win4}, {M} windows": (w_lvl.img, w_or, 4),
                f"{win}x{win}, {M} windows": (g_lvl.img, o16, psz),
                f"{win}x{win}, {K7_ENGINE_POINTS} windows (engine, S = 1)":
                    (g_lvl.img, o16[:K7_ENGINE_POINTS].contiguous(), psz),
                f"{win}x{win}, {P_STACK} x {K7_ENGINE_POINTS} windows on {P_STACK} planes "
                f"(engine, S = {P_STACK})": (*k7_stack, psz)}
    k7_timed = {"card": card}
    for name, (img7, org7, q) in k7_cases.items():
        def call(img7=img7, org7=org7, q=q):
            return patch_gather.gather_windows(img7, org7, q + 8, q + 8)

        passes = [kernel_launch_ms(torch, call, K7_REPS, f"K7 {name}") for _ in range(2)]
        medians = [statistics.median(t) for t in passes]
        w_ms, w_ops, _ = device_ms(torch, call, reps=5, what=f"K7 {name}",
                                   per_call=("icgn::", 1))
        check(w_ops == 1, f"K7 {name}: a call is {w_ops} device ops, not 1")
        b_ms, _ = gather_bound("K7", q, img7.numel() * 4, org7.numel() // 2)
        k7_timed[name] = {"median_ms": medians, "launches": [len(t) for t in passes],
                          "wrapper_ms": w_ms, "wrapper_ops": w_ops, "bound_ms": b_ms,
                          "over_bound": [t / b_ms for t in medians]}
        print(f"[{card}] K7 ({name}, level 0 padded by {q}): kernel median of "
              + " and ".join(f"{len(t)}" for t in passes) + " launches in two warm passes "
              + " / ".join(f"{t:.5f}" for t in medians) + f" ms; wrapper {w_ms:.5f} ms in "
              f"{w_ops:g} device op(s); bound {b_ms:.5f} ms ("
              + " / ".join(f"{t / b_ms:.2f}" for t in medians) + " x)")

    # ---- phase 6: main path 6, the VO engine (one stream) at
    # bench_engine's workload; its counts are set to 0 just before its
    # timed chunk and read just after.  It runs after the kernel timings:
    # its profiles of tens of thousands of device events made the short
    # profiles taken after them come back empty (seen on an H100)
    eng_launches, eng_out = engine_phase(torch, dev, card, all_counts, read_counts,
                                         expect_counts)

    # ---- phase 7: main path 7, the multi-stream engine (VisualOdometryBatch)
    # at bench_engine_streams' workload; its counts are set to 0 just before
    # its timed chunk and read just after
    str_launches, str_out = streams_phase(torch, dev, card, all_counts, read_counts,
                                          expect_counts, eng_out)

    print(f"[{card}] main path B={B} N={N} 1280x720: wall {main_ms:.3f} ms/call "
          f"(CUDA events, median of 10) = {B / main_ms * 1e3:.1f} pairs/s; device busy "
          f"{main_dev_ms:.3f} ms/call in {main_ops:.0f} device ops "
          f"({main_dev_ms / main_ms:.1%} of the wall time)")
    print(f"[{card}] verifier S={S} N={N} 3 x 1280x720, fb (1, 1): wall {ver_ms:.3f} "
          f"ms/call (CUDA events, median of 5) = {S / ver_ms * 1e3:.1f} hypotheses/s; "
          f"device busy {ver_dev_ms:.3f} ms/call in {ver_ops:.0f} device ops "
          f"({ver_dev_ms / ver_ms:.1%} of the wall time)")
    print(f"[{card}] RANSAC fit S={B} x N={N}: wall {fit_ms:.3f} ms/call (CUDA events, median "
          f"of 10) = {B / fit_ms * 1e3:.1f} hypotheses/s; device busy {fit_dev_ms:.3f} ms/call "
          f"in {fit_ops:.0f} device ops ({fit_dev_ms / fit_ms:.1%} of the wall time); host "
          f"syncs per call: {fit_syncs}")
    print(f"[{card}] RANSAC fit + verification + selection S={B} x N={N}, 3 x 1280x720: wall "
          f"{rp_ms:.3f} ms/call (CUDA events, median of 5) = {B / rp_ms * 1e3:.1f} "
          f"hypotheses/s; device busy {rp_dev_ms:.3f} ms/call in {rp_ops:.0f} device ops "
          f"({rp_dev_ms / rp_ms:.1%} of the wall time); host syncs per call: {rp_syncs}")
    for path, own in (("main path", main_own), ("verifier", ver_own)):
        print(f"[{card}] {path}: the port's kernels, device ms per call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(own.items())))
    for k, t in nf_ms.items():
        print(f"[{card}] non-fused tracker {k} B={B} N={N}: wall {t:.3f} ms/call "
              f"(CUDA events, median of 3) = {B / t * 1e3:.1f} pairs/s")
    for k, (dev_ms_, ops_) in nf_dev.items():
        print(f"[{card}] non-fused tracker {k}: device busy {dev_ms_:.3f} ms/call in "
              f"{ops_:.0f} device ops ({dev_ms_ / nf_ms[k]:.1%} of the wall time)")
    print(f"[{card}] tracker, dual gather K1 / K9 / K9 / K1 in turns: wall "
          + " / ".join(f"{t:.3f}" for t in ab_ms) + " ms/call (CUDA events, median of 5); "
          "the port's kernels with K9, device ms per call: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(pre_own.items())))
    k8_share = pt_own.get("warp_image_kernel", 0.0) / pt_dev_ms
    print(f"[{card}] point tracker, one {Wc}x{Hc} frame pair (flow both ways, corners, "
          f"table): wall {pt_ms:.3f} ms (CUDA events, median of 5) = "
          f"{1e3 / pt_ms:.2f} frame pairs/s; device busy {pt_dev_ms:.3f} ms in "
          f"{pt_ops:.0f} device ops ({pt_dev_ms / pt_ms:.1%} of the wall time); K8 "
          f"{pt_own.get('warp_image_kernel', 0.0):.4f} ms for its "
          f"{pt_launches['K8']} launches ({k8_share:.1%} of the device time)")
    shapes = {k: "psz 8, level 0" for k in pairs}
    shapes["K7"] = f"{win4}x{win4} windows, level 0 padded by 4"
    shapes["K8"] = f"{Wc}x{Hc}, the point tracker's forward flow"
    for k, t in times.items():
        b_ms, b_by = bounds[k]
        lib = library_ms.get(k)
        print(f"[{card}] {k} ({shapes[k]}{'' if k == 'K8' else f', {M} points'}): kernel {t['ms']:.4f} ms, wrapper's "
              f"{t['wrapper_ops']:g} device ops {t['wrapper_ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f} ms; bound {b_ms:.4f} ms by {b_by}; library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}); wall {t['wall_ms']:.4f} ms "
              f"(plain {t['plain_wall_ms']:.4f} ms)")

    for t in size_times:
        side = (f"{t['psz'] + 8}x{t['psz'] + 8} windows" if t["kernel"] == "K7"
                else f"psz {t['psz']}")
        print(f"[{card}] {t['kernel']} ({side}, level 0 padded by {t['psz']}, {M} "
              f"points): kernel {t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms in "
              f"{t['wrapper_ops']:g} device op(s); bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']}")

    def entry(name, source, replaces, launches_n, err_, key):
        b_ms, b_by = bounds[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_n, "engine_launches": eng_launches[key[:2]],
                "engine_streams_launches": str_launches[key[:2]],
                "ransac_launches": r_launches[key[:2]],
                "features_launches": small_launches["features"][key[:2]],
                "stereo_launches": small_launches["stereo"][key[:2]],
                "replay_launches": small_launches["replay"][key[:2]],
                "max_abs_err": err_, **times[key],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms.get(key),
                "shape": shapes[key]}

    tpu = "invcompcamtrack_tpu/ops/"
    src = "invcompcamtrack_torch/csrc/"
    kernels = [
        entry("K1 gather_ref_grad_windows", src + "patch_gather.cu",
              tpu + "patch_pallas.py:413", launches["K1"], k1_err, "K1"),
        entry("K2 fused_resample_project", src + "icgn_iter.cu",
              tpu + "icgn_iter_pallas.py:172", launches["K2"], k2_err, "K2"),
        entry("K4 ncc3_scores", src + "ncc3.cu", tpu + "ncc_pallas.py:96",
              v_launches["K4"], k4_err, "K4"),
        entry("K5 gather_patches", src + "patch_gather.cu", tpu + "patch_pallas.py:257",
              nf_launches["psz8_nocache"]["K5"], gather_err["K5"], "K5"),
        entry("K6 gather_patches_grad", src + "patch_gather.cu",
              tpu + "patch_pallas.py:316", nf_launches["psz8_nocache"]["K6"],
              gather_err["K6"], "K6"),
        entry("K7 gather_windows", src + "patch_gather.cu", tpu + "patch_pallas.py:503",
              nf_launches["psz4"]["K7"], gather_err["K7"], "K7"),
        entry("K8 warp_image", src + "warp.cu", tpu + "warp_pallas.py:90",
              pt_launches["K8"], k8_err, "K8"),
        entry("K9 gather_ref_grad_windows_prefetch", src + "patch_prefetch.cu",
              tpu + "patch_prefetch.py:218", pre_launches["K9"], k9_err, "K9"),
    ]
    # K3 has no caller on the main paths (nor in the JAX package): it is
    # held against its plain version above and reported on its own line
    off_path = [entry("K3 fused_resample_pdiff", src + "icgn_iter.cu",
                      tpu + "icgn_iter_pallas.py:132", launches["K3"], k3_err, "K3")]
    total_s = time.perf_counter() - t_start
    print(json.dumps({"main_path": {
        "card": card, "pairs_per_s": B / main_ms * 1e3, "ms_per_call": main_ms,
        "device_busy_ms_per_call": main_dev_ms, "device_ops_per_call": main_ops,
        "kernel_ms_per_call": main_own, "median_center_err": med_err, "cpu_pose_err": pose_err, "build_s": build_s,
        "seconds": total_s}}))
    print(json.dumps({"verifier": {
        "card": card, "hypotheses_per_s": S / ver_ms * 1e3, "ms_per_call": ver_ms,
        "device_busy_ms_per_call": ver_dev_ms, "device_ops_per_call": ver_ops,
        "kernel_ms_per_call": ver_own, "launches": v_launches, "cpu_pose_err": v_pose_err, "chains_vs_cpu": v_cmp,
        "cpu_corr_err": v_corr_err,
        "near_true_min_corr": float(near.min()), "wrong_max_corr": float(bad_h.max()),
        "main_argv_on_png": have_pil}}))
    print(json.dumps({"non_fused": {
        k: {"launches": nf_launches[k], "ms_per_call": nf_ms[k],
            "pairs_per_s": B / nf_ms[k] * 1e3, "median_center_err": nf_med[k],
            **nf_cmp[k]} for k in nf_cases}}))
    print(json.dumps({"pair_tracker": pair_out}))
    print(json.dumps({"non_fused_device": {
        k: {"device_busy_ms_per_call": v[0], "device_ops_per_call": v[1]}
        for k, v in nf_dev.items()}}))
    print(json.dumps({"point_tracker": {
        "card": card, "frame_pairs_per_s": 1e3 / pt_ms, "ms_per_frame_pair": pt_ms,
        "device_busy_ms": pt_dev_ms, "device_ops": pt_ops, "kernel_ms": pt_own,
        "k8_share_of_device_time": k8_share, "launches": pt_launches,
        "frame_pairs": track_rows, "flow_card_vs_cpu_median": float(flow_gap.median()),
        "flow_card_vs_cpu_p999": flow_gap_999, "flow_card_vs_cpu_max": float(flow_gap.max())}}))
    print(json.dumps({"sparse_lk": lk_out}))
    print(json.dumps({"flow_bench": {"epe": bench_epe, "gt_mag_mean": bench_row["gt_mag_mean"]}}))
    print(json.dumps({"prefetch_tracker": {
        "launches": pre_launches, "ms_per_call_k1_k9_k9_k1": ab_ms,
        "kernel_ms_per_call": pre_own, "poses_equal_path_1": True}}))
    print(json.dumps({"engine": eng_out}))
    print(json.dumps({"engine_streams": {**str_out, "plane_stack_vs_plain": stack_err}}))
    print(json.dumps({"gathers_by_patch_side": size_times}))
    print(json.dumps({"kernels_off_main_path": off_path}))
    print(json.dumps({"ransac": {
        "card": card, "hypotheses_per_s_fit": B / fit_ms * 1e3, "fit_ms_per_call": fit_ms,
        "fit_device_busy_ms": fit_dev_ms, "fit_device_ops": fit_ops,
        "fit_busy_share": fit_dev_ms / fit_ms, "fit_host_syncs": fit_syncs,
        "hypotheses_per_s_fit_verify": B / rp_ms * 1e3, "fit_verify_ms_per_call": rp_ms,
        "fit_verify_device_busy_ms": rp_dev_ms, "fit_verify_device_ops": rp_ops,
        "fit_verify_busy_share": rp_dev_ms / rp_ms, "fit_verify_host_syncs": rp_syncs,
        "kernel_ms_per_call": rp_own, "launches": r_launches, "valid": n_valid,
        "near_true": int(near_true.sum()), "median_center_err_valid": r_med,
        "most_inliers": bc, "most_inliers_center_err": float(r_cerr[bc]),
        "most_inliers_outlier_share": out_share, "most_inliers_inlier_share": in_share,
        "near_true_fwd_center_err_median": r_fwd_near,
        "winner": b, "winner_mean_corr": float(r_score), "winner_center_err": r_err,
        "winner_inliers": int(rres.num_inliers[b]),
        "cpu_valid_flips": v_flips, "cpu_valid_flip_limit": RANSAC_VALID_FLIPS,
        "cpu_G_gap": g_q, "cpu_G_limits": RANSAC_G_LIMITS, "cpu_inlier_count_gap": cnt_gap,
        "chains_vs_cpu": r_cmp, "seconds": r_seconds}}))
    print(json.dumps({"small_paths": {**small_out, "launches": small_launches}}))
    print(json.dumps({"k7_timed": k7_timed, "k7_vs_plain_by_side": k7_side_err}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
