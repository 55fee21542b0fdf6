#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``invcompcamtrack_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes, runs
the batched IC-GN tracker ``track_pose_batch`` at the shape of
``bench.py::bench_solver`` (B=256 problems x N=100 points on one
1280x720 pair, psz 8, levels 4 -> 0, maxiter 10) and checks that it went
through the kernels and solved the problem, then times the main path
and every kernel beside its plain version.

It imports no JAX.  It exits non-zero, and prints no result, when no
CUDA card is present, when the package is missing, or when any phase
fails.  The last line is one JSON object naming the device.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

B, N = 256, 100
SEED = 0
# Tolerances (kernel vs plain version on the card, same inputs):
# K1 performs the plain version's float operations in its order (taps
# and gradient differences with the non-contracting _rn intrinsics), so
# it is expected bit-exact; 1e-4 bounds ~8 ulp of intensities < 256.
K1_TOL = 1e-4
# K2 sums the 64 pixels of the mean and of (gx, gy) in a warp butterfly:
# the gap is relative to the magnitudes summed.
K2_RTOL = 1e-5
# K3's error image is exact without the mean, ~1 ulp of it with one.
K3_TOL = 4e-5
# Poses of the card's run vs the port's CPU run (plain versions): the
# sums of H, rhs and (gx, gy) are taken in other orders; 5x the CPU
# tests' port-vs-JAX tolerance.
POSE_TOL = 1e-4


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


def device_ms(torch, fn, reps=10):
    """The card's busy time for one call (ms; every device op that the
    profiler records, summed over ``reps`` calls / reps) and the number
    of device ops per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(ops) > 0, "torch.profiler recorded no device time")
    busy_us = sum(e.time_range.elapsed_us() for e in ops)
    return busy_us / reps / 1e3, len(ops) / reps


def make_problem():
    """bench.py::bench_solver's scene, points and poses, from SEED."""
    import torch

    from invcompcamtrack_torch import synthetic
    from invcompcamtrack_torch.core import lie

    rng = np.random.default_rng(SEED)
    scene = synthetic.make_scene(rng, wh=(1280, 720), fc=(1000.0, 1200.0), z0=8.0)

    def exp_np(p):
        return lie.se3_exp(torch.tensor(p, dtype=torch.float32)).double().numpy()

    p_gt = np.r_[rng.normal(size=3) * 0.02, rng.normal(size=3) * 0.01]
    img_ref = synthetic.render(scene, exp_np(np.zeros(6))).astype(np.float32)
    img_new = synthetic.render(scene, exp_np(p_gt)).astype(np.float32)
    X = np.stack([synthetic.sample_plane_points(scene, rng, N) for _ in range(B)])
    return scene, p_gt, img_ref, img_new, X.astype(np.float32)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import invcompcamtrack_torch  # noqa: F401  (sets TF32 off)
    from invcompcamtrack_torch import ICGNParams, convert
    from invcompcamtrack_torch.core import lie
    from invcompcamtrack_torch.core.camera import CameraPyramid
    from invcompcamtrack_torch.image.pyramid import build_pyramid
    from invcompcamtrack_torch.ops import _build, icgn_iter, patch_gather
    from invcompcamtrack_torch.ops import window_sample as ws
    from invcompcamtrack_torch.solver.icgn import track_pose_batch

    dev = torch.device("cuda")
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
    scene, p_gt, img_ref, img_new, X = make_problem()
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, cfg.num_levels, pad,
                               device=dev)
    pyr_ref = build_pyramid(convert.tensor_from_numpy(img_ref, dev), cfg.num_levels, pad)
    pyr_new = build_pyramid(convert.tensor_from_numpy(img_new, dev), cfg.num_levels, pad)
    Xd = convert.tensor_from_numpy(X, dev)
    p0 = torch.zeros((B, 6), device=dev)
    gen = np.random.default_rng(SEED + 1)

    # ---- phase 2: K1 vs its plain version, all 5 levels, 25,600 points
    k1_err = 0.0
    k1_in = {}
    for s in range(cfg.num_levels):
        fx, fy, cx, cy, swo, sho = (float(v) for v in cam.level(s))
        uv = torch.stack([Xd[..., 0] / Xd[..., 2] * fx + cx,
                          Xd[..., 1] / Xd[..., 2] * fy + cy], -1).reshape(-1, 2)
        border = torch.tensor([[swo, sho], [0.2, sho], [swo, 0.5 * sho], [0.0, 0.0],
                               [0.0, 0.3 * sho], [0.4 * swo, 0.0], [swo, 0.0],
                               [0.0, sho]], device=dev)
        uv[: len(border)] = border
        entry = uv + convert.tensor_from_numpy(
            gen.uniform(-2.0, 2.0, uv.shape).astype(np.float32), dev)
        origins = ws.window_origin(entry, psz, win, pad)
        got = patch_gather.gather_ref_grad_windows(pyr_ref[s], pyr_new[s].img, uv,
                                                   origins, psz, pad, win)
        want = patch_gather.gather_ref_grad_windows_plain(pyr_ref[s], pyr_new[s].img,
                                                          uv, origins, psz, pad, win)
        torch.cuda.synchronize()
        for name, g, w in zip(("p_img", "p_dx", "p_dy", "qwin"), got, want):
            err = float((g - w).abs().max())
            check(err <= (0.0 if name == "qwin" else K1_TOL),
                  f"K1 level {s} {name}: max abs err {err}")
            k1_err = max(k1_err, err)
        if s == 0:
            k1_in = dict(level=pyr_ref[0], qimg=pyr_new[0].img, uv=uv,
                         origins=origins, out=got)
    print(f"K1 vs plain: 5 levels x {B * N} points (8 on the border each), "
          f"max abs err {k1_err} (tol {K1_TOL}, windows exact)")

    # ---- phase 3: K2 / K3 vs plain at 25,600 points, f32 and bf16 storage
    M = B * N
    p_img, p_dx, p_dy, qwin = k1_in["out"]
    moved = k1_in["uv"] + convert.tensor_from_numpy(
        gen.uniform(-4.5, 4.5, (M, 2)).astype(np.float32), dev)
    row_w, col_w, wts = ws.window_taps(moved, k1_in["origins"], psz, pad, win)
    valid = convert.tensor_from_numpy((gen.uniform(size=M) > 0.1).astype(np.float32), dev)
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

    # ---- phase 4: the main path, counts set to 0 just before it
    for counts in (patch_gather.launches, icgn_iter.launches):
        for k in counts:
            counts[k] = 0
    p_out = track_pose_batch(pyr_ref, pyr_new, Xd, p0, cam, cfg)
    torch.cuda.synchronize()
    launches = {"K1": patch_gather.launches["gather_ref_grad_windows"],
                "K2": icgn_iter.launches["project"], "K3": icgn_iter.launches["pdiff"]}
    print(f"main path launches: {launches}")
    check(launches["K1"] == cfg.num_levels, f"K1 launched {launches['K1']} times, not 5")
    check(launches["K2"] == cfg.num_levels * cfg.maxiter,
          f"K2 launched {launches['K2']} times, not 50")
    check(bool(torch.isfinite(p_out).all()), "non-finite poses")
    centers = lie.camera_center(lie.se3_exp(p_out))
    c_gt = lie.camera_center(lie.se3_exp(torch.tensor(p_gt, dtype=torch.float32,
                                                      device=dev)))
    err = (centers - c_gt).norm(dim=-1)
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

    # ---- phase 5: times.  "wall": median of 10 calls between CUDA
    # events, which for these small, host-launched calls is mostly the
    # host's launch time; "device": the card's own kernel time per call
    # (torch.profiler, sum over every device op of 10 calls / 10).
    def main_call():
        return track_pose_batch(pyr_ref, pyr_new, Xd, p0, cam, cfg)

    main_ms = cuda_ms(torch, main_call)
    main_dev_ms, main_ops = device_ms(torch, main_call, reps=1)
    k1_args = (k1_in["level"], k1_in["qimg"], k1_in["uv"], k1_in["origins"], psz, pad, win)
    f32, b16 = k2_in[torch.float32], k2_in[torch.bfloat16]
    pairs = {
        "K1": (lambda: patch_gather.gather_ref_grad_windows(*k1_args),
               lambda: patch_gather.gather_ref_grad_windows_plain(*k1_args)),
        "K2": (lambda: icgn_iter.fused_resample_project(*f32, *taps),
               lambda: icgn_iter.fused_resample_project_plain(*f32, *taps)),
        "K2_bf16": (lambda: icgn_iter.fused_resample_project(*b16, *taps),
                    lambda: icgn_iter.fused_resample_project_plain(*b16, *taps)),
        "K3": (lambda: icgn_iter.fused_resample_pdiff(*f32[:2], *taps),
               lambda: icgn_iter.fused_resample_pdiff_plain(*f32[:2], *taps)),
    }
    times = {k: {"ms": device_ms(torch, kern)[0], "plain_ms": device_ms(torch, plain)[0],
                 "wall_ms": cuda_ms(torch, kern), "plain_wall_ms": cuda_ms(torch, plain)}
             for k, (kern, plain) in pairs.items()}
    print(f"[{card}] main path B={B} N={N} 1280x720: wall {main_ms:.3f} ms/call "
          f"(CUDA events, median of 10) = {B / main_ms * 1e3:.1f} pairs/s; device busy "
          f"{main_dev_ms:.3f} ms/call in {main_ops:.0f} device ops "
          f"({main_dev_ms / main_ms:.1%} of the wall time)")
    for k, t in times.items():
        print(f"[{card}] {k} at {M} points: device {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f} ms); wall {t['wall_ms']:.4f} ms (plain "
              f"{t['plain_wall_ms']:.4f} ms)")

    def entry(name, source, replaces, launches_n, err_, key):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_n, "max_abs_err": err_, "max_abs_diff": err_,
                **times[key]}

    kernels = [
        entry("K1 gather_ref_grad_windows", "invcompcamtrack_torch/csrc/patch_gather.cu",
              "invcompcamtrack_tpu/ops/patch_pallas.py:413", launches["K1"], k1_err, "K1"),
        entry("K2 fused_resample_project", "invcompcamtrack_torch/csrc/icgn_iter.cu",
              "invcompcamtrack_tpu/ops/icgn_iter_pallas.py:172", launches["K2"], k2_err, "K2"),
    ]
    # K3 has no caller on the main path (nor in the JAX package): it is
    # held against its plain version above and reported on its own line
    off_path = [entry("K3 fused_resample_pdiff", "invcompcamtrack_torch/csrc/icgn_iter.cu",
                      "invcompcamtrack_tpu/ops/icgn_iter_pallas.py:132", launches["K3"],
                      k3_err, "K3")]
    print(json.dumps({"main_path": {
        "card": card, "pairs_per_s": B / main_ms * 1e3, "ms_per_call": main_ms,
        "device_busy_ms_per_call": main_dev_ms, "device_ops_per_call": main_ops,
        "median_center_err": med_err, "cpu_pose_err": pose_err, "build_s": build_s}}))
    print(json.dumps({"kernels_off_main_path": off_path}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
