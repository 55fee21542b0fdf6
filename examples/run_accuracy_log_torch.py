"""The accuracy log of the PyTorch/CUDA port: long-sequence VO accuracy
on documented synthetic benchmarks, the counterpart of
``examples/run_accuracy_log.py`` function by function (reference:
misc_src/pose_tracking_acc.txt:1-57, produced by the sequence scripts
run_odometer_test.m:197-250 and misc_src/run_test_OF_track.py).

The sequences, scenes, BA modes and polish-gate sweep are the JAX
example's: a textured multi-depth CORRIDOR (ground, walls and back plane,
depth 4-40 units, occlusion boundaries) for the forward-drive and turn
workloads, and the textured ground PLANE for the lateral sweeps, both
rendered exactly at any pose, so ATE is against exact ground truth.
Each sequence runs under the BA modes ``off`` (no refinement),
``structure`` (landmarks refined against measured observations),
``full`` (joint windowed BA) and ``hybrid`` (the engine default).

Where the port departs from the JAX example:

- ``_exp`` is the port's ``core/lie.py::se3_exp`` in float64 on the CPU
  (the JAX example asks JAX for float64, which a process without x64
  truncates to float32).
- ``off`` makes the BA gate unreachable, as in the JAX example; the port
  still computes the window BA on every keyframe and drops its result
  (the JAX engine's ``lax.cond`` skips it), so its rows equal the JAX
  example's while its fps pays for a BA per keyframe.
- The self-initialised sequence draws its 256 eight-point samples from
  a CPU ``torch.Generator`` (seeded with 0), not from JAX's key: its row
  matches the JAX example's in trend only.
- ``--quick`` rows (quarter length) are marked in both outputs, and
  ``--merge`` keeps them apart from full-length rows of other runs.

Writes ACCURACY_torch.md and accuracy_log_torch.json in the working
directory; runs on the card unless ``--device cpu`` is given.

Usage:  python examples/run_accuracy_log_torch.py [--quick] [--only a,b]
        [--merge [OTHER_LOG.json ...]] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from invcompcamtrack_torch.config import ICGNParams
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.device import card_line, resolve
from invcompcamtrack_torch.vo import synthetic
from invcompcamtrack_torch.vo.engine import VisualOdometry, VOConfig
from invcompcamtrack_torch.vo.metrics import ate_rmse, rpe_rot, rpe_trans

LOG_JSON = "accuracy_log_torch.json"


def _exp(p):
    return lie.se3_exp(torch.as_tensor(np.asarray(p), dtype=torch.float64)).numpy()


def _centers(poses):
    return np.stack([-_exp(p)[:, :3].T @ _exp(p)[:, 3] for p in poses])


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# sequence definitions


def path_corridor_fwd(n):
    """Forward drive down the corridor with gentle sway + yaw wobble."""
    rng = np.random.default_rng(11)
    poses = [np.zeros(6)]
    for i in range(1, n):
        d = np.r_[0.01 * np.sin(i * 0.15), 0.004 * np.sin(i * 0.23), 0.06,
                  0.0015 * np.sin(i * 0.11), 0.002 * np.sin(i * 0.17),
                  rng.normal() * 3e-4]
        poses.append(poses[-1] + d)
    return np.stack(poses)


def path_corridor_turn(n):
    """Forward + sustained yaw: the camera sweeps across the walls."""
    poses = [np.zeros(6)]
    for i in range(1, n):
        yaw = 0.004 * np.sin(i * 2 * np.pi / n * 2)  # S-curve
        poses.append(poses[-1] + np.r_[0.0, 0.002 * np.sin(i * 0.2), 0.035,
                                       0.0, yaw, 0.0])
    return np.stack(poses)


def path_plane_sweep(n):
    """Strong lateral sweep over the ground plane: landmark turnover."""
    poses = [np.zeros(6)]
    for i in range(1, n):
        poses.append(poses[-1] + np.r_[0.05, 0.004 * np.sin(i * 0.3), 0.008,
                                       1e-3 * np.sin(i * 0.12), 2e-3, 0.0])
    return np.stack(poses)


def path_bench_lateral(n):
    """The engine bench's scenario (bench.py::bench_engine) at 1280x720:
    dominant-lateral drive (dx 0.02, dz 0.01 per frame, forwardness
    ~0.4) over the textured plane, the sequence that set the hybrid
    polish's forwardness gate."""
    rng = np.random.default_rng(1)
    poses = [np.zeros(6)]
    for i in range(1, n):
        poses.append(poses[-1] + np.r_[0.02, 0.01 * np.sin(i * 0.3), 0.01,
                                       rng.normal(size=3) * 0.001])
    return np.stack(poses)


def path_sweep_local(n):
    """Oscillating lateral sweep (x amplitude ~1.2 units) that keeps a
    fixed map in view: lateral baselines make landmark positions
    observable, so point refinement can repair an injected map error."""
    poses = [np.zeros(6)]
    w = 2 * np.pi * 2.0 / n
    for i in range(1, n):
        dx = 1.2 * w * np.cos(i * w)
        poses.append(poses[-1] + np.r_[dx, 0.0, 0.0, 0.0, 0.0, 0.0])
    return np.stack(poses)


def _surface_rms(scene, landmarks, valid):
    """RMS distance of the live map to the true scene surfaces (the
    point-refinement quality the reference's log tracks)."""
    X = _np(landmarks)[_np(valid)]
    if X.shape[0] == 0:
        return float("nan")
    if isinstance(scene, synthetic.CorridorScene):
        d = np.abs(X @ scene.normals.T - scene.offsets)  # (N, P)
        d = d.min(axis=1)
    else:
        d = np.abs(X[:, 2] - scene.z0)
    return float(np.sqrt(np.mean(d ** 2)))


def run_sequence(name, scene, render, sample_pts, poses_gt, ba_mode,
                 self_init=False, chunk=20, imgs=None, cfg_overrides=None,
                 seed_noise=0.0, seed_noise_mode="absolute", tracker=None,
                 device=None, keep_poses=False):
    """One sequence under one BA mode -> its row (the JAX example's keys).
    ``keep_poses`` adds the (n, 6) estimated poses under ``"poses"``."""
    dev = resolve(device)
    wh = scene.wh
    if tracker is None:
        tracker = ICGNParams(lv_f=3, lv_l=0, psz=8, maxiter=8,
                             normdp_ratio=0.01)
    window = 5
    base = dict(tracker=tracker, max_landmarks=512, window=window,
                keyframe_stride=2, corners_per_kf=512,
                min_parallax_px=1.0,
                ba_mode="structure" if ba_mode == "off" else ba_mode,
                # "off": make the BA gate unreachable
                min_kf_for_ba=window + 1 if ba_mode == "off" else 3)
    base.update(cfg_overrides or {})
    cfg = VOConfig(**base)
    cam = CameraPyramid.create(scene.fc, scene.cc, wh,
                               cfg.tracker.num_levels, cfg.tracker.psz, device=dev)
    vo = VisualOdometry(cam, scene.fc, scene.cc, cfg, device=dev)

    n = len(poses_gt)
    t_render0 = time.perf_counter()
    if imgs is None:
        imgs = [render(scene, _exp(p)) for p in poses_gt]
    t_render = time.perf_counter() - t_render0

    rng = np.random.default_rng(5)
    if self_init:
        vo.bootstrap_from_images(imgs[0], imgs[1])
    else:
        seeds = sample_pts(scene, rng, 400)
        if seed_noise > 0.0:
            # the reference's refinement scenario: the 3D map the
            # tracker is given is noisy (misc_src/pose_tracking_acc.txt:
            # 1-26).  "absolute" = isotropic sigma in world units;
            # "depth" = relative error along the founding view rays.
            if seed_noise_mode == "depth":
                G0 = _exp(poses_gt[0])
                c0 = -G0[:, :3].T @ G0[:, 3]
                eta = rng.normal(size=(seeds.shape[0], 1)) * seed_noise
                seeds = c0 + (seeds - c0) * (1.0 + eta)
            else:
                seeds = seeds + rng.normal(size=seeds.shape) * seed_noise
        vo.bootstrap(imgs[0], imgs[1], poses_gt[0], poses_gt[1], seeds)

    poses_est = [np.asarray(poses_gt[0], np.float32), _np(vo.state.cur_pose)]
    t0 = time.perf_counter()
    # uniform chunks, the remainder frame by frame; fps is the median
    # chunk rate with the first chunk excluded (the JAX example's method)
    i = 2
    chunk_dts = []
    while i + chunk <= n:
        t_c = time.perf_counter()
        out = vo.run_frames(np.stack(imgs[i:i + chunk]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        chunk_dts.append(time.perf_counter() - t_c)
        poses_est.extend(list(out))
        i += chunk
    for j in range(i, n):
        poses_est.append(vo.process_frame(imgs[j]))
    t_track = time.perf_counter() - t0
    steady = chunk_dts[1:] if len(chunk_dts) > 1 else chunk_dts
    t_med = float(np.median(steady)) if steady else t_track / max(n - 2, 1)

    poses_est = np.stack(poses_est)
    c_est = _centers(poses_est)
    c_gt = _centers(poses_gt)
    R_est = np.stack([_exp(p)[:, :3] for p in poses_est])
    R_gt = np.stack([_exp(p)[:, :3] for p in poses_gt])
    path_len = float(np.sum(np.linalg.norm(np.diff(c_gt, axis=0), axis=1)))

    t64 = torch.from_numpy
    with_scale = bool(self_init)  # monocular scale is free when self-init
    ate = float(ate_rmse(t64(c_est), t64(c_gt), with_scale=with_scale))
    ate_un = float(ate_rmse(t64(c_est), t64(c_gt), align=False)) if not self_init else float("nan")
    rpe_t = float(rpe_trans(t64(c_est), t64(c_gt)))
    rpe_r = float(rpe_rot(t64(R_est), t64(R_gt)))
    final_drift = (float(np.linalg.norm(c_est[-1] - c_gt[-1]))
                   if not self_init else float("nan"))

    row = {
        "sequence": name, "ba_mode": ba_mode, "frames": n,
        "image": f"{wh[0]}x{wh[1]}", "path_len": round(path_len, 3),
        "ate_rmse": ate, "ate_rmse_unaligned": ate_un,
        "ate_pct_path": 100.0 * ate / path_len,
        "final_drift": final_drift,
        "rpe_trans": rpe_t, "rpe_rot_deg": float(np.degrees(rpe_r)),
        "map_surface_rms": _surface_rms(scene, vo.landmarks, vo.lm_valid),
        "landmarks_alive": int(_np(vo.lm_valid).sum()),
        "track_s": round(t_track, 2), "render_s": round(t_render, 2),
        "fps_engine": round(chunk / t_med, 2) if steady else float("nan"),
        "fps_method": "median steady-state chunk rate (first chunk excl.)",
        "self_init": self_init,
    }
    if keep_poses:
        row["poses"] = poses_est
    return row


# ---------------------------------------------------------------------------
# the log


def sequences(quick=False):
    """The JAX example's seven sequences: (name, scene, render, sample,
    path, self_init, seed_noise, cfg_overrides, modes, tracker)."""
    q = 4 if quick else 1
    rng = np.random.default_rng(0)
    corridor = synthetic.make_corridor(rng, wh=(640, 480), fc=(520.0, 525.0))
    plane = synthetic.make_scene(rng, wh=(640, 480), fc=(520.0, 525.0),
                                 z0=8.0, freq_range=(0.5, 6.0))
    # the engine bench's 720p scene (bench.py::bench_engine, rng(1))
    plane720 = synthetic.make_scene(np.random.default_rng(1),
                                    wh=(1280, 720), fc=(1000.0, 1200.0),
                                    z0=8.0, freq_range=(0.5, 6.0))
    # lateral-720p reproduces the engine bench's tracker (lv_f=4, maxiter=10)
    bench_tracker = ICGNParams(lv_f=4, lv_l=0, psz=8, maxiter=10)
    plane_pts = lambda s, r, n: synthetic.sample_plane_points(s, r, n, margin=24)  # noqa: E731

    # a FIXED noisy map (the reference's "without / with 3d point position
    # refinement"): no new triangulations, no retirement, and the
    # re-observation and BA residual gates opened wide enough to see the
    # injected error (~sigma*f/z px)
    fixedmap_ov = {"min_parallax_px": 1e9, "max_obs_fail": 10 ** 6,
                   "reobs_gate_px": 48.0, "ba_obs_gate_px": 48.0}
    # the lateral variant also opens the spectral observability floor
    # (5e-3 -> 1e-4), which otherwise refuses to correct an injected depth
    # error; the forward corridor keeps it (depth is unobservable there)
    fixedmap_lat_ov = dict(fixedmap_ov, ba_lm_eig_floor=1e-4)
    return [
        ("corridor-fwd", corridor, synthetic.render_corridor,
         synthetic.sample_corridor_points, path_corridor_fwd(200 // q),
         False, 0.0, None, None, None),
        ("corridor-turn", corridor, synthetic.render_corridor,
         synthetic.sample_corridor_points, path_corridor_turn(120 // q),
         False, 0.0, None, None, None),
        ("plane-sweep", plane, synthetic.render, plane_pts,
         path_plane_sweep(160 // q), False, 0.0, None, None, None),
        ("corridor-noisymap", corridor, synthetic.render_corridor,
         synthetic.sample_corridor_points, path_corridor_fwd(200 // q),
         False, 0.25, fixedmap_ov, ["off", "structure", "hybrid"], None),
        ("plane-noisymap", plane, synthetic.render, plane_pts,
         path_sweep_local(160 // q), False, 0.25, fixedmap_lat_ov,
         ["off", "structure", "hybrid"], None),
        ("corridor-selfinit", corridor, synthetic.render_corridor,
         synthetic.sample_corridor_points, path_corridor_fwd(100 // q),
         True, 0.0, None, None, None),
        ("lateral-720p", plane720, synthetic.render, plane_pts,
         path_bench_lateral(120 // q), False, 0.0, None, None, bench_tracker),
    ]


# the polish-gate sweep (hybrid mode) on the forward, hard-lateral and the
# bench's dominant-lateral regimes
SWEEP_SEQUENCES = ("corridor-fwd", "plane-sweep", "lateral-720p")
SWEEPS = [
    ("tp=1.5 tf=0 (parallax gate only)", {"polish_min_forwardness": 0.0}),
    ("tp=1.5 tf=0.5", {"polish_min_forwardness": 0.5}),
    ("tp=1.5 tf=0.7 (DEFAULT)", {}),
    ("tp=1.5 tf=0.85", {"polish_min_forwardness": 0.85}),
    ("tp=3.0 tf=0.7", {"polish_max_parallax_deg": 3.0}),
    ("tf=0.7 + info-weighted prior", {"odo_info_weighted": True}),
]


def run_log(seqs, device=None, quick=False, report=print):
    """Every mode of every sequence in ``seqs`` (and the sweep where it
    applies) -> (rows, sweep_rows)."""
    rows, sweep_rows = [], []
    for (name, scene, render, sample, path, self_init, seed_noise,
         overrides, mode_list, trk) in seqs:
        modes = mode_list if mode_list else (
            ["hybrid"] if self_init else ["off", "structure", "full", "hybrid"])
        imgs = [render(scene, _exp(p)) for p in path]  # render once per seq
        for mode in modes:
            r = run_sequence(name, scene, render, sample, path, mode,
                             self_init=self_init, imgs=imgs,
                             seed_noise=seed_noise, cfg_overrides=overrides,
                             tracker=trk, device=device)
            r["quick"] = quick
            rows.append(r)
            report(json.dumps(r))
        if name in SWEEP_SEQUENCES:
            for tag, ov in SWEEPS:
                r = run_sequence(name, scene, render, sample, path, "hybrid",
                                 imgs=imgs, cfg_overrides=ov, tracker=trk,
                                 device=device)
                r["sweep"] = tag
                r["quick"] = quick
                sweep_rows.append(r)
                report(json.dumps(r))
    return rows, sweep_rows


def _frames(r):
    return f"{r['frames']} (quarter)" if r.get("quick") else f"{r['frames']}"


def table_lines(rows):
    """The JAX example's accuracy table, one line per row."""
    lines = []
    for r in rows:
        # self-init has a free global scale: only the aligned ATE means
        # something (the Umeyama alignment absorbs the scale factor)
        na = r["self_init"]
        drift = "n/a (scale)" if na else f"{r['final_drift']:.4f}"
        rpet = "n/a (scale)" if na else f"{r['rpe_trans']:.5f}"
        mrms = "n/a (scale)" if na else f"{r['map_surface_rms']:.4f}"
        lines.append(
            f"| {r['sequence']}{' (self-init)' if r['self_init'] else ''} "
            f"| {_frames(r)} | {r['ba_mode']} | {r['ate_rmse']:.4f} "
            f"| {r['ate_pct_path']:.3f}% | {drift} "
            f"| {rpet} | {r['rpe_rot_deg']:.4f} "
            f"| {mrms} | {r['landmarks_alive']} "
            f"| {r['fps_engine']:.1f} |")
    return lines


def sweep_lines(sweep_rows):
    return [f"| {r['sequence']}{' (quarter)' if r.get('quick') else ''} | {r['sweep']} "
            f"| {r['ate_rmse']:.4f} | {r['rpe_trans']:.5f} |" for r in sweep_rows]


def notes(rows):
    """The runs' remarks (``--note``), each with the sequences it covers."""
    by_note = {}
    for r in rows:
        if r.get("note"):
            by_note.setdefault(r["note"], []).append(r["sequence"])
    return "".join(f"\nNote on {', '.join(dict.fromkeys(seqs))}: {note}\n"
                   for note, seqs in by_note.items())


def render_doc(card, rows, sweep_rows):
    hdr = ("| sequence | frames | BA mode | ATE RMSE | ATE %path | "
           "final drift | RPE trans | RPE rot (deg) | map RMS | "
           "landmarks | fps |\n|---|---|---|---|---|---|---|---|---|---|---|\n")
    return f"""# Recorded VO accuracy log of the PyTorch/CUDA port

Generated by `python examples/run_accuracy_log_torch.py` on `{card}`
(the card's name and power limit as `nvidia-smi` gives them).  The JAX
package's log of the same sequences is `ACCURACY.md`.

No KITTI/EuRoC images are at hand, so these are long synthetic
sequences on exactly-rendered worlds: a multi-depth textured corridor
(depth 4-40 units, occlusion boundaries) and a textured ground plane;
ATE is against exact ground truth.  The BA modes:

- `off`: pure photometric odometer (no refinement).  The port still
  computes the window BA on every keyframe and drops its result, so the
  rows equal the JAX engine's (which skips it) while the fps column pays
  for a BA per keyframe.
- `structure`: poses from the odometer; BA refines the landmark map
  against measured observations.
- `full`: joint pose+point windowed BA with odometry-prior factors.
- `hybrid` (the engine default): observability-routed BA; the pose
  polish fires only in low-parallax, forward-motion windows.

The `corridor-noisymap` and `plane-noisymap` rows run the reference's
refinement scenario: a fixed noisy 3D point set (seed noise 0.25, no new
triangulations, no retirement) tracked without and with point refinement
(reference: misc_src/pose_tracking_acc.txt:1-26).  `plane-noisymap`
also opens the BA's spectral observability floor to 1e-4.

The self-initialised row draws its 256 eight-point samples from a CPU
`torch.Generator`, not from JAX's key: compare it with the JAX log in
trend only.  Rows marked "(quarter)" ran at a quarter of the sequence's
length (`--quick`).

- ATE RMSE: absolute trajectory error, world units (unaligned for
  GT-bootstrapped runs; Umeyama-aligned with scale for self-init).
- ATE %path: ATE over the trajectory's length.
- map RMS: RMS distance of live landmarks to the true scene surfaces.
- fps: engine frames/s over `run_frames` chunks of 20 frames, keyframe
  work included, rendering excluded; the median chunk rate, the first
  chunk excluded.

{hdr}{chr(10).join(table_lines(rows))}
{notes(rows + sweep_rows)}
## Appendix: polish-gate sweep (hybrid mode)

The hybrid pose polish is gated by window mean parallax
(`polish_max_parallax_deg`, tp) and motion forwardness
(`polish_min_forwardness`, tf), on the forward (corridor-fwd), hard
lateral (plane-sweep) and the engine bench's dominant-lateral 720p
regimes; the last row weights the odometry prior by the tracker's own
Fisher information (`odo_info_weighted`).

| sequence | gate | ATE RMSE | RPE trans |
|---|---|---|---|
{chr(10).join(sweep_lines(sweep_rows))}

Raw rows: `{LOG_JSON}`.
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="quarter-length sequences, marked as such")
    ap.add_argument("--out", default="ACCURACY_torch.md")
    ap.add_argument("--only", default=None,
                    help="comma-separated sequence names to (re)run")
    ap.add_argument("--merge", nargs="*", default=None, metavar="JSON",
                    help=f"keep the rows of sequences not re-run (combine with "
                         f"--only) from {LOG_JSON} and any logs named, the first "
                         "file that holds a sequence winning")
    ap.add_argument("--note", default=None,
                    help="a remark on how this run was made (e.g. other processes "
                         "sharing the card), kept with its rows and listed in --out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    card = card_line(dev)
    print(card, flush=True)

    seqs = sequences(args.quick)
    order = [s[0] for s in seqs]
    if args.only:
        keep = set(args.only.split(","))
        seqs = [s for s in seqs if s[0] in keep]
    rows, sweep_rows = run_log(seqs, dev, args.quick,
                               report=lambda s: print(f"[{card}] {s}", flush=True))
    for r in rows + sweep_rows:
        r["device"] = card
        if args.note:
            r["note"] = args.note

    if args.merge is not None:
        ran = {s[0] for s in seqs}
        old_rows, old_sweep = [], []
        for path in [LOG_JSON, *args.merge]:
            if not os.path.exists(path):
                continue
            with open(path) as f:
                old = json.load(f)
            new = {r["sequence"] for r in old.get("rows", [])} - ran
            old_rows += [r for r in old.get("rows", []) if r["sequence"] in new]
            old_sweep += [r for r in old.get("polish_gate_sweep", []) if r["sequence"] in new]
            ran |= new
        rows, sweep_rows = old_rows + rows, old_sweep + sweep_rows
        # the JAX example's sequence order, modes and sweeps in their order
        rows.sort(key=lambda r: order.index(r["sequence"]))
        sweep_rows.sort(key=lambda r: order.index(r["sequence"]))
    # each row keeps the card it ran on: merged rows may come from calls
    # on other cards or at other power limits
    cards = list(dict.fromkeys(r.get("device", "?") for r in rows + sweep_rows))
    with open(LOG_JSON, "w") as f:
        json.dump({"device": "; ".join(cards), "rows": rows,
                   "polish_gate_sweep": sweep_rows}, f, indent=1)
    with open(args.out, "w") as f:
        f.write(render_doc("; ".join(cards), rows, sweep_rows))
    print(f"wrote {args.out} + {LOG_JSON}")
    return rows, sweep_rows


if __name__ == "__main__":
    main()
