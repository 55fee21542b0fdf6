"""The JAX package's figures that the example twins (``examples/*_torch.py``)
are compared with: runs the JAX examples' own functions on the
CPU, at the twins' inputs, and prints one JSON line per row.  With
``--port`` it runs the twin's function instead (on the CPU), and with
``--float64`` either engine in float64, which is how the float32
sensitivities in ROADMAP Queue 3 were measured.  Not a test; from the
repository root:

    JAX_PLATFORMS=cpu python tests/jax_reference.py tripwire [--x64]
    JAX_PLATFORMS=cpu python tests/jax_reference.py log plane-sweep --modes full [--float64] [--port]
    JAX_PLATFORMS=cpu python tests/jax_reference.py suite forward [--float64] [--port]
    ... [--frames N] [--poses FILE.npy]
    JAX_PLATFORMS=cpu python tests/jax_reference.py degraded --x64 [--float64] [--port]

``tripwire`` is ``bench.py::bench_noisymap_gain``'s workload (both
modes); ``log`` one sequence of the accuracy log; ``suite`` one GT-started
profile of the accuracy suite, seeded as the twin seeds it
(``zlib.crc32``); ``degraded`` ``chip_smoke.py`` 11b's sequence, with the
per-frame poses.  The NCC evaluation and the flow-EPE harness are the JAX
examples themselves (``python examples/run_ncc_eval.py``, ``python
examples/run_flow_epe.py --out OTHER.md``).  Without ``--x64`` the JAX
accuracy log's ``_exp`` falls back to float32, as when its script runs
as a script; the twin's is float64, so compare frame by frame with
``--x64`` (a float32-sensitive sequence such as ``degraded`` parts
otherwise).  Nothing is written but the ``--poses`` file; the JAX
examples' persistent compilation cache stays off.
"""

import argparse
import functools
import importlib.util
import json
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
FIXEDMAP = {"min_parallax_px": 1e9, "max_obs_fail": 10 ** 6, "reobs_gate_px": 48.0,
            "ba_obs_gate_px": 48.0}


class _Seed(int):
    """The twin's seed, kept whole by the JAX suite's ``hash(profile) %
    2**31``: forward's ``zlib.crc32`` is over 2**31."""

    def __mod__(self, m):
        return int(self)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def modules(args):
    """(accuracy log, robustness, suite) modules of one package, their
    engines in float64 where asked."""
    if args.port:
        import torch

        torch.set_num_threads(4)
        dtype, names = torch.float64, ("run_accuracy_log_torch", "run_robustness_torch",
                                       "run_accuracy_suite_torch")
    else:
        import jax
        import jax.numpy as jnp

        jax.config.update("jax_platforms", "cpu")
        if args.x64 or args.float64:
            jax.config.update("jax_enable_x64", True)
        from invcompcamtrack_tpu.utils import jaxcache

        jaxcache.enable = lambda *a, **k: None
        dtype, names = jnp.float64, ("run_accuracy_log", "run_robustness", "run_accuracy_suite")
    sys.path.insert(0, str(ROOT / "examples"))
    acc, rob, suite = (_load(n) for n in names)
    if not args.port:
        suite.hash = lambda p: _Seed(zlib.crc32(p.encode()))  # the twin's seed
    if args.float64:
        acc.VisualOdometry = functools.partial(acc.VisualOdometry, dtype=dtype)
        if args.port:
            suite.VisualOdometry = functools.partial(suite.VisualOdometry, dtype=dtype)
        else:
            import invcompcamtrack_tpu.vo.engine as jeng

            jeng.VisualOdometry = functools.partial(jeng.VisualOdometry, dtype=dtype)
    return acc, rob, suite


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=("tripwire", "log", "suite", "degraded"))
    ap.add_argument("name", nargs="?", default=None)
    ap.add_argument("--modes", default=None)
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--x64", action="store_true", help="JAX x64 (float64 poses)")
    ap.add_argument("--port", action="store_true", help="the twin, on the CPU")
    ap.add_argument("--frames", type=int, default=None,
                    help="log/suite: the first FRAMES frames of the sequence")
    ap.add_argument("--poses", default=None,
                    help="save the estimated per-frame poses (log: (n, 6); suite: the "
                         "(n, 3) centres) to this .npy file")
    args = ap.parse_args()
    acc, rob, suite = modules(args)
    synthetic = acc.synthetic
    kw = {"device": "cpu"} if args.port else {}
    t0 = time.perf_counter()

    if args.case == "suite":
        if args.poses:  # the trajectory that run_sequence hands to ate_rmse
            if args.port:
                ate = suite.ate_rmse
                suite.ate_rmse = lambda t, g, **k: (np.save(args.poses, np.asarray(t)),
                                                    ate(t, g, **k))[1]
            else:
                import invcompcamtrack_tpu.vo.metrics as jmet

                ate = jmet.ate_rmse
                jmet.ate_rmse = lambda t, g, **k: (np.save(args.poses, np.asarray(t)),
                                                   ate(t, g, **k))[1]
        r = suite.run_sequence(args.name, args.frames or 200, False, **kw)
        print(json.dumps({**r, "seconds": time.perf_counter() - t0}))
        return

    rng = np.random.default_rng(0)
    corridor = synthetic.make_corridor(rng, wh=(640, 480), fc=(520.0, 525.0))
    plane = synthetic.make_scene(rng, wh=(640, 480), fc=(520.0, 525.0), z0=8.0,
                                 freq_range=(0.5, 6.0))
    plane720 = synthetic.make_scene(np.random.default_rng(1), wh=(1280, 720),
                                    fc=(1000.0, 1200.0), z0=8.0, freq_range=(0.5, 6.0))
    pts = lambda s, r, n: synthetic.sample_plane_points(s, r, n, margin=24)  # noqa: E731
    cor = (corridor, synthetic.render_corridor, synthetic.sample_corridor_points)
    pla = (plane, synthetic.render, pts)
    lat = dict(FIXEDMAP, ba_lm_eig_floor=1e-4)
    # name: (scene, render, sample, path, seed noise, overrides, modes, tracker)
    seqs = {
        "tripwire": (*pla, acc.path_sweep_local(80), 0.25, lat, "off,structure", None),
        "corridor-fwd": (*cor, acc.path_corridor_fwd(200), 0.0, None, None, None),
        "corridor-turn": (*cor, acc.path_corridor_turn(120), 0.0, None, None, None),
        "plane-sweep": (*pla, acc.path_plane_sweep(160), 0.0, None, None, None),
        "corridor-noisymap": (*cor, acc.path_corridor_fwd(200), 0.25, FIXEDMAP,
                              "off,structure,hybrid", None),
        "plane-noisymap": (*pla, acc.path_sweep_local(160), 0.25, lat, "off,structure,hybrid",
                           None),
        "lateral-720p": (plane720, synthetic.render, pts, acc.path_bench_lateral(120), 0.0, None,
                         None, acc.ICGNParams(lv_f=4, lv_l=0, psz=8, maxiter=10)),
    }
    if args.case == "degraded":
        scene, render, sample = cor
        path = acc.path_corridor_fwd(20)
        clean = [render(scene, acc._exp(p)) for p in path]
        imgs = synthetic.degrade_sequence(clean, np.random.default_rng(99),
                                          **dict(rob.LEVELS)["heavy"])
        # the estimated poses are the first sequence that run_sequence
        # hands to _centers
        seen = []
        centers = acc._centers
        acc._centers = lambda p: (seen.append(np.asarray(p, np.float64)), centers(p))[1]
        r = acc.run_sequence("corridor-fwd", scene, render, sample, path, "hybrid", imgs=imgs,
                             cfg_overrides={"tracker": rob._tracker(True)}, **kw)
        if args.poses:
            np.save(args.poses, seen[0])
        print(json.dumps({"ate_rmse": r["ate_rmse"], "map_surface_rms": r["map_surface_rms"],
                          "poses": seen[0].tolist(), "seconds": time.perf_counter() - t0}))
        return

    name = "tripwire" if args.case == "tripwire" else args.name
    scene, render, sample, path, noise, ov, modes, trk = seqs[name]
    path = path[:args.frames]  # the paths are the same up to any frame
    imgs = [render(scene, acc._exp(p)) for p in path]
    seen = []
    centers = acc._centers
    acc._centers = lambda p: (seen.append(np.asarray(p, np.float64)), centers(p))[1]
    poses = {}
    for mode in (args.modes or modes or "off,structure,full,hybrid").split(","):
        seen.clear()
        r = acc.run_sequence(name, scene, render, sample, path, mode, imgs=imgs,
                             seed_noise=noise, cfg_overrides=ov, tracker=trk, **kw)
        poses[mode] = seen[0]
        print(json.dumps({**r, "seconds": time.perf_counter() - t0}), flush=True)
    if args.poses:
        np.save(args.poses, np.stack(list(poses.values())))


if __name__ == "__main__":
    main()
