"""Worlds of gloo ranks for the port's multi-device tests, and the jobs
their ranks run.

This module imports only the standard library, numpy, torch and the port:
a spawned rank re-imports the module that holds its target, and JAX must
stay out of it (the ``test_torch_*.py`` files import JAX).  The tests make
their inputs with numpy and hand them to the ranks as job arguments.

``run_world(n, jobs, tmp)`` runs a gloo world of n CPU ranks through
the port's ``parallel/runtime.py::spawn_world`` (``spawn`` context,
``file://`` rendezvous under ``tmp``, ranks joined by a deadline and
killed past it, results or tracebacks back by pickle); each rank
initialises its group with ``initialize_distributed`` and runs every job
in turn.  Every collective carries a 60 s timeout.
"""

from __future__ import annotations

import numpy as np
import torch

JOIN_TIMEOUT_S = 300.0
COLLECTIVE_TIMEOUT_S = 60.0


# ---------------------------------------------------------------------------
# the world


def _rank_main(rank: int, n: int, init_method: str, jobs):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from invcompcamtrack_torch.parallel.runtime import initialize_distributed

    ok = initialize_distributed(coordinator=init_method, num_processes=n, process_id=rank,
                                backend="cpu", retries=1, timeout_s=COLLECTIVE_TIMEOUT_S)
    assert ok and dist.get_world_size() == n
    results = [globals()[name](**kw) for name, kw in jobs]
    dist.destroy_process_group()
    return results


def run_world(n: int, jobs, tmp, timeout_s: float = JOIN_TIMEOUT_S):
    """Run ``jobs`` (a list of ``(function name in this module, kwargs)``)
    on every rank of a gloo world of ``n`` CPU ranks.  Returns, per rank,
    the list of the jobs' results; raises if a rank failed or hung."""
    from invcompcamtrack_torch.parallel.runtime import spawn_world

    return spawn_world(_rank_main, n, tmp, timeout_s, args=(jobs,))


def assert_ranks_equal(values) -> None:
    """The ranks' results are equal bit for bit (nested tuples/lists/dicts
    of arrays and scalars)."""
    first = values[0]
    for other in values[1:]:
        _assert_same(first, other)


def _assert_same(a, b) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# jobs (each runs on every rank; arguments are numpy arrays and scalars)


def _mesh(names, shape=None):
    from torch.distributed.device_mesh import init_device_mesh
    import torch.distributed as dist

    shape = shape or (dist.get_world_size(),)
    return init_device_mesh("cpu", shape, mesh_dim_names=tuple(names))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x


def _tensors(d: dict, cls):
    return cls(**{k: (None if v is None else torch.tensor(np.asarray(v)))
                  for k, v in d.items()})


def job_ba_sharded(prob: dict, kw: dict, odo: dict | None = None, axis: str = "model"):
    """``ba_solve_sharded`` over a 1-D mesh of the whole world."""
    from invcompcamtrack_torch.ba.distributed import ba_solve_sharded
    from invcompcamtrack_torch.ba.window import BAProblem, OdoFactors

    kw = dict(kw)
    if odo is not None:
        kw["odo"] = _tensors(odo, OdoFactors)
    if isinstance(kw.get("motion_only"), np.ndarray):
        kw["motion_only"] = torch.tensor(kw["motion_only"])
    out = ba_solve_sharded(_tensors(prob, BAProblem), _mesh((axis,)), axis=axis, **kw)
    return _np(out)


def job_temporal(prob: dict, kw: dict, axis: str = "seq"):
    """``temporal_ba_solve`` over a 1-D mesh of the whole world."""
    from invcompcamtrack_torch.ba.temporal import TemporalBAProblem, temporal_ba_solve
    from invcompcamtrack_torch.convert import temporal_problem_from_numpy

    kw = dict(kw)
    if isinstance(kw.get("motion_only"), np.ndarray):
        kw["motion_only"] = torch.tensor(kw["motion_only"])
    tprob = temporal_problem_from_numpy(TemporalBAProblem(**prob), "cpu")
    return _np(temporal_ba_solve(tprob, _mesh((axis,)), axis=axis, **kw))


def job_raises(what: str):
    """The name of the exception a misuse raises on this world."""
    import torch.distributed as dist

    from invcompcamtrack_torch.ba.temporal import TemporalBAProblem, temporal_ba_solve
    from invcompcamtrack_torch.parallel.mesh import make_mesh
    from invcompcamtrack_torch.parallel.pipeline import pipeline_run

    n = dist.get_world_size()
    try:
        if what == "temporal_window":
            K = n + 1
            z = torch.zeros
            tprob = TemporalBAProblem(
                poses=z(K, 6), landmarks=z(4, 3), obs=z(K, 4, 2),
                mask=torch.ones(K, 4, dtype=torch.bool), fx=torch.tensor(1.0),
                fy=torch.tensor(1.0), cx=torch.tensor(0.0), cy=torch.tensor(0.0),
                fixed_pose_mask=torch.zeros(K, dtype=torch.bool), odom=z(K, 6),
                odom_weight=torch.tensor(0.0))
            temporal_ba_solve(tprob, _mesh(("seq",)), num_iters=1)
        elif what == "mesh_size":
            make_mesh(n_data=n + 1, n_model=1, device_type="cpu")
        elif what == "pipeline_stages":
            pipeline_run([_stage_add] * (n + 1), torch.zeros(2, 8), _mesh(("stage",)))
        elif what == "engine_window":
            from invcompcamtrack_torch.config import ICGNParams
            from invcompcamtrack_torch.core.camera import CameraPyramid
            from invcompcamtrack_torch.vo.engine import VisualOdometry, VOConfig

            tr = ICGNParams(lv_f=1, lv_l=0, psz=8, maxiter=2)
            cam = CameraPyramid.create((60.0, 60.0), (32.0, 24.0), (64, 48), tr.num_levels,
                                       tr.psz, device="cpu")
            cfg = VOConfig(tracker=tr, window=n + 1, ba_temporal_mesh=_mesh(("seq",)))
            VisualOdometry(cam, (60.0, 60.0), (32.0, 24.0), cfg, device="cpu")
    except (ValueError, TypeError) as e:
        return type(e).__name__
    return None


def job_mesh():
    """``make_mesh`` and ``shard_batch`` on this world."""
    import torch.distributed as dist

    from invcompcamtrack_torch.parallel.comm import axis_size
    from invcompcamtrack_torch.parallel.mesh import make_mesh, shard_batch

    n = dist.get_world_size()
    mesh = make_mesh(n_model=n, device_type="cpu")
    out = {"names": mesh.mesh_dim_names, "shape": tuple(mesh.shape),
           "model_size": axis_size(mesh, "model"), "model_index": mesh.get_local_rank("model"),
           "data_size": axis_size(mesh, "data"),
           "placements": [repr(p) for p in shard_batch(mesh, None, "model")],
           "placements_data": [repr(p) for p in shard_batch(mesh, "data")]}
    try:
        shard_batch(mesh, "seq")
    except ValueError:
        out["bad_axis"] = "ValueError"
    return out


def job_ring(x: np.ndarray):
    """Ring shifts by +1 and -1 of this rank's row of ``x``, and whether a
    one-rank ring handed the tensor back untouched (no communication)."""
    import torch.distributed as dist

    from invcompcamtrack_torch.parallel.comm import ring_shift, ring_shifts

    mesh = _mesh(("ring",))
    g = mesh.get_group("ring")
    r = dist.get_rank()
    mine = torch.tensor(x[r])
    fwd, bwd = ring_shifts([(mine, 1), (mine, -1)], g)
    same = ring_shift(mine, g) is mine
    return _np(fwd), _np(bwd), same


# the algebraic stages of tests/test_pipeline.py: non-commuting, so any
# order or routing bug shows
def _stage_add(x):
    return x + 1.0


def _stage_mul(x):
    return x * 2.0


def _stage_flip(x):
    return x - torch.flip(x, dims=(0,)) * 0.5


def _stage_tanh(x):
    return torch.tanh(x) + x


ALGEBRAIC_STAGES = (_stage_add, _stage_mul, _stage_flip, _stage_tanh)


def job_pipeline_algebraic(xs: np.ndarray):
    """The first P algebraic stages through a P-rank pipeline, and their
    sequential composition."""
    import torch.distributed as dist

    from invcompcamtrack_torch.parallel.pipeline import pipeline_run, sequential_reference

    stages = list(ALGEBRAIC_STAGES[:dist.get_world_size()])
    xs = torch.tensor(xs)
    return _np(pipeline_run(stages, xs, _mesh(("stage",)))), _np(sequential_reference(stages, xs))


def job_pipeline_vo_stages(xs: np.ndarray, hw, n_pts: int, fc, cc):
    """``vo_stage_fns`` through a 4-rank pipeline, and sequentially."""
    from invcompcamtrack_torch.parallel.pipeline import (pipeline_run, sequential_reference,
                                                         vo_stage_fns)

    stages = vo_stage_fns(tuple(hw), n_pts, tuple(fc), tuple(cc))
    xs = torch.tensor(xs)
    return _np(pipeline_run(stages, xs, _mesh(("stage",)))), _np(sequential_reference(stages, xs))


def _engine(fc, cc, wh, cfg_kw, tracker_kw, mesh_axis=None, temporal_axis=None):
    from invcompcamtrack_torch.config import ICGNParams
    from invcompcamtrack_torch.core.camera import CameraPyramid
    from invcompcamtrack_torch.vo.engine import VisualOdometry, VOConfig

    tr = ICGNParams(**tracker_kw)
    kw = dict(cfg_kw)
    if mesh_axis is not None:
        kw.update(ba_mesh=_mesh((mesh_axis,)), ba_mesh_axis=mesh_axis)
    if temporal_axis is not None:
        kw.update(ba_temporal_mesh=_mesh((temporal_axis,)), ba_temporal_axis=temporal_axis)
    cam = CameraPyramid.create(fc, cc, wh, tr.num_levels, tr.psz, device="cpu")
    return VisualOdometry(cam, fc, cc, VOConfig(tracker=tr, **kw), device="cpu")


def run_engine(imgs, poses_gt, seeds, fc, cc, wh, cfg_kw, tracker_kw, mesh_axis=None,
               temporal_axis=None):
    """Bootstrap on frames 0-1 from the true poses, then process_frame on
    the rest: (poses (T-2, 6), final landmarks, final lm_valid).  With
    ``mesh_axis`` / ``temporal_axis`` the window BA is sharded over the
    whole world (the engine's ba_mesh / ba_temporal_mesh)."""
    vo = _engine(fc, cc, wh, cfg_kw, tracker_kw, mesh_axis, temporal_axis)
    vo.bootstrap(imgs[0], imgs[1], poses_gt[0], poses_gt[1], seeds)
    poses = np.stack([vo.process_frame(im) for im in imgs[2:]])
    return poses, _np(vo.state.landmarks), _np(vo.state.lm_valid)


def job_engine(**kw):
    return run_engine(**kw)


def job_vo_pipeline(streams, seeds, fc, cc, wh, cfg_kw, tracker_kw, n_win: int):
    """The real-chain pipeline on 4 ranks: ``streams`` is a list of (poses,
    images) per stream; each stream's engine is bootstrapped on its
    frames 0-1 and its next ``n_win`` frames run through the ring."""
    from invcompcamtrack_torch.parallel.vo_pipeline import (make_vo_pipeline,
                                                            pp_ring_bytes_per_step,
                                                            vo_pipeline_run)

    init_states, frames = [], []
    for poses, imgs in streams:
        vo = _engine(fc, cc, wh, cfg_kw, tracker_kw)
        vo.bootstrap(imgs[0], imgs[1], poses[0], poses[1], seeds)
        init_states.append(vo.state)
        frames.append(np.stack(imgs[2:2 + n_win]))
    spec = make_vo_pipeline(vo.cam, vo.cfg, wh)
    poses, finals = vo_pipeline_run(spec, init_states, np.stack(frames),
                                    _mesh(("stage",)))
    return (_np(poses), [(_np(f.landmarks), _np(f.lm_valid)) for f in finals],
            spec.carrier_size, pp_ring_bytes_per_step(spec))


# targets for spawn_world's own checks (no process group)
def rank_fails_on_one(rank: int, n: int, init_method: str):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def rank_hangs(rank: int, n: int, init_method: str):
    import time

    time.sleep(600)
