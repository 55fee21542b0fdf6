"""The port's multi-device bundle adjustment against the JAX package's:
the landmark-sharded window BA (``ba/distributed.py``), the
keyframe-sharded temporal BA (``ba/temporal.py``) and the temporal-scale
example, mirroring tests/test_ba_distributed.py and
tests/test_ba_temporal.py.  The engine's routes to them are held in
tests/test_torch_ba_distributed_engine.py, which uses this module's
helpers.

The JAX functions run here on conftest's 8 virtual CPU devices in
float32 (and float64 where a gap is measured); the port's run in worlds
of gloo ranks spawned by ``tests/torch_dist_helpers`` (one world per rank
count, shared by the module's cases) on the same float32 inputs, made
with numpy from a seed.  In every world the ranks' results are equal bit
for bit.

Tolerances.  An all-reduce adds the shards' partial sums in another
order than one device's sum, so a sharded solve parts from the
one-device solve by float32 roundoff, amplified by the solve.  Each
sharded-vs-single limit below is ``GAP_FACTOR`` x the larger of two gaps
of the JAX package measured in the test on the same inputs: its own
sharded-vs-single gap in float32 and its float32-vs-float64 gap of the
one-device solve.  The dense landmark-sharded case runs in float64 with
tests/test_ba_distributed.py's own tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from invcompcamtrack_tpu.ba import window as jwin
from invcompcamtrack_tpu.ba.distributed import ba_solve_sharded as j_sharded
from invcompcamtrack_tpu.ba.temporal import TemporalBAProblem as JTemporal
from invcompcamtrack_tpu.ba.temporal import temporal_ba_solve as j_temporal
from invcompcamtrack_torch.ba import window as win
from tests import torch_dist_helpers as dh
from tests.test_torch_ba import _make_problem, _odo, _to_jax, _to_torch
import tests.torch_helpers  # noqa: F401  (one torch thread per process)

GAP_FACTOR = 4.0
# a floor for a gap that measures 0 (float32 rounding of the values)
ULP_FLOOR = 2e-6


def _gap(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _tol(*gaps):
    return GAP_FACTOR * max(*gaps, ULP_FLOOR)


def _mesh(n, name):
    return Mesh(np.asarray(jax.devices()[:n]), axis_names=(name,))


def _jax(d, cls, dtype=jnp.float32):
    return _to_jax(d, cls, dtype)


_JIT = {}


def _jcall(fn, prob, n=None, axis=None, odo=None, mo=None, **kw):
    """``fn(prob[, mesh], odo=odo, motion_only=mo, **kw)`` of the JAX
    package, jitted, ``odo`` and ``mo`` traced: one compilation per program
    and dtype (eager JAX compiles every op)."""
    key = (fn, n, axis, odo is None, mo is None, tuple(sorted(kw.items())))
    if key not in _JIT:
        mesh = None if n is None else _mesh(n, axis)

        def run(pr, od, m):
            extra = {} if od is None else {"odo": od}
            if m is not None:
                extra["motion_only"] = m
            args = (pr,) if mesh is None else (pr, mesh)
            return fn(*args, **kw, **extra)
        _JIT[key] = jax.jit(run)
    return _JIT[key](prob, odo, None if mo is None else jnp.asarray(mo))


def _temporal(d, odom=None, w=0.0):
    K = d["poses"].shape[0]
    return dict(d, odom=(np.zeros((K, 6), np.float32) if odom is None
                         else np.asarray(odom, np.float32)),
                odom_weight=np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# inputs (numpy, float32), made once per module


def _problems():
    P = {}
    # tests/test_ba_distributed.py's problem, in float64 as that test runs it
    d, _ = _make_problem(np.random.default_rng(0), K=5, L=64, noise=0.2,
                         perturb_pose=0.02, perturb_lm=0.08)
    P["dense"] = {k: (v.astype(np.float64) if np.asarray(v).dtype == np.float32 else v)
                  for k, v in d.items()}
    P["cg"], _ = _make_problem(np.random.default_rng(1), K=6, L=64, noise=0.1,
                               perturb_pose=0.02, perturb_lm=0.08)
    # the engine's guarded joint solve: Huber, trust region, eigen floor,
    # isotropic odometry factors, a motion-only gate as a 0-d tensor
    P["opts"], _ = _make_problem(np.random.default_rng(2), K=5, L=64, noise=0.2)
    d, _ = _make_problem(np.random.default_rng(3), K=8, L=64, noise=0.2,
                         perturb_pose=0.02, perturb_lm=0.08)
    P["t_window"] = _temporal(d)
    rng = np.random.default_rng(4)
    d, _ = _make_problem(rng, K=8, L=48, noise=0.1)
    P["t_inv"] = _temporal(d, rng.normal(size=(8, 6)) * 0.01, 5.0)
    # a pose with no observation, its chain factor across a shard border
    d, poses_gt = _make_problem(np.random.default_rng(5), K=8, L=64, noise=0.0,
                                perturb_pose=0.05, perturb_lm=0.0)
    d["mask"] = d["mask"].copy()
    d["mask"][4, :] = False
    odom = np.concatenate([np.diff(poses_gt, axis=0), np.zeros((1, 6), np.float32)])
    P["t_blind_gt"] = poses_gt
    P["t_blind"] = _temporal(d, odom, 100.0)
    P["t_blind_nochain"] = _temporal(d)
    d, _ = _make_problem(np.random.default_rng(6), K=8, L=48, noise=0.2)
    P["t_fixed"] = _temporal(d, w=2.0)
    d, poses_gt = _make_problem(np.random.default_rng(7), K=32, L=96, noise=0.0,
                                perturb_pose=0.02, perturb_lm=0.05)
    P["t_long_gt"] = poses_gt
    P["t_long"] = _temporal(d, np.concatenate([np.diff(poses_gt, axis=0),
                                               np.zeros((1, 6), np.float32)]), 1.0)
    return P


KW = {"dense": dict(num_iters=10),
      "cg": dict(num_iters=6, reduced_solver="cg", cg_iters=60),
      "cg_dense": dict(num_iters=6),
      "opts": dict(num_iters=6, huber_delta=1.5, lm_step_clip=0.1, damp_min=1e-5,
                   lm_eig_floor=5e-3),
      "t_window": dict(num_iters=10, cg_iters=48),
      "t_inv": dict(num_iters=6, cg_iters=40),
      "t_blind": dict(num_iters=8, cg_iters=48),
      "t_fixed": dict(num_iters=5, cg_iters=32),
      "t_long": dict(num_iters=12, cg_iters=64)}


def _ba_job(P, key, kw_key=None, **extra):
    return ("job_ba_sharded", dict(prob=P[key], kw=dict(KW[kw_key or key], **extra)))


def _t_job(P, key, kw_key=None):
    return ("job_temporal", dict(prob=P[key], kw=KW[kw_key or key]))


@pytest.fixture(scope="module")
def problems():
    return _problems()


def _jobs(n, P):
    jobs = {"dense": _ba_job(P, "dense"), "t_inv": _t_job(P, "t_inv")}
    if n == 2:
        jobs.update({
            "cg": _ba_job(P, "cg"), "cg_dense": _ba_job(P, "cg", "cg_dense"),
            "opts": ("job_ba_sharded", dict(prob=P["opts"], kw=dict(
                KW["opts"], motion_only=np.array(False)), odo=_odo(P["opts"]["poses"]))),
            "opts_mo": ("job_ba_sharded", dict(prob=P["opts"], kw=dict(
                KW["opts"], motion_only=np.array(True)), odo=_odo(P["opts"]["poses"]))),
            "t_window": _t_job(P, "t_window"),
            "t_blind": _t_job(P, "t_blind"),
            "t_blind_nochain": _t_job(P, "t_blind_nochain", "t_blind"),
            "t_fixed": _t_job(P, "t_fixed"), "t_long": _t_job(P, "t_long"),
            "raise_temporal": ("job_raises", dict(what="temporal_window")),
            "raise_engine": ("job_raises", dict(what="engine_window"))})
    if n == 1:
        jobs = {"t_inv": _t_job(P, "t_inv"),
                "ring": ("job_ring", dict(x=np.arange(6, dtype=np.float32)[None]))}
    return jobs


def worlds(jobs, tmp_path_factory):
    """world(n) -> {job key: [rank results]}, one spawned world per n
    running ``jobs(n)``."""
    done = {}

    def get(n):
        if n not in done:
            js = jobs(n)
            res = dh.run_world(n, list(js.values()), tmp_path_factory.mktemp(f"world{n}"))
            done[n] = {k: [r[i] for r in res] for i, k in enumerate(js)}
        return done[n]
    return get


@pytest.fixture(scope="module")
def world(problems, tmp_path_factory):
    return worlds(lambda n: _jobs(n, problems), tmp_path_factory)


def _replicated(world_n, key):
    res = world_n[key]
    dh.assert_ranks_equal(res)
    return res[0]


# ---------------------------------------------------------------------------
# landmark-sharded window BA (tests/test_ba_distributed.py)


@pytest.mark.parametrize("n_model", [2, 4, pytest.param(8, marks=pytest.mark.slow)])
def test_sharded_ba_matches_single_device(problems, world, n_model):
    """The landmark-sharded Schur BA reproduces the one-device solver, and
    the JAX package's sharded solve, in float64 with
    tests/test_ba_distributed.py's tolerances.  (In float32 the LM loop
    reaches its cost's roundoff in 3 of the 10 iterations; from there an
    accept or a reject depends on the order of the cost's sums, and on 8
    ranks one flipped step moved the poses by 1.4e-4; float32 sharding is
    held in the cases below.)"""
    d = problems["dense"]
    p, lm, (err, err0) = _replicated(world(n_model), "dense")
    p1, l1, (e1, e01) = win.ba_solve(_to_torch(d, win.BAProblem), **KW["dense"])
    jps, jls, (jes, jes0) = _jcall(j_sharded, _jax(d, jwin.BAProblem, jnp.float64), n_model,
                                   "model", **KW["dense"])
    np.testing.assert_allclose(err0, e01.numpy(), rtol=1e-10)
    for want in (p1.numpy(), np.asarray(jps)):
        np.testing.assert_allclose(p, want, rtol=1e-7, atol=1e-9)
    for want in (l1.numpy(), np.asarray(jls)):
        np.testing.assert_allclose(lm, want, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(err, e1.numpy(), rtol=1e-8)
    np.testing.assert_allclose(err, float(jes), rtol=1e-8)
    assert float(err) < 0.1 * float(err0)


def test_sharded_ba_cg_matches_dense(problems, world):
    """Distributed CG (one (K, 6) all-reduce per matvec) tracks the dense
    sharded solve as closely as the JAX package's does."""
    d = problems["cg"]
    p_c, l_c, (e_c, _) = _replicated(world(2), "cg")
    p_d, l_d, (e_d, _) = _replicated(world(2), "cg_dense")
    jp_d, jl_d, _ = _jcall(j_sharded, _jax(d, jwin.BAProblem), 2, "model", **KW["cg_dense"])
    jp_c, jl_c, (je_c, _) = _jcall(j_sharded, _jax(d, jwin.BAProblem), 2, "model", **KW["cg"])
    jp64, _, _ = _jcall(j_sharded, _jax(d, jwin.BAProblem, jnp.float64), 2, "model",
                        **KW["cg"])
    np.testing.assert_allclose(p_c, p_d, rtol=0, atol=_tol(_gap(jp_c, jp_d), _gap(jp_c, jp64)))
    np.testing.assert_allclose(e_c, e_d, rtol=1e-5)
    np.testing.assert_allclose(p_c, np.asarray(jp_c), rtol=0,
                               atol=_tol(_gap(jp_c, jp64)))


@pytest.mark.parametrize("mo", [False, True])
def test_sharded_ba_engine_options(problems, world, mo):
    """Every ba_solve option the engine passes (Huber IRLS, landmark trust
    region, eigen floor, damping floor, odometry factors, the motion-only
    gate as a tensor) through the sharded path equals the one-device
    solve to float32 roundoff."""
    d = problems["opts"]
    p, lm, (err, err0) = _replicated(world(2), "opts_mo" if mo else "opts")
    odo = _odo(d["poses"])
    kw = KW["opts"]
    p1, l1, (e1, e01) = win.ba_solve(_to_torch(d, win.BAProblem),
                                     odo=_to_torch(odo, win.OdoFactors), motion_only=mo, **kw)
    # the JAX references take the gate traced (one program for both values)
    jodo = _jax(odo, jwin.OdoFactors)
    jp1, jl1, _ = _jcall(jwin.ba_solve, _jax(d, jwin.BAProblem), odo=jodo, mo=mo, **kw)
    jp64, jl64, _ = _jcall(jwin.ba_solve, _jax(d, jwin.BAProblem, jnp.float64),
                           odo=_jax(odo, jwin.OdoFactors, jnp.float64), mo=mo, **kw)
    jps, jls, _ = _jcall(j_sharded, _jax(d, jwin.BAProblem), 2, "model", odo=jodo, mo=mo,
                         **kw)
    np.testing.assert_allclose(err0, e01.numpy(), rtol=1e-6)
    np.testing.assert_allclose(p, p1.numpy(), rtol=0,
                               atol=_tol(_gap(jps, jp1), _gap(jp1, jp64)))
    np.testing.assert_allclose(lm, l1.numpy(), rtol=0,
                               atol=_tol(_gap(jls, jl1), _gap(jl1, jl64)))
    if mo:
        np.testing.assert_array_equal(lm, d["landmarks"])
    assert float(err) < float(err0)


# ---------------------------------------------------------------------------
# keyframe-sharded temporal BA (tests/test_ba_temporal.py)


def _jt(d, dtype=jnp.float32):
    return JTemporal(**{k: (jnp.asarray(v) if np.asarray(v).dtype == bool
                            else jnp.asarray(v, dtype)) for k, v in d.items()})


def test_temporal_matches_window_solver(problems, world):
    """With the chain off, the K-sharded solver tracks the one-device CG
    window solver (same damping schedule), as closely as the JAX
    package's does."""
    d, n_seq = problems["t_window"], 2
    p, lm, (err, err0) = _replicated(world(n_seq), "t_window")
    bd = {k: v for k, v in d.items() if k not in ("odom", "odom_weight")}
    p1, l1, (e1, e01) = win.ba_solve(_to_torch(bd, win.BAProblem), reduced_solver="cg",
                                     num_iters=10, cg_iters=48)
    jp1, jl1, _ = _jcall(jwin.ba_solve, _jax(bd, jwin.BAProblem), reduced_solver="cg",
                         num_iters=10, cg_iters=48)
    jpt, jlt, _ = _jcall(j_temporal, _jt(d), n_seq, "seq", **KW["t_window"])
    jpt64, jlt64, _ = _jcall(j_temporal, _jt(d, jnp.float64), n_seq, "seq", **KW["t_window"])
    np.testing.assert_allclose(err0, e01.numpy(), rtol=1e-6)
    np.testing.assert_allclose(p, p1.numpy(), rtol=0,
                               atol=_tol(_gap(jpt, jp1), _gap(jpt, jpt64)))
    np.testing.assert_allclose(lm, l1.numpy(), rtol=0,
                               atol=_tol(_gap(jlt, jl1), _gap(jlt, jlt64)))
    np.testing.assert_allclose(p, np.asarray(jpt), rtol=0, atol=_tol(_gap(jpt, jpt64)))
    assert float(err) < float(err0) * 1e-2


@pytest.mark.parametrize("n_seq", [1, 2, 4, pytest.param(8, marks=pytest.mark.slow)])
def test_temporal_shard_count_invariance(problems, world, n_seq):
    """The answer does not depend on how many ranks the keyframe axis is
    cut across (all-reduces and ring halos), beyond the JAX package's own
    shard-count gap; at one rank the ring sends nothing."""
    d = problems["t_inv"]
    p, lm, (err, _) = _replicated(world(n_seq), "t_inv")
    p4, l4, (e4, _) = _replicated(world(4), "t_inv")
    jp, jl, _ = _jcall(j_temporal, _jt(d), n_seq, "seq", **KW["t_inv"])
    jp4, jl4, _ = _jcall(j_temporal, _jt(d), 4, "seq", **KW["t_inv"])
    jp64, jl64, _ = _jcall(j_temporal, _jt(d, jnp.float64), 4, "seq", **KW["t_inv"])
    np.testing.assert_allclose(p, p4, rtol=0, atol=_tol(_gap(jp, jp4), _gap(jp4, jp64)))
    np.testing.assert_allclose(lm, l4, rtol=0, atol=_tol(_gap(jl, jl4), _gap(jl4, jl64)))
    np.testing.assert_allclose(err, e4, rtol=1e-5)
    np.testing.assert_allclose(p, np.asarray(jp), rtol=0, atol=_tol(_gap(jp, jp64)))


def test_chain_prior_anchors_blind_pose(problems, world):
    """A pose with no observation is invisible to reprojection BA; the
    odometry chain pulls it to the chain-consistent place, across a shard
    border (K = 8 over 2 ranks: pose 4 opens rank 1's segment)."""
    gt, blind = problems["t_blind_gt"], 4
    p_no, _, _ = _replicated(world(2), "t_blind_nochain")
    p_ch, _, _ = _replicated(world(2), "t_blind")
    err_no = float(np.linalg.norm(p_no[blind] - gt[blind]))
    err_ch = float(np.linalg.norm(p_ch[blind] - gt[blind]))
    assert err_no > 0.02, "blind pose unexpectedly moved without the chain"
    assert err_ch < err_no * 0.05, (err_no, err_ch)
    seen = [k for k in range(8) if k != blind]
    np.testing.assert_allclose(p_ch[seen], gt[seen], atol=1e-3)


def test_temporal_fixed_poses_do_not_move(problems, world):
    d = problems["t_fixed"]
    p, _, _ = _replicated(world(2), "t_fixed")
    fixed = d["fixed_pose_mask"]
    np.testing.assert_array_equal(p[fixed], d["poses"][fixed])


def test_temporal_long_window_converges(problems, world):
    """K = 32 over 2 ranks: the error drops by orders of magnitude."""
    d, gt = problems["t_long"], problems["t_long_gt"]
    p, _, (err, _) = _replicated(world(2), "t_long")
    bd = {k: v for k, v in d.items() if k not in ("odom", "odom_weight")}
    _, err0 = win.ba_residuals(_to_torch(bd, win.BAProblem))
    assert float(err) < float(err0) * 1e-4, (float(err0), float(err))
    np.testing.assert_allclose(p, gt, atol=5e-3)


def test_ring_at_one_rank_sends_nothing(world):
    """A ring of one rank hands each tensor back untouched (the JAX
    ppermute to oneself) without a send to itself, which would hang: the
    temporal solve at one rank above runs through it."""
    fwd, bwd, same = world(1)["ring"][0]
    assert same
    np.testing.assert_array_equal(fwd, np.arange(6))
    np.testing.assert_array_equal(bwd, np.arange(6))


def test_sharded_paths_refuse_what_does_not_divide(world):
    """K not divisible by the keyframe axis (JAX ba/temporal.py:334-335),
    and an engine whose window does not divide by its temporal axis."""
    assert world(2)["raise_temporal"] == ["ValueError"] * 2
    assert world(2)["raise_engine"] == ["ValueError"] * 2


def _example(name):
    import importlib
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    return importlib.import_module(name)


def test_temporal_scale_example_on_two_ranks(tmp_path):
    """examples/run_temporal_scale_torch.py at a tiny size (K = 8, L = 64)
    on a world of 2 gloo ranks on the CPU: both solvers lower the cost,
    the temporal solve ends as close to the truth as the one-device one
    (within 2 x), and the JSON it writes holds the rows it printed."""
    import json

    ex = _example("run_temporal_scale_torch")
    out = tmp_path / "temporal_scale.json"
    res = ex.main(["--device", "cpu", "--K", "8", "--L", "64", "--world", "2", "--reps", "1",
                   "--out", str(out)])
    rep, temporal = res["rows"]
    assert (rep["ranks"], temporal["ranks"]) == (1, 2)
    for row in res["rows"]:
        assert np.isfinite(row["max_pose_err"]) and row["err"] < row["err0"]
    assert temporal["max_pose_err"] < 2 * max(rep["max_pose_err"], res["max_initial_pose_err"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))


@pytest.mark.slow
def test_temporal_scale_gap_of_the_jax_package():
    """Measures what chip_smoke.py's 10b limits rest on: the JAX package's
    temporal solve on examples/run_temporal_scale.py's window against its
    ba_solve(cg), and against the truth (float32 and float64, 1 and 2
    devices)."""
    import chip_smoke as cs

    jex = _example("run_temporal_scale")
    prob32, poses_gt, rel32, _ = jex.build_problem()
    out = {}
    for dt in (jnp.float32, jnp.float64):
        prob = jax.tree.map(lambda a: a.astype(dt) if a.dtype == jnp.float32 else a, prob32)
        out[dt] = _temporal_scale_gaps(jex, prob, rel32.astype(dt), np.asarray(poses_gt), dt)
    sens = _gap(out[jnp.float32][2][1], out[jnp.float64][2][1])
    worst_gap = max(g for o in out.values() for g in o[0])
    worst_err = max(e for o in out.values() for e in o[1])
    print(f"float32 vs float64 temporal solve {sens:.4g}")
    assert worst_gap + 2 * sens <= cs.TEMPORAL_VS_REPLICATED
    assert worst_err + 2 * sens <= cs.TEMPORAL_POSE_ERR
    assert 2 * sens <= cs.TEMPORAL_RANKS_GAP


def _temporal_scale_gaps(jex, prob, rel, gt, dt):
    """(gaps to ba_solve(cg), errors against the truth, {n: poses}) of the
    JAX temporal solve on 1 and 2 devices."""
    from invcompcamtrack_tpu.core import lie as jlie

    K = jex.K
    odo = jwin.OdoFactors(rel=rel, mask=jnp.asarray(np.arange(K) >= 1),
                          w_t=jnp.asarray(100.0, dt), w_r=jnp.asarray(1000.0, dt))
    rep, _, _ = jax.jit(lambda p: jwin.ba_solve(
        p, num_iters=jex.NUM_ITERS, huber_delta=1.5, reduced_solver="cg",
        cg_iters=jex.CG_ITERS, lm_step_clip=0.1, damp_min=1e-5, lm_eig_floor=5e-3,
        odo=odo))(prob)
    rel_next = jnp.roll(rel, -1, axis=0)
    odom = jax.vmap(lambda R, p: jlie.se3_log(jlie.se3_compose(R, jlie.se3_exp(p))))(
        rel_next, prob.poses) - prob.poses
    w6 = jnp.concatenate([jnp.full((3,), 1e4, dt), jnp.full((3,), 1e6, dt)])
    w = jnp.where((jnp.arange(K) < K - 1)[:, None], w6, 0.0)
    tprob = JTemporal(poses=prob.poses, landmarks=prob.landmarks, obs=prob.obs,
                      mask=prob.mask, fx=prob.fx, fy=prob.fy, cx=prob.cx, cy=prob.cy,
                      fixed_pose_mask=prob.fixed_pose_mask, odom=odom, odom_weight=w)
    print(f"{jnp.dtype(dt).name}: ba_solve(cg) vs truth "
          f"{float(np.abs(np.asarray(rep) - gt)[2:].max()):.4g}")
    gaps, errs, poses = [], [], {}
    for n in (1, 2):
        pt, _, _ = _jcall(j_temporal, tprob, n, "seq", num_iters=jex.NUM_ITERS,
                          huber_delta=1.5, cg_iters=jex.CG_ITERS)
        poses[n] = np.asarray(pt)
        gaps.append(_gap(pt, rep))
        errs.append(float(np.abs(poses[n] - gt)[2:].max()))
        print(f"{jnp.dtype(dt).name}, {n} device(s): temporal vs ba_solve(cg) {gaps[-1]:.4g}, "
              f"vs truth {errs[-1]:.4g}")
    print(f"{jnp.dtype(dt).name}: 1 vs 2 devices {_gap(poses[1], poses[2]):.4g}")
    return gaps, errs, poses
