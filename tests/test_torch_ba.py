"""The port's sliding-window BA (``ba/window.py``) against the JAX package
on tests/test_ba.py's problems, the same float32 inputs made with numpy
from a seed.

Tolerances: each case's comment gives the JAX package's own
float32-vs-float64 gap on the same problem and the port's gap to the JAX
float32 result.  The LM loop's accept/reject compares costs that differ
by roundoff, so two float32 runs may take other damping paths; on these
problems both paths end at the same converged state, to the gap given.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.ba import window as jwin
from invcompcamtrack_torch.ba import window as win
from tests.test_ba import _make_problem as _ba_problem
from tests.test_ba import _odo_from
import tests.torch_helpers  # noqa: F401  (one torch thread per process)


def _make_problem(rng, **kw):
    """tests/test_ba.py's problem (K poses along a lateral baseline, two
    fixed anchors, L landmarks at depth ~12) as float32 numpy arrays."""
    prob, poses_gt, _ = _ba_problem(rng, **kw)
    return ({k: np.asarray(v) if np.asarray(v).dtype == bool else np.asarray(v, np.float32)
             for k, v in prob._asdict().items()}, poses_gt.astype(np.float32))


def _odo(poses, info=False, rng=None):
    """tests/test_ba.py::_odo_from's factors (factor 0, the ring wrap,
    off) as float32 numpy arrays; with ``info`` a random (K, 6, 6) square
    root of an information matrix."""
    o = _odo_from(poses)
    d = dict(rel=np.asarray(o.rel, np.float32), mask=np.asarray(o.mask),
             w_t=np.float32(o.w_t), w_r=np.float32(o.w_r), info_sqrt=None)
    if info:
        A = rng.normal(size=(len(poses), 6, 6)) * 20.0
        d["info_sqrt"] = (A + np.eye(6) * np.r_[[d["w_t"]] * 3, [d["w_r"]] * 3]
                          ).astype(np.float32)
    return d


def _to_jax(d, cls, dtype=jnp.float32):
    return cls(**{k: (None if v is None else
                      jnp.asarray(v) if np.asarray(v).dtype == bool else
                      jnp.asarray(v, dtype)) for k, v in d.items()})


def _to_torch(d, cls):
    return cls(**{k: (None if v is None else torch.tensor(np.asarray(v)))
                  for k, v in d.items()})


# (name, problem keyword arguments, ba_solve keyword arguments, odometry
# factors: None / "iso" / "info", pose tol, landmark tol).  Gaps measured
# on seed 0, poses | landmarks: JAX f32 vs f64 ; the port vs JAX f32.  Each
# tolerance is about 10 x the larger of the two.
CASES = [
    # 6.0e-7 | 9.4e-6 ; 4.8e-7 | 1.5e-5
    ("dense", dict(), dict(num_iters=10), None, 1e-5, 2e-4),
    # 1.8e-6 | 1.0e-5 ; 7.2e-7 | 1.6e-5
    ("dense_noisy_huber", dict(noise=0.3, perturb_pose=0.02, perturb_lm=0.1),
     dict(num_iters=10, huber_delta=1.0), None, 2e-5, 2e-4),
    # 8.0e-6 | 1.1e-5 ; 1.8e-5 | 1.3e-5
    ("cg", dict(K=8, L=96, noise=0.1, perturb_pose=0.005, perturb_lm=0.02),
     dict(num_iters=8, reduced_solver="cg", cg_iters=32), None, 2e-4, 2e-4),
    # 3.7e-3 | 8.3e-2 ; 6.7e-7 | 4.3e-5.  Here JAX's f64 run takes another
    # path through the per-landmark accept/reject (its final cost 0.01068
    # against 0.009516 in both f32 runs), so the f32 runs set the limit
    ("structure_guarded", dict(noise=0.1),
     dict(num_iters=8, huber_delta=1.5, lm_step_clip=0.1, per_landmark_accept=True,
          damp_min=1e-5, lm_eig_floor=5e-3), None, 1e-5, 5e-4),
    # 2.4e-6 | 1.9e-5 ; 3.4e-5 | 1.1e-4 (eigen-directions near the floor)
    ("eig_floor", dict(noise=0.1), dict(num_iters=8, lm_eig_floor=1e-4), None, 3e-4, 1e-3),
    # 1.4e-6 | 1.9e-5 ; 7.2e-7 | 3.2e-5
    ("odo_iso", dict(noise=0.2), dict(num_iters=8, huber_delta=1.5), "iso", 2e-5, 3e-4),
    # 2.6e-6 | 5.5e-6 ; 2.0e-6 | 7.5e-5
    ("odo_info_cg", dict(noise=0.2), dict(num_iters=8, reduced_solver="cg"), "info",
     3e-5, 8e-4),
    # 7.3e-7 | 0.0 ; 3.7e-7 | 0.0 (landmarks untouched)
    ("motion_only", dict(perturb_pose=0.01, perturb_lm=0.0),
     dict(num_iters=8, motion_only=True), None, 1e-5, 0.0),
]


def _run(case, rng):
    name, pkw, skw, odo_kind, _, _ = case
    d, poses_gt = _make_problem(rng, **pkw)
    odo = None if odo_kind is None else _odo(poses_gt, info=odo_kind == "info", rng=rng)
    j = jwin.ba_solve(_to_jax(d, jwin.BAProblem), **skw,
                      odo=None if odo is None else _to_jax(odo, jwin.OdoFactors))
    t = win.ba_solve(_to_torch(d, win.BAProblem), **skw,
                     odo=None if odo is None else _to_torch(odo, win.OdoFactors))
    return d, j, t


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ba_solve_matches_jax(rng, case):
    _, pose_tol, lm_tol = case[0], case[4], case[5]
    d, (pj, lj, (ej, ej0)), (pt, lt, (et, et0)) = _run(case, rng)
    assert np.abs(pt.numpy() - np.asarray(pj)).max() <= pose_tol
    assert np.abs(lt.numpy() - np.asarray(lj)).max() <= lm_tol
    np.testing.assert_allclose(float(et0), float(ej0), rtol=1e-5)
    assert float(et) <= float(et0)
    np.testing.assert_allclose(float(et), float(ej), rtol=0.05, atol=1e-6)
    # fixed poses stay where they were, bit for bit
    np.testing.assert_array_equal(pt.numpy()[:2], d["poses"][:2])
    if case[0] == "motion_only":
        np.testing.assert_array_equal(lt.numpy(), d["landmarks"])


def test_ba_residuals_and_huber_weights_match_jax(rng):
    """Residuals and mean costs at a perturbed state, with masked-out
    observations corrupted, a landmark behind the cameras and one at the
    first camera's centre (a NaN projection: the 1e6 sentinel).  Residuals
    relative to max(|r|, 1) (the landmark behind the cameras projects to
    ~1e4 px): JAX f32 vs f64 3.6e-5, the port 3.8e-5 from JAX f32; mean
    costs 9.4e-7 / 5.5e-7 relative; Huber weights 4.2e-6 / 2.4e-6."""
    d, _ = _make_problem(rng, noise=0.3, perturb_pose=0.02, perturb_lm=0.3)
    d["obs"] = np.where(d["mask"][..., None], d["obs"], np.float32(1e6))
    d["landmarks"][5] = [0.0, 0.0, -3.0]
    d["poses"][0] = 0.0
    d["landmarks"][6] = 0.0
    pj, pt = _to_jax(d, jwin.BAProblem), _to_torch(d, win.BAProblem)
    for delta in (None, 1.0):
        rj, cj = jwin.ba_residuals(pj, delta)
        rt, ct = win.ba_residuals(pt, delta)
        r_j = np.asarray(rj)
        assert (np.abs(rt.numpy() - r_j) / np.maximum(np.abs(r_j), 1.0)).max() < 2e-4
        np.testing.assert_allclose(float(ct), float(cj), rtol=5e-6)
        assert np.isfinite(rt.numpy()).all() and (rt.numpy()[0, 6] == 1e6).all()
        wj = jwin.huber_weights(rj, pj.mask, 1.0)
        wt = win.huber_weights(rt, pt.mask, 1.0)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=4e-5)


def test_ba_odo_residuals_match_jax(rng):
    # JAX f32 vs f64 8.1e-5 on residuals up to ~40 (weights 100 / 1000);
    # the port 2.9e-6 from JAX f32
    _, poses_gt = _make_problem(rng)
    poses = (poses_gt + rng.normal(size=poses_gt.shape) * 0.01).astype(np.float32)
    for info in (False, True):
        odo = _odo(poses_gt, info=info, rng=rng)
        rj = jwin.odo_residuals(jnp.asarray(poses), _to_jax(odo, jwin.OdoFactors))
        rt = win.odo_residuals(torch.tensor(poses), _to_torch(odo, win.OdoFactors))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=5e-4)
        assert (rt.numpy()[0] == 0).all()


@pytest.mark.parametrize("mo", [True, False])
def test_ba_motion_only_as_tensor_equals_bool(rng, mo):
    """``motion_only`` as a 0-d bool tensor (the engine's turnover gate)
    selects the same step as the Python bool, bit for bit."""
    d, _ = _make_problem(rng, noise=0.1)
    kw = dict(num_iters=4, huber_delta=1.5, lm_eig_floor=5e-3)
    p_b, l_b, _ = win.ba_solve(_to_torch(d, win.BAProblem), motion_only=mo, **kw)
    p_t, l_t, _ = win.ba_solve(_to_torch(d, win.BAProblem),
                               motion_only=torch.tensor(mo), **kw)
    assert torch.equal(p_b, p_t) and torch.equal(l_b, l_t)
    if mo:
        np.testing.assert_array_equal(l_t.numpy(), d["landmarks"])


def test_ba_psum_axis_raises(rng):
    """``psum_axis`` is a torch.distributed process group or None: the JAX
    module's axis name means nothing outside ``shard_map``, so it raises
    (the landmark-sharded solve itself: tests/test_torch_ba_distributed.py)."""
    d, _ = _make_problem(rng, K=3, L=8)
    prob = _to_torch(d, win.BAProblem)
    with pytest.raises(TypeError):
        win.ba_solve(prob, num_iters=1, psum_axis="model")
    with pytest.raises(TypeError):
        win.ba_residuals(prob, psum_axis="model")
    with pytest.raises(TypeError):
        win.schur_cg_solve(*(torch.zeros(s) for s in ((3, 6, 6), (3, 8, 6, 3), (3, 8, 6, 3))),
                           torch.zeros(3, dtype=torch.bool), torch.zeros(3, 6),
                           psum_axis="model")


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_ba_solve_on_stacked_windows_equals_each_window_alone(rng, solver):
    """Two windows with a leading axis (the multi-stream engine's call),
    one noisy and one near its optimum so that their accept/reject and
    damping paths part, with information-weighted odometry factors and a
    per-window motion-only gate: each window ends where it ends as a stack
    of one (the one-stream engine's call), bit for bit, and within 1e-5
    of its call without the leading axis (whose products with a vector
    take another summation path; measured 1e-6)."""
    ds, odos = [], []
    for noise, pp in ((0.3, 0.02), (0.01, 0.001)):
        d, poses_gt = _make_problem(rng, noise=noise, perturb_pose=pp, perturb_lm=0.05)
        ds.append(d)
        odos.append(_odo(poses_gt, info=True, rng=rng))
    stack = {k: np.stack([d[k] for d in ds]) for k in ds[0] if k not in ("fx", "fy", "cx", "cy")}
    stack.update({k: ds[0][k] for k in ("fx", "fy", "cx", "cy")})
    assert all(np.array_equal(ds[0][k], ds[1][k]) for k in ("fx", "fy", "cx", "cy"))
    odo = {k: (np.stack([o[k] for o in odos]) if k in ("rel", "mask", "info_sqrt")
               else odos[0][k]) for k in odos[0]}
    kw = dict(num_iters=6, huber_delta=1.5, lm_eig_floor=5e-3, lm_step_clip=0.1,
              damp_min=1e-5, reduced_solver=solver)
    mo = torch.tensor([False, True])
    p2, l2, (e2, e20) = win.ba_solve(_to_torch(stack, win.BAProblem),
                                     odo=_to_torch(odo, win.OdoFactors), motion_only=mo, **kw)
    def one(d, keep):
        return {k: (v[None] if k not in ("fx", "fy", "cx", "cy", "w_t", "w_r") and keep
                    and v is not None else v) for k, v in d.items()}

    for s in range(2):
        p1, l1, (e1, e10) = win.ba_solve(_to_torch(one(ds[s], True), win.BAProblem),
                                         odo=_to_torch(one(odos[s], True), win.OdoFactors),
                                         motion_only=mo[s:s + 1], **kw)
        assert torch.equal(p2[s], p1[0]) and torch.equal(l2[s], l1[0])
        assert torch.equal(e2[s], e1[0]) and torch.equal(e20[s], e10[0])
        p0, l0, _ = win.ba_solve(_to_torch(ds[s], win.BAProblem),
                                 odo=_to_torch(odos[s], win.OdoFactors),
                                 motion_only=bool(mo[s]), **kw)
        assert float((p0 - p1[0]).abs().max()) <= 1e-5
        assert float((l0 - l1[0]).abs().max()) <= 1e-5
