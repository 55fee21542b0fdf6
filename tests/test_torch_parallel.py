"""The port's multi-process runtime and pipelines (``parallel/``) against
the JAX package's, mirroring tests/test_pipeline.py,
tests/test_runtime_recovery.py and tests/test_aux_subsystems.py's
runtime cases.

The JAX functions run here on conftest's 8 virtual CPU devices; the
port's run in worlds of gloo ranks spawned by ``tests/torch_dist_helpers``
(one world per rank count, shared by the module's cases), on inputs made
with numpy from a seed.  In every world the ranks' results are equal bit
for bit, and a pipeline on the CPU equals its sequential composition bit
for bit: each stage runs the same operations on the same values.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.config import ICGNParams as JParams
from invcompcamtrack_tpu.core.camera import CameraPyramid as JCam
from invcompcamtrack_tpu.parallel import pipeline as jpipe
from invcompcamtrack_tpu.parallel import vo_pipeline as jvo_pipe
from invcompcamtrack_tpu.vo import engine as jeng
from invcompcamtrack_tpu.vo import synthetic
from invcompcamtrack_torch.config import ICGNParams
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.parallel import pipeline, vo_pipeline
from invcompcamtrack_torch.parallel.runtime import checkpointed_loop, initialize_distributed
from invcompcamtrack_torch.vo.engine import VOConfig
from tests import torch_dist_helpers as dh
from tests.oracles import geometry_np as geo
import tests.torch_helpers  # noqa: F401  (one torch thread per process)

HW, N_PTS, FC, CC = (24, 32), 16, (30.0, 31.0), (16.0, 12.0)
# tests/test_pipeline.py's real-chain workload
WH, N_WIN = (128, 96), 4
CFG_KW = dict(max_landmarks=64, window=3, keyframe_stride=1, corners_per_kf=64,
              min_parallax_px=0.5)
TRACKER_KW = dict(lv_f=2, lv_l=0, psz=8, maxiter=6)
# vo_stage_fns, the port's stage vs JAX's on the same float32 carrier:
# measured 1.5e-5 on the pyramid stage (one float32 ulp at an intensity of
# ~128: jnp.convolve sums the three taps in another order) and 0 on the
# other three; 4e-5 is about 3 x that
STAGE_TOL = 4e-5


def _vo_carriers(seed=1, T=5):
    """tests/test_pipeline.py::test_pipeline_vo_stage_chain's stream."""
    rng = np.random.default_rng(seed)
    H, W = HW
    bufs = []
    for _ in range(T):
        img = rng.normal(size=(H, W)) * 30 + 128
        uv = np.c_[rng.uniform(2, W - 2, N_PTS), rng.uniform(2, H - 2, N_PTS)]
        bufs.append(np.concatenate([img.ravel(), uv.ravel(), np.zeros(N_PTS * 4)]))
    return np.stack(bufs).astype(np.float32)


def _algebraic_xs():
    return np.random.default_rng(0).normal(size=(7, 33)).astype(np.float32)


def _streams():
    """Four streams on one scene, four camera paths (bootstrap + N_WIN
    frames each), rendered as float32."""
    scene = synthetic.make_scene(np.random.default_rng(0), wh=WH, fc=(110.0, 112.0))
    streams = []
    for r in range(4):
        rr = np.random.default_rng(100 + r)
        poses = [np.zeros(6)]
        for _ in range(1, N_WIN + 2):
            poses.append(poses[-1] + np.r_[rr.normal(size=3) * 0.015, rr.normal(size=3) * 0.004])
        poses = np.stack(poses)
        streams.append((poses, [synthetic.render(scene, geo.se3_exp(p)).astype(np.float32)
                                for p in poses]))
    seeds = synthetic.sample_plane_points(scene, np.random.default_rng(7), 60,
                                          margin=16).astype(np.float32)
    return scene, streams, seeds


def _engine_kw(scene, seeds):
    return dict(seeds=seeds, fc=scene.fc, cc=scene.cc, wh=WH, cfg_kw=CFG_KW,
                tracker_kw=TRACKER_KW)


@pytest.fixture(scope="module")
def chain():
    scene, streams, seeds = _streams()
    return dict(scene=scene, streams=streams, seeds=seeds)


@pytest.fixture(scope="module")
def worlds(chain, tmp_path_factory):
    """One world per rank count, every case's job in it: {n: {key: rank
    results}}."""
    vo_kw = dict(_engine_kw(chain["scene"], chain["seeds"]), streams=chain["streams"],
                 n_win=N_WIN)
    jobs = {
        2: {"algebraic": ("job_pipeline_algebraic", dict(xs=_algebraic_xs())),
            "mesh": ("job_mesh", {}),
            "ring": ("job_ring", dict(x=np.arange(12, dtype=np.float32).reshape(2, 6))),
            "stages": ("job_raises", dict(what="pipeline_stages")),
            "mesh_size": ("job_raises", dict(what="mesh_size"))},
        4: {"algebraic": ("job_pipeline_algebraic", dict(xs=_algebraic_xs())),
            "ring": ("job_ring", dict(x=np.arange(24, dtype=np.float32).reshape(4, 6))),
            "vo_stages": ("job_pipeline_vo_stages",
                          dict(xs=_vo_carriers(), hw=HW, n_pts=N_PTS, fc=FC, cc=CC)),
            "vo_chain": ("job_vo_pipeline", vo_kw)},
    }
    out = {}
    for n, js in jobs.items():
        res = dh.run_world(n, list(js.values()), tmp_path_factory.mktemp(f"world{n}"))
        out[n] = {k: [r[i] for r in res] for i, k in enumerate(js)}
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_ring_shift_moves_each_row_to_its_neighbour(worlds, n):
    x = np.arange(6 * n, dtype=np.float32).reshape(n, 6)
    for r, (fwd, bwd, same) in enumerate(worlds[n]["ring"]):
        assert not same
        np.testing.assert_array_equal(fwd, x[(r - 1) % n])
        np.testing.assert_array_equal(bwd, x[(r + 1) % n])


def test_make_mesh_and_shard_batch(worlds):
    """make_mesh builds JAX's ("data", "model") mesh over the world and
    refuses a size that does not match it; shard_batch gives JAX's
    PartitionSpec as placements, one per mesh dim."""
    for r, m in enumerate(worlds[2]["mesh"]):
        assert m["names"] == ("data", "model") and m["shape"] == (1, 2)
        assert (m["model_size"], m["model_index"], m["data_size"]) == (2, r, 1)
        # P(None, "model"): array dim 1 on the model axis
        assert m["placements"] == ["Replicate()", "Shard(dim=1)"]
        assert m["placements_data"] == ["Shard(dim=0)", "Replicate()"]
        assert m["bad_axis"] == "ValueError"
    assert worlds[2]["mesh_size"] == ["ValueError"] * 2


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_matches_sequential_algebraic(worlds, n):
    """Non-commuting stages: any stage-order or routing bug shows.  The
    port's pipeline equals its sequential composition bit for bit, on
    every rank, and the JAX package's composition within float32 roundoff
    (JAX's own pipeline-vs-sequential tolerance, rtol 1e-6)."""
    res = worlds[n]["algebraic"]
    dh.assert_ranks_equal(res)
    ys, ref = res[0]
    np.testing.assert_array_equal(ys, ref)
    stages = [lambda x: x + 1.0, lambda x: x * 2.0, lambda x: x - jnp.flip(x) * 0.5,
              lambda x: jnp.tanh(x) + x][:n]
    j_ref = jpipe.sequential_reference(stages, jnp.asarray(_algebraic_xs(), jnp.float32))
    np.testing.assert_allclose(ys, np.asarray(j_ref), rtol=1e-6, atol=1e-6)


def test_pipeline_stage_count_mismatch(worlds):
    assert worlds[2]["stages"] == ["ValueError"] * 2


@pytest.mark.parametrize("stage", range(4))
def test_vo_stage_fns_match_jax(stage):
    """Each toy VO stage of the port against JAX's on the same carrier."""
    xs = _vo_carriers()
    mine = pipeline.vo_stage_fns(HW, N_PTS, FC, CC)[stage]
    theirs = jpipe.vo_stage_fns(HW, N_PTS, FC, CC)[stage]
    for x in xs:
        got = mine(torch.tensor(x)).numpy()
        want = np.asarray(theirs(jnp.asarray(x, jnp.float32)))
        np.testing.assert_allclose(got, want, rtol=0, atol=STAGE_TOL)


def test_pipeline_vo_stage_chain(worlds):
    """The pyramid -> track -> triangulate -> refine chain through a
    4-rank pipeline equals its sequential composition, microbatch for
    microbatch, and JAX's within its test's tolerance."""
    res = worlds[4]["vo_stages"]
    dh.assert_ranks_equal(res)
    ys, ref = res[0]
    np.testing.assert_array_equal(ys, ref)
    j_ref = jpipe.sequential_reference(jpipe.vo_stage_fns(HW, N_PTS, FC, CC),
                                       jnp.asarray(_vo_carriers(), jnp.float32))
    np.testing.assert_allclose(ys, np.asarray(j_ref), rtol=1e-5, atol=1e-4)
    # the refine stage moved the depth channel
    depth = ys[:, HW[0] * HW[1] + N_PTS * 2::4]
    assert np.all(depth > 0) and np.all(np.abs(depth - 8.0) < 8.0)


def test_vo_real_chain_pipeline_matches_sequential_engine(chain, worlds):
    """Four VO streams round-robined through the 4-stage ring (the
    engine's own stage functions) reproduce each stream's sequential
    ``VisualOdometry``, poses and final landmark table, bit for bit on
    the CPU; the carrier has the JAX module's size."""
    res = worlds[4]["vo_chain"]
    dh.assert_ranks_equal(res)
    poses, finals, size, ring_bytes = res[0]
    kw = _engine_kw(chain["scene"], chain["seeds"])
    for r, (p_gt, imgs) in enumerate(chain["streams"]):
        seq_poses, seq_lms, seq_valid = dh.run_engine(imgs[:2 + N_WIN], p_gt, **kw)
        np.testing.assert_array_equal(poses[r], seq_poses)
        np.testing.assert_array_equal(finals[r][0], seq_lms)
        np.testing.assert_array_equal(finals[r][1], seq_valid)
    scene = chain["scene"]
    jtr = JParams(**TRACKER_KW)
    jcam = JCam.create(scene.fc, scene.cc, scene.wh, jtr.num_levels, jtr.psz)
    jspec = jvo_pipe.make_vo_pipeline(jcam, jeng.VOConfig(tracker=jtr, **CFG_KW), WH)
    assert size == jspec.carrier_size
    assert ring_bytes == jvo_pipe.pp_ring_bytes_per_step(jspec) > 0


def test_vo_pipeline_slim_carrier_round_trip(chain):
    """The slim carrier ships the keyframe frames and rebuilds their
    pyramids at unpack: pack + unpack is the identity on a bootstrapped
    state, and the carrier is much smaller than the pyramids-on-the-ring
    layout (JAX's bound, 0.55)."""
    scene = chain["scene"]
    poses, imgs = chain["streams"][0]
    vo = dh._engine(scene.fc, scene.cc, WH, CFG_KW, TRACKER_KW)
    vo.bootstrap(imgs[0], imgs[1], poses[0], poses[1], chain["seeds"])
    spec = vo_pipeline.make_vo_pipeline(vo.cam, vo.cfg, WH)
    fat = vo_pipeline.make_vo_pipeline(vo.cam, vo.cfg, WH, slim_carrier=False)
    assert spec.carrier_size < 0.55 * fat.carrier_size
    st = vo.state
    for sp in (spec, fat):
        rt = sp.unpack_state(sp.pack_init(st))
        for name in st._fields:
            a, b = getattr(st, name), getattr(rt, name)
            if name == "kf_pyr":
                for la, lb in zip(a, b):
                    for x, y in zip(la, lb):
                        assert torch.equal(x, y)
            elif isinstance(a, torch.Tensor):
                assert torch.equal(a, b), name
            else:
                assert a == b, name


def test_vo_pipeline_needs_stride_one(chain):
    scene = chain["scene"]
    tr = ICGNParams(**TRACKER_KW)
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, tr.num_levels, tr.psz,
                               device="cpu")
    with pytest.raises(ValueError):
        vo_pipeline.make_vo_pipeline(cam, VOConfig(tracker=tr, **dict(CFG_KW,
                                                                      keyframe_stride=2)), WH)


# ---------------------------------------------------------------------------
# the runtime (tests/test_aux_subsystems.py, tests/test_runtime_recovery.py)


def test_spawn_world_reports_a_failed_and_a_hung_rank(tmp_path):
    """The one runner of the port's worlds: a rank that raises comes back
    as a RuntimeError carrying its traceback, and a rank still running
    at the deadline is killed and named, not waited for."""
    from invcompcamtrack_torch.parallel.runtime import spawn_world

    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_world(dh.rank_fails_on_one, 2, tmp_path / "fail", 120)
    with pytest.raises(TimeoutError, match=r"ranks \[0\]"):
        spawn_world(dh.rank_hangs, 1, tmp_path / "hang", 3)


def test_initialize_distributed_single_process():
    assert initialize_distributed() is False  # no-op in a single process
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_checkpointed_loop_resumes(tmp_path, as_tensor):
    """tests/test_aux_subsystems.py's case; a tensor state comes back as
    a tensor."""
    calls = []

    def wrap(v):
        return torch.tensor(v) if as_tensor else np.asarray(v)

    def step(state, i):
        calls.append(i)
        return {**state, "x": state["x"] + 1.0}

    out = checkpointed_loop(step, {"x": wrap(0.0)}, num_steps=7, ckpt_path=tmp_path / "ck",
                            every=3)
    assert float(out["x"]) == 7.0
    # a restart resumes from the last checkpoint, not from 0
    calls.clear()
    out2 = checkpointed_loop(step, {"x": wrap(0.0)}, num_steps=7, ckpt_path=tmp_path / "ck",
                             every=3)
    assert calls == [] and float(out2["x"]) == 7.0
    assert isinstance(out2["x"], torch.Tensor) == as_tensor
    checkpointed_loop(step, {"x": wrap(0.0)}, num_steps=4, ckpt_path=tmp_path / "ck2", every=2)
    calls.clear()
    out4 = checkpointed_loop(step, {"x": wrap(0.0)}, num_steps=9, ckpt_path=tmp_path / "ck2",
                             every=2)
    assert calls == [4, 5, 6, 7, 8]
    assert float(out4["x"]) == 9.0


_WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)

from invcompcamtrack_torch.parallel.runtime import checkpointed_loop

ckpt = sys.argv[1]
crash_at = int(sys.argv[2])        # -1: run to completion
out_path = sys.argv[3]

# a deterministic, state-coupled iteration: any divergence after resume
# is visible bit-wise
A = torch.tensor(np.random.default_rng(3).normal(size=(16, 16)), dtype=torch.float32)

def step_fn(state, i):
    if i == crash_at:
        os._exit(17)               # simulated hard host failure
    x = state["x"]
    y = torch.tanh(A @ x) + 0.1 * torch.sin(torch.tensor(float(i)) * x)
    return {"x": y / torch.clamp(torch.linalg.norm(y), min=1e-6)}

state0 = {"x": torch.tensor(np.random.default_rng(0).normal(size=16), dtype=torch.float32)}
final = checkpointed_loop(step_fn, state0, num_steps=30, ckpt_path=ckpt, every=5, resume=True)
np.save(out_path, final["x"].numpy())
print("done")
"""


def _run_worker(tmp_path, name, crash_at):
    ckpt = tmp_path / f"ckpt_{name}"
    out = tmp_path / f"out_{name}.npy"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, str(script), str(ckpt), str(crash_at), str(out)],
                         env=env, capture_output=True, text=True, timeout=120)
    return res, ckpt, out


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The uninterrupted run's final state."""
    r0, _, out0 = _run_worker(tmp_path_factory.mktemp("oracle"), "oracle", -1)
    assert r0.returncode == 0, r0.stderr[-2000:]
    return np.load(out0)


def test_crash_resume_bit_exact(tmp_path, oracle):
    """A worker killed mid-run (``os._exit``, no clean-up) and restarted
    resumes from its last checkpoint and ends bit for bit where an
    uninterrupted run ends."""
    r1, ckpt, out1 = _run_worker(tmp_path, "crash", 17)   # checkpoint at step 15
    assert r1.returncode == 17, (r1.returncode, r1.stderr[-2000:])
    assert not out1.exists()
    assert os.path.exists(str(ckpt) + ".npz"), "no checkpoint written before the crash"
    r2, _, out1 = _run_worker(tmp_path, "crash", -1)
    assert r2.returncode == 0, r2.stderr[-2000:]
    np.testing.assert_array_equal(np.load(out1), oracle)


def test_double_crash_resume(tmp_path, oracle):
    """Two successive failures (steps 7 and 23) still recover exactly."""
    for crash_at in (7, 23):
        r, _, _ = _run_worker(tmp_path, "dc", crash_at)
        assert r.returncode == 17
    r, _, out = _run_worker(tmp_path, "dc", -1)
    assert r.returncode == 0, r.stderr[-2000:]
    np.testing.assert_array_equal(np.load(out), oracle)


def test_jax_runtime_agrees_on_a_single_process():
    """The JAX package's harness takes the same single-process decision."""
    from invcompcamtrack_tpu.parallel.runtime import initialize_distributed as j_init

    assert j_init() is initialize_distributed() is False
    assert jax.process_count() == 1
