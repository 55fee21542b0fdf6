"""The port's VO engine (``vo/engine.py``: one stream, and S streams
through ``VisualOdometryBatch``) against the JAX engine, on
tests/test_vo_engine.py::_small_setup's sequence (192x144, 128 landmarks,
window 4), float32 frames and seeds made with numpy from a seed.

The JAX engine's reference is computed once per module: bootstrap + 8
frames through ``process_frame`` (10 frames), the same run again with the
seeds moved by 1e-6 (a float32 ulp or two at depth 8), and one run on a
second pose path (other images, other seeds), whose bootstrapped state
also starts the port (``convert.vo_state_from_numpy``).  Such runs set
the tolerances: the tracker and BA's accept/reject are not continuous in
their inputs (ROADMAP Queue 3), so two float32 runs of one engine part by
more than roundoff.  (A tracker call of this engine that stops at
``maxiter`` before converging parts from its own float64 run by 1.5e-3.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.config import ICGNParams as JParams
from invcompcamtrack_tpu.core.camera import CameraPyramid as JCam
from invcompcamtrack_tpu.utils import checkpoint as jcheckpoint
from invcompcamtrack_tpu.vo import engine as jeng
from invcompcamtrack_tpu.vo import synthetic
from invcompcamtrack_torch import ICGNParams, convert
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.utils import checkpoint
from invcompcamtrack_torch.vo import engine
from invcompcamtrack_torch.vo.metrics import ate_rmse
from tests.oracles import geometry_np as geo
from tests.test_vo_engine import _camera_path
import tests.torch_helpers  # noqa: F401  (one torch thread per process)

N_FRAMES = 10
SEED_SHIFT = 1e-6
# the frame after which the JAX engine's checkpoint is taken (a keyframe)
CKPT_FRAME = 4
# Per-frame poses, the port vs the JAX engine: measured 3.6e-5 at most
# (frames 2-7 within 4e-6, then the keyframe of frame 8); the JAX engine
# against itself over 8 runs with the seeds moved by 1e-6: 8.2e-5 at most
# (the port against itself: 5.4e-5).  The limit is about 2 x the JAX
# spread.
POSE_TOL = 1.5e-4
# Entries of the newest keyframe's observation mask (128) that may differ:
# a measurement at a gate.  Measured: 0 on the main sequence; on the
# faster one of the info-weighted case 1 from frame 4 on, the port vs JAX
# and JAX against itself with the seeds moved.
MASK_TOL = 2
# run_frames vs process_frame in the port (tests/test_vo_engine.py asks
# the same of the JAX engine): the same operations in the same order.
CHUNK_TOL = 1e-5
# The second pose path of the multi-stream test (the batch's stream 2)
# against the JAX engine.  On this path the tracker's normalised problem
# is float32-sensitive from the first tracked frame on (ROADMAP Queue 3,
# a plane at one depth), in both packages: over frames 2-5 the JAX engine
# in float32 sits 1.7e-4 to 2.6e-4 from itself in float64, and the port
# 1.3e-4 to 1.5e-4 from JAX float32 and 1.2e-4 to 2.5e-4 from JAX
# float64 (measured on the CPU); moving the seeds by 1e-6 moves JAX by
# 2.6e-6 at most.  The limit is the JAX float32-vs-float64 gap, rounded
# up.
PATH2_POSE_TOL = 3e-4


def _setup(rng, n_frames, wh=(192, 144), fc=(170.0, 172.0), step=0.015):
    scene = synthetic.make_scene(rng, wh=wh, fc=fc, freq_range=(2.0, 20.0))
    poses_gt = _camera_path(rng, n_frames, step)
    imgs = [synthetic.render(scene, geo.se3_exp(p)).astype(np.float32) for p in poses_gt]
    seeds = synthetic.sample_plane_points(scene, rng, 100, margin=20).astype(np.float32)
    return scene, poses_gt, imgs, seeds


def _cfg_kw(**kw):
    return dict(max_landmarks=128, window=4, keyframe_stride=2, corners_per_kf=128,
                min_parallax_px=0.5, **kw)


def _jax_vo(scene, **kw):
    tr = JParams(lv_f=2, lv_l=0, psz=8, maxiter=6)
    cam = JCam.create(scene.fc, scene.cc, scene.wh, tr.num_levels, tr.psz)
    return jeng.VisualOdometry(cam, scene.fc, scene.cc, jeng.VOConfig(tracker=tr, **_cfg_kw(**kw)))


def _torch_vo(scene, **kw):
    tr = ICGNParams(lv_f=2, lv_l=0, psz=8, maxiter=6)
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, tr.num_levels, tr.psz,
                               device="cpu")
    return engine.VisualOdometry(cam, scene.fc, scene.cc,
                                 engine.VOConfig(tracker=tr, **_cfg_kw(**kw)), device="cpu")


def _run(vo, imgs, poses_gt, seeds, n, boot=None, after=None):
    """bootstrap + frames 2..n-1 -> per-frame (poses, live landmarks,
    newest keyframe's observation mask); ``boot`` (a list) receives the
    bootstrapped state; ``after(i, vo)`` is called after frame i."""
    vo.trajectory = []
    vo.bootstrap(imgs[0], imgs[1], poses_gt[0], poses_gt[1], seeds)
    if boot is not None:
        boot.append(vo.state)
    rows = []
    for i in range(2, n):
        p = np.asarray(vo.process_frame(imgs[i]), np.float64)
        st = vo.state
        rows.append((p, int(np.asarray(st.lm_valid).sum()),
                     np.asarray(st.kf_obs_mask[int(st.kf_ptr)]).copy()))
        if after is not None:
            after(i, vo)
    return rows, np.stack(vo.trajectory)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(0)
    scene, poses_gt, imgs, seeds = _setup(rng, N_FRAMES)
    vo = _jax_vo(scene)
    # the JAX engine's checkpoint after frame CKPT_FRAME (its keyframe)
    ckpt = {}

    def snapshot(i, engine_):
        if i == CKPT_FRAME:
            ckpt.update(jcheckpoint.vo_state_dict(engine_))

    jax_rows, jax_traj = _run(vo, imgs, poses_gt, seeds, N_FRAMES, after=snapshot)
    moved = seeds + (np.random.default_rng(1).normal(size=seeds.shape)
                     * SEED_SHIFT).astype(np.float32)
    # the same engine instance: its compiled programs serve the other runs
    spread_rows, _ = _run(vo, imgs, poses_gt, moved, N_FRAMES)
    # a second pose path: other images, other seeds
    poses2 = _camera_path(np.random.default_rng(5), N_FRAMES, 0.02)
    imgs2 = [synthetic.render(scene, geo.se3_exp(p)).astype(np.float32) for p in poses2]
    seeds2 = synthetic.sample_plane_points(scene, np.random.default_rng(6), 100,
                                           margin=20).astype(np.float32)
    boot2 = []
    rows2, _ = _run(vo, imgs2, poses2, seeds2, N_FRAMES, boot=boot2)
    return dict(scene=scene, poses_gt=poses_gt, imgs=imgs, seeds=seeds, moved=moved,
                jax=jax_rows, jax_traj=jax_traj, spread=spread_rows,
                imgs2=imgs2, jax2=rows2, jax2_boot=boot2[0], jax_ckpt=ckpt)


@pytest.fixture(scope="module")
def port(ref):
    vo = _torch_vo(ref["scene"])
    rows, traj = _run(vo, ref["imgs"], ref["poses_gt"], ref["seeds"], N_FRAMES)
    return rows, traj


def test_engine_matches_jax_frame_by_frame(ref, port):
    """Per-frame poses, live landmark counts and the newest keyframe's
    observation mask, against the JAX engine.  Measured: counts and masks
    equal at every frame, the port vs JAX and JAX against itself."""
    rows, traj = port
    gaps = [np.abs(p - q[0]).max() for (p, *_), q in zip(rows, ref["jax"])]
    spread = [np.abs(p - q[0]).max() for (p, *_), q in zip(ref["spread"], ref["jax"])]
    assert max(gaps) <= POSE_TOL, (gaps, spread)
    assert [r[1] for r in rows] == [r[1] for r in ref["jax"]]
    for (_, _, m), (_, _, mj) in zip(rows, ref["jax"]):
        assert int((m != mj).sum()) <= MASK_TOL
    np.testing.assert_allclose(traj, ref["jax_traj"], atol=POSE_TOL)


def test_jax_checkpoint_restores_into_the_port(ref, tmp_path):
    """The JAX engine's ``vo_state_dict`` after frame CKPT_FRAME, through
    an npz file, restores into a fresh port engine, which continues the
    sequence within POSE_TOL of the JAX engine's own run; the port writes
    the same keys, shapes and dtypes."""
    saved = ref["jax_ckpt"]
    checkpoint.save_checkpoint(tmp_path / "jax_vo", saved)
    vo = _torch_vo(ref["scene"])
    checkpoint.restore_vo_state(vo, checkpoint.restore_checkpoint(tmp_path / "jax_vo"))
    assert vo.frame_idx == CKPT_FRAME + 1
    mine = checkpoint.vo_state_dict(vo)
    assert sorted(mine) == sorted(saved)
    for k, v in saved.items():
        assert mine[k].shape == np.shape(v) and mine[k].dtype == np.asarray(v).dtype, k
    np.testing.assert_array_equal(mine["state.kf_pyr[1].img"], saved["state.kf_pyr[1].img"])
    poses = [vo.process_frame(img) for img in ref["imgs"][CKPT_FRAME + 1:N_FRAMES]]
    jax_poses = [r[0] for r in ref["jax"][CKPT_FRAME - 1:]]
    assert max(np.abs(p - q).max() for p, q in zip(poses, jax_poses)) <= POSE_TOL
    np.testing.assert_allclose(np.stack(vo.trajectory), ref["jax_traj"], atol=POSE_TOL)


def test_engine_run_frames_matches_process_frame(ref, port):
    vo = _torch_vo(ref["scene"])
    imgs = ref["imgs"]
    vo.bootstrap(imgs[0], imgs[1], ref["poses_gt"][0], ref["poses_gt"][1], ref["seeds"])
    poses = vo.run_frames(np.stack(imgs[2:N_FRAMES]))
    rows, traj = port
    np.testing.assert_allclose(poses, np.stack([r[0] for r in rows]), atol=CHUNK_TOL)
    np.testing.assert_allclose(np.stack(vo.trajectory), traj, atol=CHUNK_TOL)
    assert vo.frame_idx == N_FRAMES
    with pytest.raises(ValueError):
        vo.run_frames(np.stack(imgs[:3]))


def test_engine_tracks_the_true_trajectory(ref, port):
    """The config-4 accuracy bar of tests/test_vo_engine.py on this
    sequence: unaligned ATE under 0.01."""
    _, traj = port
    c_gt = np.stack([-geo.se3_exp(p)[:, :3].T @ geo.se3_exp(p)[:, 3] for p in ref["poses_gt"]])
    ate = float(ate_rmse(torch.tensor(traj, dtype=torch.float64), torch.tensor(c_gt),
                         with_scale=False))
    assert ate < 0.01, ate


def test_fill_slots_equals_jax():
    """Prefix-sum slot assignment, bit for bit: fewer, as many and more
    candidates than free slots, and more candidates than slots."""
    rng = np.random.default_rng(3)
    for L, C, p_valid, p_cand in ((32, 16, 0.5, 0.5), (32, 64, 0.3, 0.9),
                                  (16, 16, 0.9, 0.2), (8, 40, 0.0, 1.0), (24, 24, 1.0, 1.0)):
        lms = rng.normal(size=(L, 3)).astype(np.float32)
        valid = rng.uniform(size=L) < p_valid
        cands = rng.normal(size=(C, 3)).astype(np.float32)
        cvalid = rng.uniform(size=C) < p_cand
        want = jeng._fill_slots(jnp.asarray(lms), jnp.asarray(valid), jnp.asarray(cands),
                                jnp.asarray(cvalid))
        got = engine._fill_slots(torch.tensor(lms), torch.tensor(valid), torch.tensor(cands),
                                 torch.tensor(cvalid))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_engine_info_weighted_full_ba_matches_jax():
    """``odo_info_weighted=True`` with ``ba_mode="full"`` (the joint BA
    with information-weighted odometry priors, K5 for the photometric
    variance): bootstrap + 4 frames against the JAX engine, on a path
    of 2.7 x the main sequence's steps, so that frames 4 and 5 seed new
    landmarks.  Measured: the port vs JAX 2.4e-5 per pose at most, JAX
    against itself over 8 runs with the seeds moved by 1e-6 2.1e-5 (the
    port 1.3e-5); the limit is POSE_TOL."""
    rng = np.random.default_rng(0)
    scene, poses_gt, imgs, seeds = _setup(rng, 6, step=0.04)
    kw = dict(odo_info_weighted=True, ba_mode="full")
    rows_j, _ = _run(_jax_vo(scene, **kw), imgs, poses_gt, seeds, 6)
    vo = _torch_vo(scene, **kw)
    rows_t, _ = _run(vo, imgs, poses_gt, seeds, 6)
    for (p, n, m), (pj, nj, mj) in zip(rows_t, rows_j):
        assert np.abs(p - pj).max() <= POSE_TOL
        assert n == nj
        assert int((m != mj).sum()) <= MASK_TOL
    assert rows_t[-1][1] > rows_t[0][1]   # new landmarks were seeded
    info = vo.state.kf_rel_info
    assert bool(torch.isfinite(info).all()) and float(info.abs().sum()) > 0


def test_bootstrap_from_images_self_initialization():
    """tests/test_vo_engine.py::test_vo_engine_self_initialization's scene
    and motion in the port: more than 50 seeds from the essential-matrix
    bootstrap, and a scale-aligned ATE under 5 % of the path extent + 0.01."""
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, wh=(256, 192), fc=(240.0, 245.0),
                                 freq_range=(0.8, 8.0))
    poses_gt = [np.zeros(6)]
    for _ in range(1, 8):
        poses_gt.append(poses_gt[-1] + np.r_[0.02, 0.008, -0.03, rng.normal(size=3) * 0.001])
    imgs = [synthetic.render(scene, geo.se3_exp(p)) for p in poses_gt]
    tr = ICGNParams(lv_f=2, lv_l=0, psz=8, maxiter=8)
    cfg = engine.VOConfig(tracker=tr, max_landmarks=256, window=4, keyframe_stride=2,
                          corners_per_kf=256, min_parallax_px=0.5)
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, tr.num_levels, tr.psz,
                               device="cpu")
    vo = engine.VisualOdometry(cam, scene.fc, scene.cc, cfg, device="cpu")
    n_seeds = vo.bootstrap_from_images(imgs[0], imgs[1])
    assert n_seeds > 50, n_seeds
    for i in range(2, 8):
        vo.process_frame(imgs[i])
    traj = torch.tensor(np.stack(vo.trajectory), dtype=torch.float64)
    c_gt = np.stack([-geo.se3_exp(p)[:, :3].T @ geo.se3_exp(p)[:, 3] for p in poses_gt])
    ate = float(ate_rmse(traj, torch.tensor(c_gt), with_scale=True))
    extent = np.linalg.norm(c_gt[-1] - c_gt[0])
    assert ate < 0.05 * extent + 0.01, (ate, extent)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_engine_takes_its_inputs_in_its_own_precision(ref, dtype):
    """The bootstrap poses enter the engine as ``jnp.asarray(pose, dtype)``
    takes them: a float64 engine keeps a float64 pose whole (it once
    rounded it through float32 first, and the accuracy log's plane sweep
    in float64 then parted from the JAX package's float64 engine from
    its first tracked frame on), a float32 engine rounds it once."""
    tr = ICGNParams(lv_f=2, lv_l=0, psz=8, maxiter=6)
    scene = ref["scene"]
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, tr.num_levels, tr.psz,
                               device="cpu")
    vo = engine.VisualOdometry(cam, scene.fc, scene.cc,
                               engine.VOConfig(tracker=tr, **_cfg_kw()), device="cpu",
                               dtype=dtype)
    poses = np.asarray(ref["poses_gt"][:2], np.float64)
    vo.bootstrap(ref["imgs"][0], ref["imgs"][1], poses[0], poses[1], ref["seeds"])
    want = poses.astype(np.float32) if dtype == torch.float32 else poses
    got = vo.state.kf_poses[:2].numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(vo.state.cur_pose.numpy(), want[1])


def test_engine_multi_device_options_raise_and_default_device():
    """The multi-device BA options: the three VOConfig fields with the JAX
    package's defaults, and a BA mesh that is not a DeviceMesh is refused
    (the sharded engines themselves: tests/test_torch_ba_distributed_engine.py)."""
    for f in ("ba_mesh_axis", "ba_temporal_axis", "ba_temporal_cg_iters"):
        assert getattr(engine.VOConfig(), f) == getattr(jeng.VOConfig(), f)
    scene = synthetic.make_scene(np.random.default_rng(0), wh=(64, 48), fc=(60.0, 60.0))
    tr = ICGNParams(lv_f=1, lv_l=0, psz=8, maxiter=2)
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, tr.num_levels, tr.psz,
                               device="cpu")
    for kw in (dict(ba_mesh=object()), dict(ba_temporal_mesh="seq")):
        with pytest.raises(TypeError):
            engine.VisualOdometry(cam, scene.fc, scene.cc,
                                  engine.VOConfig(tracker=tr, **kw), device="cpu")
    if not torch.cuda.is_available():
        # the engine runs on the card unless the caller says otherwise
        with pytest.raises(RuntimeError):
            engine.VisualOdometry(cam, scene.fc, scene.cc, engine.VOConfig(tracker=tr))


def test_state_ring_host_mirror(ref):
    """The ring's host mirror follows the device state: kf_ptr advances
    one slot per keyframe and kf_valid_host equals kf_valid."""
    vo = _torch_vo(ref["scene"])
    imgs = ref["imgs"]
    vo.bootstrap(imgs[0], imgs[1], ref["poses_gt"][0], ref["poses_gt"][1], ref["seeds"])
    assert vo.state.kf_ptr == 1 and vo.kf_valid.tolist() == [True, True, False, False]
    for i in range(2, 8):
        vo.process_frame(imgs[i])
    assert vo.state.kf_ptr == 0   # keyframes at frames 2, 4, 6: slots 2, 3, 0
    assert vo.kf_valid.tolist() == vo.state.kf_valid.tolist() == [True] * 4
    G = lie.se3_exp(vo.state.kf_poses[vo.state.kf_ptr])
    assert torch.allclose(lie.camera_center(G), torch.tensor(vo.trajectory[6]), atol=1e-6)


@pytest.fixture(scope="module")
def batch(ref):
    """VisualOdometryBatch at S = 3: stream 0 the main run's seeds,
    stream 1 the moved seeds (both bootstrapped by the port), stream 2
    the second path from the JAX engine's bootstrapped state.  The batch
    runs frames 2-9 in chunks of one keyframe period, and each engine
    then runs the same frames alone from its own state (the batch stacks
    copies)."""
    streams = [(ref["imgs"], ref["seeds"]), (ref["imgs"], ref["moved"])]
    engines = []
    for imgs, seeds in streams:
        vo = _torch_vo(ref["scene"])
        vo.bootstrap(imgs[0], imgs[1], ref["poses_gt"][0], ref["poses_gt"][1], seeds)
        engines.append(vo)
    vo2 = _torch_vo(ref["scene"])
    vo2.state = convert.vo_state_from_numpy(ref["jax2_boot"], "cpu")
    engines.append(vo2)
    frames = np.stack([np.stack(imgs[2:N_FRAMES]) for imgs in (ref["imgs"], ref["imgs"],
                                                                ref["imgs2"])])
    b = engine.VisualOdometryBatch(engines)
    assert b.n_streams == 3
    chunks = []
    for a in range(0, N_FRAMES - 2, 2):
        poses = b.run_frames(frames[:, a:a + 2])
        chunks.append((poses, [b.state_of(s) for s in range(3)]))
    rows = [[] for _ in range(3)]       # per stream: (pose, live, newest kf mask)
    for poses, states in chunks:
        for s, st in enumerate(states):
            for j in range(2):
                rows[s].append((poses[s, j].astype(np.float64), int(st.lm_valid.sum()),
                                st.kf_obs_mask[st.kf_ptr].numpy().copy()))
    finals = [(b.state_of(s).landmarks.clone(), b.state_of(s).lm_valid.clone())
              for s in range(3)]
    single = [vo.run_frames(frames[s]) for s, vo in enumerate(engines)]
    return dict(rows=rows, finals=finals, engines=engines, single=single, b=b)


def test_batch_streams_equal_their_single_stream_runs(batch):
    """Each stream of the batch against the port's own engine run alone
    from the same state: the JAX test's limits (tests/test_vo_engine.py::
    test_vo_multistream_batch_matches_single), 1e-5 on the poses and 1e-4
    on the final landmarks.  Measured on the CPU: 0.0 on both (every
    reduction is per stream; the tracker's products take contiguous
    operands, whose sums do not depend on the batch)."""
    for s, vo in enumerate(batch["engines"]):
        got = np.stack([r[0] for r in batch["rows"][s]])
        np.testing.assert_allclose(got, batch["single"][s], atol=CHUNK_TOL)
        lms, valid = batch["finals"][s]
        assert torch.equal(valid, vo.state.lm_valid)
        np.testing.assert_allclose(lms.numpy(), vo.state.landmarks.numpy(), atol=1e-4)
    assert batch["b"].state_of(0).frame_idx == N_FRAMES == batch["b"]._frame_idx


def test_batch_streams_match_the_jax_engine(ref, batch):
    """Stream by stream against the JAX engine's runs: the seeds, the moved
    seeds, the second path (started from the JAX state): poses within
    POSE_TOL (PATH2_POSE_TOL on the second path), live landmark counts
    equal and the newest keyframe's mask within MASK_TOL at the end of
    every keyframe period."""
    for s, want in enumerate((ref["jax"], ref["spread"], ref["jax2"])):
        got = batch["rows"][s]
        gaps = [np.abs(g[0] - w[0]).max() for g, w in zip(got, want)]
        assert max(gaps) <= (PATH2_POSE_TOL if s == 2 else POSE_TOL), (s, gaps)
        for j in range(1, len(got), 2):
            assert got[j][1] == want[j][1], (s, j)
            assert int((got[j][2] != want[j][2]).sum()) <= MASK_TOL, (s, j)


def test_batch_rejects_what_it_cannot_stack(ref):
    scene = ref["scene"]
    with pytest.raises(ValueError):
        engine.VisualOdometryBatch([])
    a, b = _torch_vo(scene), _torch_vo(scene)
    imgs, gt = ref["imgs"], ref["poses_gt"]
    a.bootstrap(imgs[0], imgs[1], gt[0], gt[1], ref["seeds"])
    with pytest.raises(ValueError, match="bootstrap"):
        engine.VisualOdometryBatch([a, b])
    b.state = a.state._replace(kf_ptr=0)       # another ring position
    with pytest.raises(ValueError, match="rings differ"):
        engine.VisualOdometryBatch([a, b])
    c = _torch_vo(scene, huber_px=2.0)
    c.state = a.state
    with pytest.raises(ValueError, match="VOConfig"):
        engine.VisualOdometryBatch([a, c])
    batch2 = engine.VisualOdometryBatch([a, a])
    with pytest.raises(ValueError):
        batch2.run_frames(np.stack([np.stack(imgs[2:5])] * 2))     # 3 frames
    with pytest.raises(ValueError):
        batch2.run_frames(np.stack([np.stack(imgs[2:4])] * 3))     # 3 streams
