"""The rest of ``vo/`` and ``utils/checkpoint.py`` (horizon, VGG
features, checkpoint round trip, NVM replay) against the JAX package on
the CPU.  The JAX engine's checkpoint restoring into the port is in
tests/test_torch_engine.py, which has a compiled JAX engine at hand.

Seeded numpy inputs go to both packages as explicit float32; each
tolerance comes from the JAX package's own float32-vs-float64 gap of the
same call, measured in the test (the JAX float32 reference runs with x64
off, as the package runs outside the tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.vo import features_dnn as jfeat
from invcompcamtrack_tpu.vo import horizon as jhorizon
from invcompcamtrack_tpu.vo import replay as jreplay
from invcompcamtrack_torch import ICGNParams, convert
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.ops import patch_gather
from invcompcamtrack_torch.utils import checkpoint, io
from invcompcamtrack_torch.vo import engine, features_dnn, horizon, replay, synthetic
from tests.oracles import geometry_np as geo


def disable_x64():
    """JAX as it runs outside the tests: float32 by default."""
    return jax.enable_x64(False)


def _horizon_image(rng, H=120, W=160, fc=(100.0, 100.0), cc=(80.0, 60.0)):
    """tests/test_aux_subsystems.py's sky/ground image with a known tilt."""
    w_gt = np.array([0.06, 0.0, -0.08])
    R = geo.se3_exp(np.r_[np.zeros(3), w_gt])[:, :3]
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    d = np.stack([(uu - cc[0]) / fc[0], (vv - cc[1]) / fc[1], np.ones_like(uu)], -1)
    img = np.where((d @ R)[..., 1] < 0, 200.0, 40.0) + rng.normal(size=(H, W)) * 2.0
    return img.astype(np.float32), fc, cc, w_gt


def test_horizon_loss_gradient_and_steps_match_jax():
    img, fc, cc, w_gt = _horizon_image(np.random.default_rng(0))
    w = np.float32([0.03, 0.01, -0.05])
    lg = jax.jit(jax.value_and_grad(lambda v, im: jhorizon.horizon_loss(v, im, fc, cc)))
    with disable_x64():
        v32, g32 = (np.asarray(a) for a in lg(jnp.asarray(w), jnp.asarray(img)))
        assert g32.dtype == np.float32
    v64, g64 = (np.asarray(a) for a in lg(jnp.asarray(w, jnp.float64),
                                         jnp.asarray(img, jnp.float64)))
    val, g = horizon.loss_and_grad(torch.from_numpy(w), torch.from_numpy(img), fc, cc)
    for got, a32, a64, what in ((val, v32, v64, "loss"), (g, g32, g64, "gradient")):
        gap = float(np.abs(a32 - a64).max())
        err = float(np.abs(got.numpy() - a64).max())
        assert err <= 2 * gap + 1e-4 * float(np.abs(a64).max()), (what, err, gap)

    def steps(module, im, n):
        return module.estimate_orientation(im, fc, cc, num_iters=n, lr=2e-3)

    with disable_x64():
        w32, l32 = (np.asarray(a) for a in steps(jhorizon, jnp.asarray(img), 5))
    w64, l64 = (np.asarray(a) for a in steps(jhorizon, jnp.asarray(img, jnp.float64), 5))
    w_t, l_t = steps(horizon, torch.from_numpy(img), 5)
    gap = float(np.abs(w32 - w64).max())
    assert float(np.abs(w_t.numpy() - w64).max()) <= 2 * gap + 1e-6
    assert abs(float(l_t) - float(l64)) <= 2 * abs(float(l32) - float(l64)) + 1e-3
    assert float(l_t) < float(horizon.horizon_loss(torch.zeros(3), torch.from_numpy(img), fc, cc))


@pytest.fixture(scope="module")
def features():
    """The JAX extractor's random weights carried into the port
    (convert.features_params_from_numpy), and both packages' maps of one
    64x64 image."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (64, 64)).astype(np.float32)
    with disable_x64():
        mod, params = jfeat.init_features(jax.random.PRNGKey(0), image_shape=(64, 64))
        maps32 = [np.asarray(m) for m in jfeat.extract_feature_maps(mod, params, jnp.asarray(img))]
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    maps64 = [np.asarray(m) for m in mod.apply(p64, jnp.asarray(img, jnp.float64))]
    port = features_dnn.VGGFeatures()
    port.load_state_dict(convert.features_params_from_numpy(params))
    maps = features_dnn.extract_feature_maps(port, torch.from_numpy(img))
    return dict(img=img, maps32=maps32, maps64=maps64, maps=maps, mod=mod, params=params)


def test_vgg_features_match_jax(features):
    for s, (got, a32, a64) in enumerate(zip(features["maps"], features["maps32"],
                                           features["maps64"])):
        got = got.permute(1, 2, 0).numpy()     # CHW -> the JAX module's HWC
        assert got.shape == a32.shape
        gap = float(np.abs(a32 - a64).max())
        err = float(np.abs(got - a64).max())
        assert err <= 2 * gap + 1e-6 * float(np.abs(a64).max()), (s, err, gap)
    # random weights from an explicit generator: flax's lecun_normal scale
    fresh = features_dnn.init_features(torch.Generator().manual_seed(0), device="cpu")
    w0 = fresh.conv1_0.weight.detach()
    assert abs(float(w0.std()) * np.sqrt(32 * 9) - 1.0) < 0.1
    assert float(w0.abs().max()) <= 2.0 / np.sqrt(32 * 9) / 0.87962566103423978 + 1e-6
    same = features_dnn.init_features(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(same.conv2_1.weight, fresh.conv2_1.weight)


def test_feature_descriptors_match_jax_and_one_plane_calls(features):
    """The stacked gather (one K5 launch on the card) on the JAX stage-0
    maps: equal to the JAX module's channel-by-channel descriptors, and
    bit for bit to C one-plane calls."""
    feat = features["maps32"][0]                        # (H, W, C)
    rng = np.random.default_rng(2)
    cen = np.c_[rng.uniform(-3, 66, 40), rng.uniform(-3, 66, 40)].astype(np.float32)
    cen[:3] = [[0.0, 0.0], [63.0, 63.0], [31.0, 17.5]]
    with disable_x64():
        want = np.asarray(jfeat.feature_patch_descriptors(jnp.asarray(feat), jnp.asarray(cen)))
    chw = torch.from_numpy(np.ascontiguousarray(feat.transpose(2, 0, 1)))
    got = features_dnn.feature_patch_descriptors(chw, torch.from_numpy(cen))
    assert got.shape == want.shape == (40, 8, 8, feat.shape[-1])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * float(np.abs(want).max()))
    planes = torch.nn.functional.pad(chw[None], (8, 8, 8, 8), mode="replicate")[0]
    one = torch.stack([patch_gather.gather_patches(planes[c].contiguous(),
                                                   torch.from_numpy(cen), 8, 8)
                       for c in range(chw.shape[0])], dim=-1)
    assert torch.equal(got, one)


def _small_engine(rng):
    """tests/test_aux_subsystems.py's checkpoint scene (192x144), the
    port's engine on the CPU."""
    scene = synthetic.make_scene(rng, wh=(192, 144), fc=(170.0, 172.0))
    poses_gt = [np.zeros(6)]
    for _ in range(1, 9):
        poses_gt.append(poses_gt[-1] + np.r_[0.008, 0.002, 0.003, rng.normal(size=3) * 0.001])
    imgs = [synthetic.render(scene, geo.se3_exp(p)).astype(np.float32) for p in poses_gt]
    tracker = ICGNParams(lv_f=2, lv_l=0, psz=8, maxiter=6)
    cfg = engine.VOConfig(tracker=tracker, max_landmarks=128, window=3, keyframe_stride=2,
                          corners_per_kf=128)
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, tracker.num_levels,
                               tracker.psz, device="cpu")

    def fresh():
        return engine.VisualOdometry(cam, scene.fc, scene.cc, cfg, device="cpu")

    seeds = synthetic.sample_plane_points(scene, rng, 100, margin=20).astype(np.float32)
    return fresh, imgs, poses_gt, seeds


def test_checkpoint_round_trip_continues_bit_for_bit(tmp_path):
    fresh, imgs, poses_gt, seeds = _small_engine(np.random.default_rng(0))
    vo = fresh()
    vo.bootstrap(imgs[0], imgs[1], poses_gt[0], poses_gt[1], seeds)
    for i in range(2, 5):   # frame 4 is a keyframe
        vo.process_frame(imgs[i])
    checkpoint.save_checkpoint(tmp_path / "vo", checkpoint.vo_state_dict(vo))
    saved = checkpoint.restore_checkpoint(tmp_path / "vo")
    assert "state.kf_pyr[2].dy" in saved and saved["state.kf_ptr"].dtype == np.int32
    vo2 = fresh()
    checkpoint.restore_vo_state(vo2, saved)
    assert vo2.frame_idx == vo.frame_idx == 5
    assert vo2.states.kf_valid_host == vo.states.kf_valid_host
    for i in range(5, 9):
        np.testing.assert_array_equal(vo.process_frame(imgs[i]), vo2.process_frame(imgs[i]))
    np.testing.assert_array_equal(np.stack(vo.trajectory), np.stack(vo2.trajectory))
    # a flat dict of arrays round-trips as it is
    tree = {"a": np.arange(6.0).reshape(2, 3), "flag": np.asarray(True)}
    checkpoint.save_checkpoint(tmp_path / "t", tree)
    back = checkpoint.restore_checkpoint(tmp_path / "t")
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])


def test_nvm_model_io_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    quats = [q if q[0] >= 0 else -q for q in
             (v / np.linalg.norm(v) for v in rng.normal(size=(3, 4)))]
    centers, points = rng.normal(size=(3, 3)), rng.normal(size=(30, 3)) * [2, 5, 1] + [3, -2, 10]
    names = [f"im_{i}.png" for i in range(3)]
    replay.write_nvm(tmp_path / "p.nvm", [500.0, 501, 502], quats, centers, names, points)
    jreplay.write_nvm(tmp_path / "j.nvm", [500.0, 501, 502], quats, centers, names, points)
    assert (tmp_path / "p.nvm").read_text() == (tmp_path / "j.nvm").read_text()
    for a, b in zip(replay.normalize_model(points, centers),
                    jreplay.normalize_model(points, centers)):
        np.testing.assert_array_equal(a, b)
    model = io.read_nvm(tmp_path / "p.nvm")
    np.testing.assert_allclose(replay.model_poses(model), jreplay.model_poses(model),
                               atol=1e-12)


def test_replay_sequence_tracks_the_model_cameras(tmp_path):
    """tests/test_nvm_replay.py's scenario cut to 3 frames, through the
    port's pair-tracker CLI on the CPU: every frame's camera-centre error
    under that test's 0.01 (normalised units)."""
    nvm_path, paths, fc, cc, wh = replay.make_synthetic_nvm_scenario(
        np.random.default_rng(0), tmp_path / "scn", n_frames=3, wh=(192, 160),
        fc=(180.0, 184.0), n_points=300, step=0.015)
    poses, err = replay.replay_sequence(nvm_path, paths, tmp_path / "wk", fc, cc, wh,
                                        lv_f=2, maxiter=8, subsample=4, dopatchnorm=1,
                                        device="cpu")
    assert poses.shape == (3, 6)
    assert err[0] < 1e-9 and np.all(err[1:] < 0.01), err


def test_entry_points_default_to_the_card():
    """Without a device and without a card, the slice's constructors
    raise (they never fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        features_dnn.init_features()
    from invcompcamtrack_torch.sfm.trajectory import bending_stiffness

    with pytest.raises(RuntimeError, match="device='cpu'"):
        bending_stiffness(5)
