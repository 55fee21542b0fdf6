"""The port's two CLIs against the JAX package's on the same input
files (the reference binaries' protocols), ``device="cpu"``, and the
port's own copies of ``config.py``, ``utils/io.py``, ``utils/image.py``
and ``vo/synthetic.py`` against the originals.

The tests/test_cli.py scene: 192x160 PNG frames (uint8-quantised), 40
points, frame 0 at the identity pose.  Tolerances, from measurements on
these very files (float32 on both sides):
- ``track_pair``: port-vs-JAX 3e-6 (psz 8) and 3.6e-5 (psz 4 with
  dopatchnorm, 16 pixels per patch; JAX's own float32-vs-float64 gap
  there 1e-5): PAIR_ATOL 1e-4.
- ``track_nposes`` (frames 1 and 2, ``fb_frames = (0, 1)``: the forward
  chain; tests/test_torch_chain.py holds both chains against the JAX
  chain): poses port-vs-JAX 7.2e-6 through the result file's 8
  significant digits (JAX's own float32-vs-float64 gap on this scene
  2e-6 to 1.4e-4): NPOSES_ATOL 2e-5.  The file holds the correlations
  with 3 significant digits, and a score next to a rounding boundary
  falls either way: one unit of the last digit, atol 1.01e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from invcompcamtrack_tpu import config as jconfig
from invcompcamtrack_tpu.cli import track_nposes as jcli_nposes
from invcompcamtrack_tpu.cli import track_pair as jcli_pair
from invcompcamtrack_tpu.utils import image as jimage
from invcompcamtrack_tpu.utils import io as jio
from invcompcamtrack_tpu.vo import synthetic as jsynthetic
from invcompcamtrack_torch import config, device
from invcompcamtrack_torch.cli import track_nposes as cli_nposes
from invcompcamtrack_torch.cli import track_pair as cli_pair
from invcompcamtrack_torch.utils import image, io
from invcompcamtrack_torch.vo import synthetic
from tests.oracles import geometry_np as geo
import tests.torch_helpers  # noqa: F401  (caps torch's threads)

PAIR_ATOL = 1e-4
NPOSES_ATOL = 2e-5


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """Three frames as PNG files, the pair tracker's binary input and the
    verifier's text input, written by the PORT's io module."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, wh=(192, 160), fc=(180.0, 184.0))
    poses = [np.zeros(6)]
    for _ in range(2):
        poses.append(poses[-1] + np.r_[rng.normal(size=3) * 0.01,
                                       rng.normal(size=3) * 0.004])
    poses = np.stack(poses)
    imgs = [synthetic.render(scene, geo.se3_exp(p)) for p in poses]
    X = synthetic.sample_plane_points(scene, rng, 40, margin=20)
    files = []
    for i, im in enumerate(imgs):
        image.save_gray(tmp / f"f{i}.png", im)
        files.append(str(tmp / f"f{i}.png"))

    uv0, _ = geo.project(geo.se3_exp(poses[0]), X, *scene.fc, *scene.cc)
    pair_in = tmp / "pair_in.bin"
    io.write_pointcam(pair_in, io.PointCamFile(
        pose=poses[0], fc=np.asarray(scene.fc, np.float32),
        cc=np.asarray(scene.cc, np.float32), wh=np.asarray(scene.wh, np.uint32),
        pt3d=X, pt2d=uv0.astype(np.float32)))

    uv1, _ = geo.project(geo.se3_exp(poses[1]), X, *scene.fc, *scene.cc)
    p_bad = poses[1] + np.r_[0.6, -0.5, 0.3, 0.25, -0.2, 0.15]
    nposes_in = tmp / "np_in.txt"
    io.write_nposes_input(nposes_in, io.NPosesInput(
        params=dict(lv_f=2, lv_l=0, psz=8, maxiter=6, normdp_ratio=0.01, donorm=1,
                    dopatchnorm=0, maxpttrack=100, verbosity=0),
        fc=np.asarray(scene.fc), cc=np.asarray(scene.cc), wh=np.asarray(scene.wh),
        fb_frames=(0, 1), filenames=files[1:], pt2d=uv1, pt3d=X,
        poses=np.stack([poses[1], p_bad]),
        inlier_ids=[np.arange(1, 41), np.arange(1, 41, 2)]))
    return dict(tmp=tmp, scene=scene, poses=poses, imgs=imgs, X=X, files=files,
                pair_in=pair_in, nposes_in=nposes_in)


@pytest.mark.parametrize("args", [
    ["2", "0", "8", "6", "0.01", "1", "0", "100", "0"],
    ["1", "0", "4", "5", "0.01", "1", "1", "100", "2"],
], ids=["psz8", "psz4-patchnorm-verbose"])
def test_track_pair_cli_matches_jax_cli(scene_files, args, capsys):
    f = scene_files
    out_t, out_j = f["tmp"] / "pair_t.bin", f["tmp"] / "pair_j.bin"
    head = [f["files"][0], f["files"][1], str(f["pair_in"])]
    assert cli_pair.main(["--device", "cpu", *head, str(out_t), *args]) == 0
    printed = capsys.readouterr().out
    assert jcli_pair.main([*head, str(out_j), *args]) == 0
    p_t, p_j = io.read_pose_result(out_t), jio.read_pose_result(out_j)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=PAIR_ATOL)
    if args[-1] == "2":
        lines = [ln for ln in printed.splitlines() if ln.startswith("Sc") and "iters" in ln]
        assert [ln[:5] for ln in lines] == ["Sc01:", "Sc00:"]
    else:
        G, Gg = geo.se3_exp(p_t), geo.se3_exp(f["poses"][1])
        err = np.linalg.norm(-G[:, :3].T @ G[:, 3] + Gg[:, :3].T @ Gg[:, 3])
        assert err < 5e-3, err      # the bound of tests/test_cli.py


def test_track_pair_cli_timing_mode_and_usage(scene_files, capsys):
    """verbosity 1 repeats the tracking 1000 times and prints the
    reference's line; a wrong argument count prints the usage."""
    f = scene_files
    out = f["tmp"] / "pair_time.bin"
    rc = cli_pair.main([f["files"][0], f["files"][1], str(f["pair_in"]), str(out),
                        "0", "0", "8", "1", "0.01", "0", "0", "100", "1"], device="cpu")
    assert rc == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("TIME (pose tracking) (musec):")]
    assert len(line) == 1 and 0 < float(line[0].split(":")[1]) < 3e5
    assert io.read_pose_result(out).shape == (6,)
    assert cli_pair.main(["--device", "cpu", "too", "few"]) == 2
    assert cli_nposes.main(["only-one"], device="cpu") == 2
    assert "IMG_A IMG_B INFILE OUTFILE" in capsys.readouterr().out


def test_track_nposes_cli_matches_jax_cli(scene_files):
    f = scene_files
    out_t, out_j = f["tmp"] / "np_t.txt", f["tmp"] / "np_j.txt"
    assert cli_nposes.main(["--device", "cpu", str(f["nposes_in"]), str(out_t)]) == 0
    assert jcli_nposes.main([str(f["nposes_in"]), str(out_j)]) == 0
    tracks_t, corr_t = io.read_nposes_result(out_t, num_images=2)
    tracks_j, corr_j = jio.read_nposes_result(out_j, num_images=2)
    assert tracks_t.shape == (2, 2, 6) and [len(c) for c in corr_t] == [40, 20]
    np.testing.assert_allclose(tracks_t, tracks_j, rtol=0, atol=NPOSES_ATOL)
    for a, b in zip(corr_t, corr_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=1.01e-3)
    assert np.mean(corr_t[0]) > 0.8 and np.mean(corr_t[0]) > np.mean(corr_t[1])


def test_run_takes_arrays_and_entry_points_default_to_the_card(scene_files):
    """``run`` drives everything but the image decoder; without a card
    the default device raises instead of falling back to the CPU."""
    f = scene_files
    data = io.read_nposes_input(f["nposes_in"])
    imgs = [image.load_gray(name) for name in data.filenames]
    tracks, rows, res = cli_nposes.run(data, imgs, device="cpu")
    assert tracks.dtype == np.float64 and tracks.shape == (2, 2, 6)
    assert res.correlations.shape == (2, 40) and len(rows[1]) == 20
    assert bool((res.correlations[1, 1::2] == -1.0).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device.default_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_nposes.run(data, imgs)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_pair.main([f["files"][0], f["files"][1], str(f["pair_in"]),
                           str(f["tmp"] / "x.bin"), "1", "0", "8", "2", "0.01", "1",
                           "0", "100", "0"])
    assert device.resolve("cpu") == torch.device("cpu")


# ------------------------------------------------ the port's own copies


def test_config_copy_equals_the_original():
    fields = lambda cls: [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]
    assert fields(config.ICGNParams) == fields(jconfig.ICGNParams)
    for kw in (dict(), dict(lv_f=2, lv_l=1, psz=6), dict(psz=16, window_cache=False)):
        a, b = config.ICGNParams(**kw), jconfig.ICGNParams(**kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for prop in ("window_size", "pszd2", "novals", "num_levels"):
            assert getattr(a, prop) == getattr(b, prop)
        assert hash(a) == hash(config.ICGNParams(**kw))
    for bad in (dict(psz=7), dict(lv_f=1, lv_l=2)):
        for cls in (config.ICGNParams, jconfig.ICGNParams):
            with pytest.raises(ValueError):
                cls(**bad)


def test_io_copy_writes_the_same_bytes_and_reads_the_same_arrays(scene_files, tmp_path):
    f = scene_files
    rng = np.random.default_rng(5)

    def same_bytes(name, write, jwrite, *args, **kw):
        a, b = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
        write(a, *args, **kw)
        jwrite(b, *args, **kw)
        assert a.read_bytes() == b.read_bytes(), name
        return a

    flow = rng.normal(size=(7, 9, 2)).astype(np.float32)
    pa = same_bytes("x.flo", io.write_flo, jio.write_flo, flow)
    np.testing.assert_array_equal(io.read_flo(pa), jio.read_flo(pa))
    np.testing.assert_array_equal(io.read_flo(pa), flow)
    depth = rng.uniform(size=(6, 5)).astype(np.float32)
    for le in (True, False):
        pa = same_bytes(f"x{le}.pfm", io.write_pfm, jio.write_pfm, depth, little_endian=le)
        np.testing.assert_array_equal(io.read_pfm(pa), jio.read_pfm(pa))
        np.testing.assert_array_equal(io.read_pfm(pa), depth)
    pose = rng.normal(size=6)
    pa = same_bytes("pose.bin", io.write_pose_result, jio.write_pose_result, pose)
    np.testing.assert_array_equal(io.read_pose_result(pa), jio.read_pose_result(pa))

    pc, jpc = io.read_pointcam(f["pair_in"]), jio.read_pointcam(f["pair_in"])
    for field in dataclasses.fields(io.PointCamFile):
        np.testing.assert_array_equal(getattr(pc, field.name), getattr(jpc, field.name))
    same_bytes("pc.bin", io.write_pointcam, jio.write_pointcam, pc)

    nin, jnin = io.read_nposes_input(f["nposes_in"]), jio.read_nposes_input(f["nposes_in"])
    assert nin.params == jnin.params and nin.filenames == jnin.filenames
    assert nin.fb_frames == jnin.fb_frames
    for name in ("fc", "cc", "wh", "pt2d", "pt3d", "poses"):
        np.testing.assert_array_equal(getattr(nin, name), getattr(jnin, name))
    for a, b in zip(nin.inlier_ids, jnin.inlier_ids):
        np.testing.assert_array_equal(a, b)
    same_bytes("np_in.txt", io.write_nposes_input, jio.write_nposes_input, nin)
    tracks = rng.normal(size=(2, 3, 6))
    rows = [rng.uniform(size=4), rng.uniform(size=2)]
    pa = same_bytes("np_out.txt", io.write_nposes_result, jio.write_nposes_result,
                    tracks, rows)
    got, want = io.read_nposes_result(pa, 3), jio.read_nposes_result(pa, 3)
    np.testing.assert_array_equal(got[0], want[0])
    xy, alive = rng.normal(size=(4, 3, 2)), rng.uniform(size=(4, 3)) > 0.5
    io.save_tracks(tmp_path / "tr.npz", xy, alive)
    for a, b in zip(io.load_tracks(tmp_path / "tr.npz"), jio.load_tracks(tmp_path / "tr.npz")):
        np.testing.assert_array_equal(a, b)
    assert io.read_nvm.__doc__ == jio.read_nvm.__doc__

    # the image helpers: the same file bytes, the same array read back
    pa = same_bytes("g.png", image.save_gray, jimage.save_gray, f["imgs"][0])
    np.testing.assert_array_equal(image.load_gray(pa), jimage.load_gray(pa))


def test_synthetic_copy_renders_the_same_images():
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    sa = synthetic.make_scene(rng_a, wh=(48, 40), fc=(60.0, 62.0))
    sb = jsynthetic.make_scene(rng_b, wh=(48, 40), fc=(60.0, 62.0))
    G = geo.se3_exp(np.r_[0.01, -0.02, 0.005, 0.004, -0.003, 0.002])
    np.testing.assert_array_equal(synthetic.render(sa, G), jsynthetic.render(sb, G))
    np.testing.assert_array_equal(synthetic.sample_plane_points(sa, rng_a, 7),
                                  jsynthetic.sample_plane_points(sb, rng_b, 7))
    ca = synthetic.make_corridor(rng_a, wh=(64, 48))
    cb = jsynthetic.make_corridor(rng_b, wh=(64, 48))
    np.testing.assert_array_equal(synthetic.render_corridor(ca, G),
                                  jsynthetic.render_corridor(cb, G))
    np.testing.assert_array_equal(synthetic.sample_corridor_points(ca, rng_a, 5, G),
                                  jsynthetic.sample_corridor_points(cb, rng_b, 5, G))
    img = synthetic.render(sa, G)
    out_a = synthetic.degrade_sequence([img, img], rng_a, 1.0, 0.1, 0.8)
    out_b = jsynthetic.degrade_sequence([img, img], rng_b, 1.0, 0.1, 0.8)
    for a, b in zip(out_a, out_b):
        np.testing.assert_array_equal(a, b)
