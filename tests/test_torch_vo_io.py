"""The port's copies of the JAX package's jax-free ``utils/metrics.py``
and ``vo/datasets.py`` against the originals, on files written by the
test, and ``examples/run_kitti_vo_torch.py`` on the CPU: its KITTI branch
on a small sequence written in the dataset's layout (no dataset is in the
repository) and its synthetic fallback.
"""

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.utils import metrics as jmetrics
from invcompcamtrack_tpu.vo import datasets as jdatasets
from invcompcamtrack_tpu.vo import synthetic
from invcompcamtrack_torch.utils import metrics
from invcompcamtrack_torch.vo import datasets
from tests.oracles import geometry_np as geo
import tests.torch_helpers  # noqa: F401  (one torch thread per process)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_example():
    spec = importlib.util.spec_from_file_location(
        "run_kitti_vo_torch", ROOT / "examples" / "run_kitti_vo_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_metrics_logger_copy_equals_the_original(tmp_path):
    rows = [dict(frame=i, landmarks=100 + i, step_ms=round(3.5 * i + 0.25, 1))
            for i in range(5)]
    out = {}
    for name, mod in (("jax", jmetrics), ("port", metrics)):
        path = tmp_path / f"{name}.jsonl"
        log = mod.MetricsLogger(str(path))
        recorded = [log.record(**r) for r in rows]
        out[name] = (recorded, log.summary("step_ms"), log.summary("missing"),
                     [json.loads(line) for line in path.read_text().splitlines()])
        log.close()
        log.close()
    for a, b in ((out["jax"][0], out["port"][0]), (out["jax"][3], out["port"][3])):
        assert [{k: v for k, v in r.items() if k != "t"} for r in a] == \
            [{k: v for k, v in r.items() if k != "t"} for r in b]
        assert all(set(r) == {"t", "frame", "landmarks", "step_ms"} for r in b)
    assert out["jax"][1:3] == out["port"][1:3]
    assert metrics.MetricsLogger().record(a=1)["a"] == 1   # no file


def _write_kitti(root, wh=(256, 192), n=6):
    """A KITTI odometry layout: sequences/00 with calib, times, left and
    right PNG frames rendered from a textured plane, and poses/00.txt
    (camera-to-world rows).  Returns the scene and the true poses."""
    from PIL import Image

    rng = np.random.default_rng(0)
    fc = (240.0, 245.0)
    scene = synthetic.make_scene(rng, wh=wh, fc=fc, freq_range=(0.8, 8.0))
    poses = [np.zeros(6)]
    for _ in range(1, n):
        poses.append(poses[-1] + np.r_[0.02, 0.008, -0.03, rng.normal(size=3) * 0.001])
    seq = root / "sequences" / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir()
    (root / "poses").mkdir()
    cx, cy = scene.cc
    P0 = f"P0: {fc[0]} 0 {cx} 0 0 {fc[1]} {cy} 0 0 0 1 0"
    P1 = f"P1: {fc[0]} 0 {cx} {-0.5 * fc[0]} 0 {fc[1]} {cy} 0 0 0 1 0"
    (seq / "calib.txt").write_text(P0 + "\n" + P1 + "\n")
    (seq / "times.txt").write_text("".join(f"{0.1 * i:.1f}\n" for i in range(n)))
    rows = []
    for i, p in enumerate(poses):
        G = geo.se3_exp(p)
        img = np.clip(np.rint(synthetic.render(scene, G)), 0, 255).astype(np.uint8)
        for cam in ("image_0", "image_1"):
            Image.fromarray(img).save(seq / cam / f"{i:06d}.png")
        R = G[:, :3]
        rows.append(np.c_[R.T, -R.T @ G[:, 3]].reshape(-1))
    np.savetxt(root / "poses" / "00.txt", np.stack(rows))
    return scene, np.stack(poses)


def _write_euroc(root, n=4):
    cam = root / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    gt = root / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    stamps = [1403636579763555584 + 50_000_000 * i for i in range(n)]
    (cam / "data.csv").write_text("#timestamp [ns],filename\n" + "".join(
        f"{t},{t}.png\n" for t in stamps))
    (gt / "data.csv").write_text("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n" + "".join(
        f"{t},{0.1 * i},{-0.2 * i},{0.3},1.0,0.0,0.0,{0.01 * i}\n"
        for i, t in enumerate(stamps)))


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_dataset_readers_copy_equals_the_original(tmp_path):
    _write_kitti(tmp_path, n=3)
    _write_euroc(tmp_path / "euroc")
    k_j = jdatasets.load_kitti_sequence(tmp_path, "00")
    k_t = datasets.load_kitti_sequence(tmp_path, "00")
    for (name, a), b in zip(_fields(k_j).items(), _fields(k_t).values()):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert (k_t.fc, k_t.cc, k_t.baseline) == (k_j.fc, k_j.cc, k_j.baseline)
    np.testing.assert_array_equal(datasets.kitti_gt_centers(k_t.poses_gt),
                                  jdatasets.kitti_gt_centers(k_j.poses_gt))
    calib = tmp_path / "sequences" / "00" / "calib.txt"
    assert datasets.read_kitti_calib(calib).keys() == jdatasets.read_kitti_calib(calib).keys()
    e_j = jdatasets.load_euroc_sequence(tmp_path / "euroc")
    e_t = datasets.load_euroc_sequence(tmp_path / "euroc")
    for (name, a), b in zip(_fields(e_j).items(), _fields(e_t).values()):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert len(e_t.image_paths) == 4 and e_t.gt_positions.shape == (4, 3)


def test_kitti_example_runs_on_a_written_sequence(tmp_path, capsys):
    """The example's dataset branch on the CPU: the port's readers, PNG
    frames through ``load_gray``, the essential-matrix bootstrap with the
    GT baseline's scale, and the engine over 6 frames."""
    _, poses = _write_kitti(tmp_path, n=6)
    ex = _load_example()
    traj, ate = ex.main([str(tmp_path), "00", "--frames", "6", "--device", "cpu",
                         "--log", str(tmp_path / "log.jsonl")])
    assert traj.shape == (6, 3) and np.isfinite(traj).all()
    c_gt = np.stack([-geo.se3_exp(p)[:, :3].T @ geo.se3_exp(p)[:, 3] for p in poses])
    extent = np.linalg.norm(c_gt[-1] - c_gt[0])
    assert ate < 0.05 * extent + 0.01, (ate, extent)
    assert "ATE-RMSE" in capsys.readouterr().out
    assert len((tmp_path / "log.jsonl").read_text().splitlines()) == 4


def test_kitti_example_synthetic_fallback_and_device(capsys):
    """The fallback's scale-aligned ATE within the GT-free bootstrap's
    bound of tests/test_vo_engine.py (5 % of the path + 0.01)."""
    ex = _load_example()
    traj, ate = ex.main(["--frames", "6", "--device", "cpu"])
    c_gt = ex.synthetic_sequence(6)[2]
    assert traj.shape == (6, 3) and np.isfinite(traj).all()
    assert ate < 0.05 * np.linalg.norm(c_gt[-1] - c_gt[0]) + 0.01, ate
    assert "synthetic fallback" in capsys.readouterr().out
    if not torch.cuda.is_available():
        # the example runs on the card unless --device says otherwise
        with pytest.raises(RuntimeError):
            ex.main(["--frames", "4"])
