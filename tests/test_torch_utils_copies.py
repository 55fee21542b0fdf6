"""The port's own copies of the JAX package's jax-free host modules
(``utils/{rotation,splines,sensors,plot3d,native}.py``,
``parallel/model.py``) against the originals, one case per function, on the same inputs: host numpy code,
so equal bit for bit (``plot_cameras`` takes the port's float32 se3_exp,
held to float32 rounding).
"""

import numpy as np
import pytest

from invcompcamtrack_tpu.parallel import model as jmodel
from invcompcamtrack_tpu.utils import io as jio
from invcompcamtrack_tpu.utils import native as jnative
from invcompcamtrack_tpu.utils import plot3d as jplot3d
from invcompcamtrack_tpu.utils import rotation as jrotation
from invcompcamtrack_tpu.utils import sensors as jsensors
from invcompcamtrack_tpu.utils import splines as jsplines
from invcompcamtrack_torch.parallel import model
from invcompcamtrack_torch.utils import io, native, plot3d, rotation, sensors, splines


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _rotations(rng, n):
    return np.stack([rotation.rodrigues(rng.normal(size=3) * 0.7) for _ in range(n)])


@pytest.mark.parametrize("name", ["quat2dcm", "dcm2quat", "skew", "rodrigues",
                                  "android_rotvec_to_dcm", "integrate_gyro",
                                  "rotation_angle_deg", "interpolate_orientations"])
def test_rotation_copy(name):
    rng = np.random.default_rng(0)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    Rs = _rotations(rng, 5)
    t = np.linspace(0.0, 1.0, 5)
    args = {"quat2dcm": (q,), "dcm2quat": (Rs[0],), "skew": (rng.normal(size=3),),
            "rodrigues": (rng.normal(size=3),),
            "android_rotvec_to_dcm": (rng.normal(size=4) * 0.3, True),
            "integrate_gyro": (np.linspace(0, 1, 20), rng.normal(size=(20, 3))),
            "rotation_angle_deg": (Rs[0], Rs[1]),
            "interpolate_orientations": (t, Rs, np.linspace(0.1, 0.9, 7))}[name]
    _same(getattr(rotation, name)(*args), getattr(jrotation, name)(*args))


@pytest.mark.parametrize("name", ["smoothing_spline", "smoothing_spline_batch",
                                  "smoothing_spline_crossval_p", "double_integrate"])
def test_splines_copy(name):
    rng = np.random.default_rng(1)
    t = np.linspace(0, 4, 80)
    y = np.stack([np.sin(t), np.cos(2 * t)], 1) + rng.normal(size=(80, 2)) * 0.2
    args, kw = {"smoothing_spline": ((t, y, 0.9), {}),
                "smoothing_spline_batch": ((t, y, 0.9), dict(batchsize=30)),
                "smoothing_spline_crossval_p": ((t, y[:, :1]), dict(rounds=4, depth_iters=2)),
                "double_integrate": ((t, y), {})}[name]
    _same(getattr(splines, name)(*args, **kw), getattr(jsplines, name)(*args, **kw))


def test_sensors_copy(tmp_path):
    rows = ["0.0,4,0.1,0.2,0.3,82,0.01,0.02,0.03",
            "0.1,4,0.1,0.2,0.3,1,47.37,8.54,408.0",
            "0.2,84,0.0,0.0,0.1,83,0.0,0.0,9.81",
            "0.25,1,47.3701,8.5402,409.0,4,0.2,0.1,0.0",
            "0.3,4,0.0,0.0,0.0"]
    p = tmp_path / "imu.csv"
    p.write_text("\n".join(rows) + "\n")
    s, js = sensors.parse_imu_gps_csv(p), jsensors.parse_imu_gps_csv(p)
    for field in ("gps", "accel", "gyro", "orient", "linacc", "rotvec", "gravity"):
        _same(getattr(s, field), getattr(js, field))
    _same(sensors.gps_to_cartesian(s.gps[1]), jsensors.gps_to_cartesian(js.gps[1]))
    t = np.linspace(0, 1, 50)
    a = np.stack([np.ones(50), np.sin(t), np.zeros(50)], 1)
    empty = (np.array([]), np.zeros((0, 3)))
    kw = dict(gps=empty, accel=(t, a), gyro=(t, np.full((50, 3), 0.1)), orient=empty,
              linacc=(t, a), rotvec=empty, gravity=empty)
    _same(sensors.dead_reckon(sensors.SensorStreams(**kw), use_rotvec=False),
          jsensors.dead_reckon(jsensors.SensorStreams(**kw), use_rotvec=False))


def test_plot3d_copy():
    rng = np.random.default_rng(2)
    fc, cc, wh = (300.0, 305.0), (160.0, 120.0), (320, 240)
    R, t = _rotations(rng, 1)[0], rng.normal(size=3)
    _same(plot3d.camera_frustum_lines(fc, cc, wh, R, t, 1.5),
          jplot3d.camera_frustum_lines(fc, cc, wh, R, t, 1.5))

    class Axes:
        """Records what the plotting helpers draw and set."""

        def __init__(self):
            self.lines, self.lims = [], {}
            self.get_xlim3d = lambda: (-1.0, 2.0)
            self.get_ylim3d = lambda: (0.0, 5.0)
            self.get_zlim3d = lambda: (3.0, 3.5)

        def plot(self, *xyz, **kw):
            self.lines.append(np.asarray(xyz))

        def __getattr__(self, name):
            return lambda lo, hi: self.lims.__setitem__(name, (lo, hi))

    poses = rng.normal(size=(3, 6)) * 0.2
    mine, theirs = Axes(), Axes()
    plot3d.plot_cameras(mine, fc, cc, wh, poses)
    jplot3d.plot_cameras(theirs, fc, cc, wh, poses)
    assert len(mine.lines) == len(theirs.lines) == 48
    np.testing.assert_allclose(np.stack(mine.lines), np.stack(theirs.lines), atol=1e-5)
    plot3d.set_axes_equal(mine)
    jplot3d.set_axes_equal(theirs)
    assert mine.lims == theirs.lims and len(mine.lims) == 3


def test_native_copy(tmp_path):
    """The same library, built from native/ as the original builds it,
    or both on their host fallbacks where it cannot be built."""
    assert native.available() == jnative.available()
    rng = np.random.default_rng(3)
    paths = []
    for i in range(3):
        img = rng.integers(0, 255, size=(11, 17)).astype(np.uint8)
        p = tmp_path / f"f{i}.pgm"
        with open(p, "wb") as f:
            f.write(f"P5\n17 11\n255\n".encode() + img.tobytes())
        paths.append(str(p))
    _same(native.decode_pnm(paths[0]), jnative.decode_pnm(paths[0]))
    mine, theirs = native.SequencePrefetcher(paths), jnative.SequencePrefetcher(paths)
    assert len(mine) == len(theirs) == 3
    for i in (2, 0, 1):
        _same(mine.get(i), theirs.get(i))
    mine.close()
    theirs.close()
    data = io.PointCamFile(pose=rng.normal(size=6), fc=np.float32([300, 301]),
                           cc=np.float32([160, 120]), wh=np.uint32([320, 240]),
                           pt3d=rng.normal(size=(9, 3)),
                           pt2d=rng.normal(size=(9, 2)).astype(np.float32))
    io.write_pointcam(tmp_path / "pc.bin", data)
    a, b = native.read_pointcam_native(tmp_path / "pc.bin"), jnative.read_pointcam_native(
        tmp_path / "pc.bin")
    assert isinstance(a, io.PointCamFile) and isinstance(b, jio.PointCamFile)
    for k in ("pose", "fc", "cc", "wh", "pt3d", "pt2d"):
        _same(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("name, args", [
    ("tracker_psum_bytes", [(256, 10, 5), (16, 3, 2, 2)]),
    ("ba_psum_bytes", [(5, 12), (8, 6, "cg", 48), (32, 8, "cg", 64, 8)]),
    ("engine_keyframe_psums", [(5, 6, 6), (5, 6, 6, "cg", 48), (16, 4, 8, "dense", 32, 2)]),
    ("temporal_ba_psum_bytes", [(2048, 8, 64), (512, 6), (96, 12, 64, 8)]),
])
def test_parallel_model_copy(name, args):
    """Every byte count of the communication model equals the original's."""
    for a in args:
        assert getattr(model, name)(*a) == getattr(jmodel, name)(*a)


def test_parallel_model_step_copy():
    """``model_step`` takes the link's all-reduce rate as an argument (the
    port states none); passed the JAX module's own constant it returns
    the JAX module's model, efficiency included."""
    assert not hasattr(model, "V5E_ICI_ALLREDUCE_BYTES_PER_S")
    rate = jmodel.V5E_ICI_ALLREDUCE_BYTES_PER_S
    for b, c, n, lat in ((1e6, 0.01, 0, 0.0), (3.5e7, 0.2, 120, 2e-5)):
        mine = model.model_step(b, c, rate, n_collectives=n, latency_per_collective_s=lat)
        theirs = jmodel.model_step(b, c, n_collectives=n, latency_per_collective_s=lat)
        assert mine == model.CommModel(theirs.bytes_per_step, theirs.comm_time_s,
                                       theirs.compute_time_s)
        assert mine.scaling_efficiency == theirs.scaling_efficiency
