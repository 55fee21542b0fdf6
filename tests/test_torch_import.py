"""The port stands without JAX, and chip_smoke.py refuses to run where
it cannot drive the card.  Both run in subprocesses: conftest.py has
already imported JAX into this one."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package, imports
    without bringing in JAX or anything of the JAX package (the engines
    ``VisualOdometry`` and ``VisualOdometryBatch`` among them, and the
    multi-device modules of ``parallel/`` and ``ba/``); and no source line
    of the port, of chip_smoke.py or of an example twin
    (``examples/*_torch.py``) names either, ``tests`` or a JAX example in
    an import."""
    code = ("import importlib, pkgutil, sys\n"
            "import invcompcamtrack_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "from invcompcamtrack_torch.vo.engine import VisualOdometry, VisualOdometryBatch\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'invcompcamtrack_tpu'))\n"
            "slice4 = {'ba.window', 'sfm.triangulate', 'sfm.epipolar', 'sfm.twoview',\n"
            "          'vo.engine', 'vo.metrics', 'vo.datasets', 'utils.metrics'}\n"
            "slice5 = {'sfm.pnp', 'sfm.ransac', 'sfm.stereo', 'sfm.covariance',\n"
            "          'sfm.trajectory', 'ba.pose_graph', 'vo.rig', 'vo.horizon',\n"
            "          'vo.replay', 'vo.features_dnn', 'utils.checkpoint', 'utils.plot3d',\n"
            "          'utils.rotation', 'utils.splines', 'utils.sensors', 'utils.native'}\n"
            "slice6 = {'ba.distributed', 'ba.temporal', 'parallel', 'parallel.comm',\n"
            "          'parallel.mesh', 'parallel.model', 'parallel.runtime',\n"
            "          'parallel.pipeline', 'parallel.vo_pipeline'}\n"
            "assert slice4 | slice5 | slice6 <= {n.split('.', 1)[1] for n in names}, names\n"
            "print(len(names), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = _run(["-c", code], REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert bad == "[]"
    # the walk saw the package: every slice's modules are among them
    assert int(count) >= 77, res.stdout
    twins = sorted((REPO / "examples").glob("*_torch.py"))
    assert {p.stem for p in twins} >= {
        "run_of_point_track_torch", "run_kitti_vo_torch", "run_stereo_track_torch",
        "run_nvm_sequence_torch", "run_temporal_scale_torch", "stream_batch_gap_torch",
        "run_accuracy_log_torch", "run_robustness_torch", "run_accuracy_suite_torch",
        "run_flow_epe_torch", "run_ncc_eval_torch"}, twins
    jax_examples = {p.stem for p in (REPO / "examples").glob("*.py")} - {p.stem for p in twins}
    sources = [*sorted((REPO / "invcompcamtrack_torch").rglob("*.py")), REPO / "chip_smoke.py",
               *twins]
    for path in sources:
        for ln in path.read_text().splitlines():
            words = ln.split("#")[0].split()
            if words[:1] in (["import"], ["from"]):
                for name in words[1:] if words[0] == "import" else words[1:2]:
                    top = name.strip(",").split(".")[0]
                    assert not top.startswith(("jax", "invcompcamtrack_tpu")), (path, ln)
                    assert top not in {"tests", *jax_examples}, (path, ln)


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    # no card: exits non-zero and prints no result
    res = _run([str(REPO / "chip_smoke.py")], REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    # alone in a directory, without the package: fails as well
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
