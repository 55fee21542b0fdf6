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
    ``VisualOdometry`` and ``VisualOdometryBatch`` among them); and no source
    line of the port or of chip_smoke.py names either in an import."""
    code = ("import importlib, pkgutil, sys\n"
            "import invcompcamtrack_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "from invcompcamtrack_torch.vo.engine import VisualOdometry, VisualOdometryBatch\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'invcompcamtrack_tpu'))\n"
            "slice4 = {'ba.window', 'sfm.triangulate', 'sfm.epipolar', 'sfm.twoview',\n"
            "          'vo.engine', 'vo.metrics', 'vo.datasets', 'utils.metrics'}\n"
            "assert slice4 <= {n.split('.', 1)[1] for n in names}, names\n"
            "print(len(names), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = _run(["-c", code], REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert bad == "[]"
    # the walk saw the package: every slice's modules are among them
    assert int(count) >= 52, res.stdout
    sources = [*sorted((REPO / "invcompcamtrack_torch").rglob("*.py")), REPO / "chip_smoke.py"]
    for path in sources:
        for ln in path.read_text().splitlines():
            words = ln.split("#")[0].split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("jax", "invcompcamtrack_tpu")), (path, ln)


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
