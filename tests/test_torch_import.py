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
    code = ("import sys\n"
            "import invcompcamtrack_torch, invcompcamtrack_torch.convert\n"
            "import invcompcamtrack_torch.solver.icgn, invcompcamtrack_torch.ops._build\n"
            "import invcompcamtrack_torch.ops.patch_gather, invcompcamtrack_torch.ops.icgn_iter\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = _run(["-c", code], REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "[]"


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
