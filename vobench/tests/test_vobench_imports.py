"""No module that the harness or the reference loads is JAX or the JAX
package, compared by the whole top-level name; the reference loads
nothing of the program either."""

from __future__ import annotations

import json
import subprocess
import sys

from vobench_tiny import ROOT

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {tests!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set:
    code = PROBE.format(root=str(ROOT), tests=str(ROOT / "vobench" / "tests"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_kind_loads_no_jax():
    body = ("import vobench.run, vobench.calibrate\n"
            "from vobench_tiny import bench, run, tiny_cell\n"
            "for w in bench()['workloads']:\n"
            "    run(tiny_cell(w['name']), seconds=0.2)\n")
    found = _top_level(body)
    assert "invcompcamtrack_torch" in found
    assert not found & {"jax", "jaxlib", "flax", "invcompcamtrack_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    body = "import vobench.reference.reloc, vobench.reference.pointtrack\n"
    found = _top_level(body)
    assert not found & {"jax", "jaxlib", "flax", "invcompcamtrack_tpu", "invcompcamtrack_torch"}
