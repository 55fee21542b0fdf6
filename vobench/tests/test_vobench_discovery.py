"""A later change adds a configuration, a cell and a per-layer metric as
files of their own: the harness finds them by the names in
BENCHMARK.json, and no file that was there is edited."""

from __future__ import annotations

import hashlib
import json
import shutil

from vobench_tiny import ROOT, TINY


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    from vobench import drive, harness

    shutil.copytree(ROOT / "vobench", tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path / "vobench")
    vb = tmp_path / "vobench"

    # a configuration: the plane camera at 640x480
    cfg = json.loads((vb / "configs" / "invcomp-720p.json").read_text())
    cfg.update(name="plane-vga", camera={"wh": [160, 120], "fc": [125.0, 150.0],
                                          "cc": [81.5, 58.0]})
    cfg["pointtrack"] = dict(cfg["pointtrack"], levels=3, corners=100)
    (vb / "configs" / "plane-vga.json").write_text(json.dumps(cfg))
    # a cell on it, with its own traffic mix
    spec = json.loads((vb / "workloads" / "invcomp-720p.pointtrack.json").read_text())
    spec.update(name="plane-vga.pointtrack-short", config="plane-vga",
                traffic="pointtrack-short", params=dict(spec["params"], **TINY["pointtrack"][1]))
    (vb / "workloads" / "plane-vga.pointtrack-short.json").write_text(json.dumps(spec))
    # a per-layer metric that reads the corners' span
    (vb / "metrics" / "flow.tracks_ms.py").write_text(
        '"""The median span of the corners and the track table."""\n'
        'from statistics import median\n'
        'LAYER = "match/features, match/track"\nUNIT = "ms"\nMOVES = "flow_pairs_per_s"\n\n\n'
        'def read(run):\n    s = run.trace.spans.get("tracks")\n'
        '    return 1e3 * median(s) if s else None\n')
    bench["configs"].append({"name": "plane-vga", "source": "a test", "file":
                             "vobench/configs/plane-vga.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "plane-vga.pointtrack-short", "config": "plane-vga",
                               "traffic": "pointtrack-short", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "invcomp-720p.pointtrack" in m["workloads"]:
            m["workloads"].append("plane-vga.pointtrack-short")
    bench["per_layer"].append({"name": "flow.tracks_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "match/features, match/track",
                               "moves": "flow_pairs_per_s",
                               "workloads": ["plane-vga.pointtrack-short"]})

    after = _digests(vb)
    assert all(after[p] == d for p, d in before.items())

    cell = harness.Cell(bench, "plane-vga.pointtrack-short", root=vb)
    assert cell.config["name"] == "plane-vga"
    assert "flow.tracks_ms" in cell.readers(root=vb)
    cell.readers = lambda: harness.Cell.readers(cell, root=vb)
    import time

    line, _ = drive.run_cell(cell, 3, 0.3, True, "cpu", time.perf_counter())
    out = json.loads(line)
    assert out["correct"] and "flow.tracks_ms" in out["metrics"]
