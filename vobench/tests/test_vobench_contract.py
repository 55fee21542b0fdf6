"""BENCHMARK.json against the benchmark's contract: its keys, names,
units and bounds, each cell's and metric's files found by name, and the
budget of a full check."""

from __future__ import annotations

import json
import re

import pytest

from vobench_tiny import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")

B = bench()


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(B["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                              for p in B["paths"])
    assert 1 <= len(B["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w for w in B["command"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in B[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((key, entry["name"]))
    for key in ("configs", "workloads"):
        assert len({n for k, n in names if k == key}) == len(B[key])
    metrics = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
    for c in B["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_entries_have_just_the_contract_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in B["end_to_end"])


def test_roofline_names():
    for m in B["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_each_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    cells = {w["name"] for w in B["workloads"]}
    for m in B["end_to_end"] + B["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        e2e = [m["name"] for m in B["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in B["per_layer"] if cell in m.get("workloads", cells)]
        assert layer
        # the metric each per-layer metric moves is reported in its cells
        for m in layer:
            assert m["moves"] in e2e


def test_configs_are_used_and_their_files_lie_under_paths():
    used = {w["config"] for w in B["workloads"]}
    files = [c["file"] for c in B["configs"]]
    assert len(set(files)) == len(files)
    for c in B["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_each_cell_has_its_files(cell):
    spec = json.loads((ROOT / "vobench" / "workloads" / f"{cell}.json").read_text())
    assert (ROOT / "vobench" / "traffic" / f"{spec['kind']}.py").is_file()
    assert set(spec["limits"]) and all(v >= 0 for v in spec["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_each_per_layer_metric_has_its_reader(metric):
    from vobench import harness

    entry = next(m for m in B["per_layer"] if m["name"] == metric)
    mod = harness.load_module(ROOT / "vobench" / "metrics" / f"{metric}.py", "m")
    assert (mod.UNIT, mod.MOVES, mod.LAYER) == (entry["unit"], entry["moves"], entry["layer"])
    assert callable(mod.read)


def test_a_full_check_fits_the_budget_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)


def test_the_profiled_window_and_its_union():
    from vobench.harness import summarise

    spin = "spin_kernel"
    events = [(0, 10, spin), (20, 21, spin),            # pads, then the opener
              (30, 40, "a"), (35, 50, "b"), (70, 80, "a"),
              (100, 101, spin), (102, 103, spin)]       # the closer, pads
    prof = summarise(events, 2)
    assert prof["window_s"] == (100 - 21) * 1e-9
    assert prof["busy_s"] == (20 + 10) * 1e-9
    assert prof["ops"] == 3 and prof["by_name"]["a"] == (2, 20e-9)
    assert [g[0] for g in prof["idle_gaps"]] == ["before a", "the units' end", "before a"]
    assert summarise(events[:5], 2) is None
