"""Each traffic kind end to end on the CPU at a tiny size: set-up, the
window, the check against the reference and a result line of the
contract's shape; and, with the program broken underneath, ``correct``
comes out false for each fault the cell can have."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vobench_tiny import bench, run, tiny_cell

CELLS = [w["name"] for w in bench()["workloads"]]


def _shape(out: dict, cell) -> None:
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in cell.end_to_end}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    for name, v in out["checks"].items():
        assert name in cell.limits and v["limit"] == cell.limits[name]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_cpu_against_the_reference(name):
    cell = tiny_cell(name)
    out, lines = run(cell)
    _shape(out, cell)
    assert out["correct"], out["checks"]
    assert len(lines) == len(out["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_spans(name):
    cell = tiny_cell(name)
    out, _ = run(cell, trace=True)
    assert out["correct"]
    # the CPU has no device trace: only the span readers find something
    names = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) <= names
    assert any(n.endswith("_ms") for n in out["metrics"])


def _broken(monkeypatch, target: str, fn) -> None:
    mod_name, attr = target.rsplit(".", 1)
    mod = __import__(mod_name, fromlist=[attr])
    monkeypatch.setattr(mod, attr, fn(getattr(mod, attr)))


def _state_unchanged_tracker(orig):
    def track_pose_batch(pyr_ref, pyr_new, X, p0, cam, cfg, **kw):
        return p0.clone()
    return track_pose_batch


def _winner_altered(orig):
    def select_best(result, valid):
        score = torch.where(valid, result.mean_corr, torch.full_like(result.mean_corr, np.inf))
        b = torch.argmin(score)
        return b, result.mean_corr[b]
    return select_best


def _half_the_hypotheses(orig):
    def fit_camera_ransac(idx, *a, **kw):
        res = orig(idx, *a, **kw)
        half = res.valid.clone()
        half[: len(half) // 2] = False
        return res._replace(valid=half)
    return fit_camera_ransac


def _flow_altered(orig):
    def dense_flow_lk(*a, **kw):
        return orig(*a, **kw) * 1.01
    return dense_flow_lk


def _tracks_unchanged(orig):
    def advance_tracks(state, *a, **kw):
        return state
    return advance_tracks


def _pairs_moved(orig):
    def point_pairs(state, *a, **kw):
        pairs, valid = orig(state, *a, **kw)
        return pairs + 0.5, valid
    return point_pairs


def _half_the_image(orig):
    def dense_flow_lk(*a, **kw):
        flow = orig(*a, **kw)
        flow[: flow.shape[0] // 2] = 0.0
        return flow
    return dense_flow_lk


FAULTS = [
    ("invcomp-720p.reloc-s4096", "state unchanged",
     "invcompcamtrack_torch.solver.chain.track_pose_batch", _state_unchanged_tracker),
    ("invcomp-720p.reloc-s4096", "answer altered",
     "invcompcamtrack_torch.solver.chain.select_best", _winner_altered),
    ("invcomp-720p.reloc-s4096", "half the batch",
     "invcompcamtrack_torch.sfm.ransac.fit_camera_ransac", _half_the_hypotheses),
    ("invcomp-720p.pointtrack", "answer altered",
     "invcompcamtrack_torch.match.dense_flow.dense_flow_lk", _flow_altered),
    ("invcomp-720p.pointtrack", "state unchanged",
     "invcompcamtrack_torch.match.track.advance_tracks", _tracks_unchanged),
    ("invcomp-720p.pointtrack", "pairs moved",
     "invcompcamtrack_torch.match.track.point_pairs", _pairs_moved),
    ("invcomp-720p.pointtrack", "half the batch",
     "invcompcamtrack_torch.match.dense_flow.dense_flow_lk", _half_the_image),
]


@pytest.mark.parametrize("name,fault,target,fn", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _, _ in FAULTS])
def test_a_broken_program_is_not_correct(monkeypatch, name, fault, target, fn):
    _broken(monkeypatch, target, fn)
    # (long enough for two pairs: the track table pairs from its second)
    out, lines = run(tiny_cell(name), seconds=0.5)
    assert not out["correct"], (fault, out["checks"])
