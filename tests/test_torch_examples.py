"""The example twins ``examples/*_torch.py`` of the accuracy log, the
robustness sweep, the accuracy suite, the flow-EPE harness and the NCC
evaluation against the JAX examples they follow, on the CPU at small
sizes.

The JAX examples are loaded from their files with ``importlib`` (as
``bench.py::bench_noisymap_gain`` loads the accuracy log), with
``jaxcache.enable`` made a no-op while they load so that the worker does
not switch on JAX's persistent compilation cache.  The JAX engine is
compiled once in this module: the accuracy log's ``run_sequence`` in
``"structure"`` mode on the frames that both examples are handed.
"""

import dataclasses
import importlib.util
import os
import re
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.utils import jaxcache
from invcompcamtrack_tpu.vo import synthetic as jsynthetic
from invcompcamtrack_torch import ICGNParams
from invcompcamtrack_torch.vo import synthetic
import tests.torch_helpers  # noqa: F401  (one torch thread per process)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

# The accuracy log's row, the port vs the JAX example, on the first 12
# frames of bench.py::bench_noisymap_gain's path (path_sweep_local(80))
# over a 192x144 plane, "structure" mode, seed noise 0.25, the fixed-map
# overrides, tracker lv_f=2, maxiter=6.  Each limit is twice the JAX
# package's own float32-vs-float64 gap of that run (the JAX engine built
# with dtype float64, measured on the CPU): ate_rmse 7.6e-5,
# ate_rmse_unaligned 4.8e-4, final_drift 5.7e-4, rpe_trans 2.1e-4,
# rpe_rot_deg 4.3e-4, map_surface_rms 6.7e-4.  Measured, the port vs JAX
# float32: 7.7e-5, 4.5e-4, 5.3e-4, 2.1e-4, 4.9e-4 (degrees), 5.5e-4; the
# port lies within 1.2e-4 of JAX float64 on every one.
ROW_TOL = {"ate_rmse": 1.5e-4, "ate_rmse_unaligned": 1e-3, "final_drift": 1.2e-3,
           "rpe_trans": 4.2e-4, "rpe_rot_deg": 1e-3, "map_surface_rms": 1.4e-3}
SMALL_WH, SMALL_FC = (192, 144), (170.0, 172.0)
SMALL_FRAMES = 12
FIXEDMAP_OV = {"min_parallax_px": 1e9, "max_obs_fail": 10 ** 6, "reobs_gate_px": 48.0,
               "ba_obs_gate_px": 48.0, "ba_lm_eig_floor": 1e-4}
# The NCC evaluation's summaries (mean, median, 95th percentile of the
# endpoint errors, pixels), the port vs the JAX example's printed lines
# (three decimals).  Measured before rounding: 5.5e-8 px at most (the
# per-point errors within 2.0e-5 px); the limit is the printed rounding
# (5e-4) plus as much again.
NCC_TOL = 1e-3


def _load(name, with_examples_on_path=False):
    """Load examples/<name>.py as a module; the JAX examples' import-time
    ``jaxcache.enable()`` and JAX_COMPILATION_CACHE_DIR default are kept
    out of the worker."""
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaxcache, "enable", lambda *a, **k: None)
        if with_examples_on_path:
            mp.syspath_prepend(str(EXAMPLES))
        spec.loader.exec_module(mod)
    if env is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    return mod


@pytest.fixture(scope="module")
def examples():
    return {n: _load(n, with_examples_on_path=n.startswith("run_robustness"))
            for n in ("run_accuracy_log", "run_accuracy_log_torch", "run_robustness",
                      "run_robustness_torch", "run_accuracy_suite",
                      "run_accuracy_suite_torch", "run_flow_epe", "run_flow_epe_torch",
                      "run_ncc_eval", "run_ncc_eval_torch")}


# ---------------------------------------------------------------------------
# (a) the pieces that must equal the JAX examples'


@pytest.mark.parametrize("path", ["path_corridor_fwd", "path_corridor_turn", "path_plane_sweep",
                                  "path_bench_lateral", "path_sweep_local"])
def test_accuracy_log_paths_equal_the_jax_examples(examples, path):
    want = getattr(examples["run_accuracy_log"], path)(12)
    got = getattr(examples["run_accuracy_log_torch"], path)(12)
    assert got.shape == (12, 6)
    np.testing.assert_array_equal(got, want)


def test_accuracy_log_surface_rms_exp_and_centers(examples):
    jd, td = examples["run_accuracy_log"], examples["run_accuracy_log_torch"]
    rng = np.random.default_rng(4)
    for make in ("make_corridor", "make_scene"):
        kw = dict(wh=(160, 120), fc=(130.0, 131.0))
        jscene = getattr(jsynthetic, make)(np.random.default_rng(0), **kw)
        tscene = getattr(synthetic, make)(np.random.default_rng(0), **kw)
        X = rng.normal(size=(60, 3)) * 3 + np.r_[0.0, 0.0, 8.0]
        valid = rng.random(60) < 0.8
        assert td._surface_rms(tscene, X, valid) == jd._surface_rms(jscene, X, valid)
        assert td._surface_rms(tscene, torch.from_numpy(X), torch.from_numpy(valid)) == \
            jd._surface_rms(jscene, X, valid)
        assert np.isnan(td._surface_rms(tscene, X, np.zeros(60, bool)))
    poses = td.path_corridor_turn(12) + rng.normal(size=(12, 6)) * 0.1
    np.testing.assert_allclose(td._exp(poses[5]), jd._exp(poses[5]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(td._centers(poses), jd._centers(poses), rtol=0, atol=1e-12)


def test_robustness_levels_and_tracker_equal_the_jax_examples(examples):
    jr, tr = examples["run_robustness"], examples["run_robustness_torch"]
    assert tr.LEVELS == jr.LEVELS
    for pn in (False, True):
        assert dataclasses.asdict(tr._tracker(pn)) == dataclasses.asdict(jr._tracker(pn))
    assert tr._tracker(True).dopatchnorm


@pytest.mark.parametrize("profile", ["forward", "lateral", "handheld"])
def test_accuracy_suite_paths_equal_the_jax_suites(examples, profile):
    want = examples["run_accuracy_suite"].make_path(profile, 12, np.random.default_rng(3))
    got = examples["run_accuracy_suite_torch"].make_path(profile, 12, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)


def test_accuracy_suite_seed_is_stable(examples):
    """The twin's seed does not depend on the process (``hash(str)`` does)."""
    ts = examples["run_accuracy_suite_torch"]
    assert ts.profile_seed("forward") == zlib.crc32(b"forward")
    assert len({ts.profile_seed(p) for p in ("forward", "lateral", "handheld")}) == 3


# ---------------------------------------------------------------------------
# (c) the accuracy log's "off" mode


def _small_sequence(mod, synth):
    rng = np.random.default_rng(0)
    scene = synth.make_scene(rng, wh=SMALL_WH, fc=SMALL_FC, freq_range=(2.0, 20.0))
    path = mod.path_sweep_local(80)[:SMALL_FRAMES]
    return scene, path


def _sample(synth):
    return lambda s, r, n: synth.sample_plane_points(s, r, n, margin=24)


@pytest.fixture(scope="module", autouse=True)
def small_case(examples):
    """The JAX example's run_sequence on the small sequence, started in a
    thread with the module's first test (the JAX engine's compilation
    takes most of this module's time; the tests before the last one run
    beside it), and the frames that both examples are handed."""
    from invcompcamtrack_tpu.config import ICGNParams as JParams

    jd, td = examples["run_accuracy_log"], examples["run_accuracy_log_torch"]
    jscene, path = _small_sequence(jd, jsynthetic)
    tscene, _ = _small_sequence(td, synthetic)
    imgs = [synthetic.render(tscene, td._exp(p)).astype(np.float32) for p in path]
    with ThreadPoolExecutor(1) as ex:
        want = ex.submit(jd.run_sequence, "small", jscene, jsynthetic.render,
                         _sample(jsynthetic), path, "structure",
                         tracker=JParams(lv_f=2, lv_l=0, psz=8, maxiter=6), imgs=imgs,
                         seed_noise=0.25, cfg_overrides=FIXEDMAP_OV, chunk=10)
        yield want, (tscene, path, imgs)


def test_accuracy_log_off_mode_keeps_the_noisy_seeds(examples, small_case):
    """In "off" mode the port computes the window BA and drops its result:
    the fixed map stays the noisy seeds, so the row's map RMS is theirs."""
    td = examples["run_accuracy_log_torch"]
    _, (scene, path, imgs) = small_case
    n = 6
    row = td.run_sequence("small", scene, synthetic.render, _sample(synthetic), path[:n], "off",
                          imgs=imgs[:n], seed_noise=0.25, cfg_overrides=FIXEDMAP_OV,
                          tracker=ICGNParams(lv_f=2, lv_l=0, psz=8, maxiter=6), device="cpu")
    rng = np.random.default_rng(5)
    seeds = _sample(synthetic)(scene, rng, 400)
    seeds = (seeds + rng.normal(size=seeds.shape) * 0.25).astype(np.float32)
    assert row["landmarks_alive"] == 400
    assert row["map_surface_rms"] == td._surface_rms(scene, seeds, np.ones(400, bool))


# ---------------------------------------------------------------------------
# (d) the NCC evaluation


def test_ncc_eval_matches_the_jax_examples_lines(examples, capsys):
    examples["run_ncc_eval"].main()
    printed = capsys.readouterr().out.strip().splitlines()
    errs = examples["run_ncc_eval_torch"].ncc_eval("cpu")
    assert list(errs) == ["LK", "FFT-NCC", "MOSSE"] and len(printed) == 3
    for line, (label, err) in zip(printed, errs.items()):
        assert err.shape == (150,) and np.isfinite(err).all()
        want = [float(v) for v in re.findall(r"[-+]?\d+\.\d+", line)]
        assert line.split()[0] == label and len(want) == 3
        got = examples["run_ncc_eval_torch"].summary(err)
        assert max(abs(g - w) for g, w in zip(got, want)) <= NCC_TOL, (label, got, want)
    # the twin's own line format is the JAX example's
    assert examples["run_ncc_eval_torch"].epe_line("LK", errs["LK"]).split()[:3] == \
        printed[0].split()[:3]


# ---------------------------------------------------------------------------
# (e) the accuracy suite and the flow-EPE harness: runs and tables


def test_accuracy_suite_runs_small_and_writes_the_jax_suites_table(examples, tmp_path,
                                                                   monkeypatch, capsys):
    js, ts = examples["run_accuracy_suite"], examples["run_accuracy_suite_torch"]
    row = ts.run_sequence("forward", 6, False, wh=(96, 72), fc=(75.0, 90.0), device="cpu")
    assert row["frames"] == 6 and np.isfinite(row["ate_rmse"]) and row["ate_rmse"] < 0.05
    rows = [dict(row, profile=p, init="self (2-view)" if si else "GT 2-frame",
                 ate_rmse=row["ate_rmse"] * (k + 1))
            for k, (p, si) in enumerate(ts.PROFILES)]
    it = iter(rows)
    monkeypatch.setattr(js, "run_sequence", lambda *a, **k: next(it))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["run_accuracy_suite.py", "--frames", "6",
                                      "--out", "jax.md"])
    js.main()
    capsys.readouterr()
    want = [ln for ln in (tmp_path / "jax.md").read_text().splitlines() if ln.startswith("|")]
    assert ts.table_lines(rows) == want


def test_flow_epe_runs_small_and_writes_the_jax_examples_table(examples, tmp_path, monkeypatch,
                                                              capsys):
    import invcompcamtrack_tpu.match.flow_bench as jbench

    jf, tf = examples["run_flow_epe"], examples["run_flow_epe_torch"]
    agg, rows = tf.flow_epe(1, "cpu", wh=(96, 72))
    assert set(agg) == {"lk", "ncc", "mosse"} and len(rows) == 1
    assert all(np.isfinite(v) for m in agg.values() for v in m.values())
    monkeypatch.setattr(jbench, "run_benchmark", lambda rng, n_pairs: (agg, rows))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["run_flow_epe.py", "--pairs", "1", "--out", "jax.md"])
    jf.main()
    printed = capsys.readouterr().out.strip().splitlines()
    assert tf.summary_lines(agg) == printed[:3]
    want = [ln for ln in (tmp_path / "jax.md").read_text().splitlines() if ln.startswith("|")]
    assert tf.table_lines(agg) == want


# ---------------------------------------------------------------------------
# (f) entry points run on the card


@pytest.mark.parametrize("name,argv", [
    ("run_accuracy_log_torch", ["--quick", "--only", "corridor-selfinit"]),
    ("run_robustness_torch", ["--frames", "4"]),
    ("run_accuracy_suite_torch", ["--frames", "4"]),
    ("run_flow_epe_torch", ["--pairs", "1"]),
    ("run_ncc_eval_torch", []),
])
def test_twin_main_defaults_to_the_card(examples, name, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        examples[name].main(argv)
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# (b) the accuracy log's row against the JAX example's


def test_accuracy_log_row_matches_the_jax_example(examples, small_case):
    """The module's last test: the JAX example's row comes from its thread."""
    future, (scene, path, imgs) = small_case
    got = examples["run_accuracy_log_torch"].run_sequence(
        "small", scene, synthetic.render, _sample(synthetic), path, "structure",
        tracker=ICGNParams(lv_f=2, lv_l=0, psz=8, maxiter=6), imgs=imgs, seed_noise=0.25,
        cfg_overrides=FIXEDMAP_OV, chunk=10, device="cpu", keep_poses=True)
    want = future.result()
    assert got.keys() - {"poses"} == want.keys()
    for k in ("sequence", "ba_mode", "frames", "image", "path_len", "self_init", "fps_method"):
        assert got[k] == want[k], k
    assert got["landmarks_alive"] == want["landmarks_alive"]
    for k, tol in ROW_TOL.items():
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    assert got["poses"].shape == (SMALL_FRAMES, 6)
    # the chunk loop ran: one 10-frame chunk timed
    assert np.isfinite(got["fps_engine"]) and got["fps_engine"] > 0
