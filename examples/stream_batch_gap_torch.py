#!/usr/bin/env python3
"""Find the operations whose result for one stream of the multi-stream VO
engine depends on the streams beside it.

    python3 examples/stream_batch_gap_torch.py [--frames 8] [--check 0 1] [--device cuda]
    python3 examples/stream_batch_gap_torch.py --small --device cpu

Builds the workload of ``chip_smoke.py``'s phase 7 (S = 4 streams of
1280x720 on the scene from rng 1, stream s on the pose path from
``default_rng(10 + s)``, 400 seeds, 512 landmarks, a 5-keyframe window;
``--small``: 320x192, 100 seeds, 128 landmarks, 3 levels), bootstraps one
engine per stream and runs each alone.  Before each of the first
``--frames`` frames it stacks the S engines' states into one batch and
runs that frame's step on the batch and on each stream alone, every
operation recorded through a ``TorchDispatchMode``: operation i of the
batch is paired with operation i of each stream's own step, and its
inputs and outputs are cut along the stream axis (the one axis whose
size is S times the single step's) and compared bit for bit.  An
operation whose inputs agree and whose outputs do not is an *origin*:
its result depends on how many streams share the call.  An input that
differs before any output has is reported too (the port's kernels run
outside the dispatcher).

Each operation of the batch is also run again on stream s's cut of its
inputs and held to the cut of its result: a *variant* call, where they
differ, is seen also behind an earlier origin (where the streams'
inputs have already parted).

Prints, per frame and stream, the pose gap and the first origin, then
every origin and every variant call by operation and call site; writes
the whole to ``build/stream_batch_gap.json`` (or ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from invcompcamtrack_torch import ICGNParams, synthetic  # noqa: E402
from invcompcamtrack_torch.core import lie  # noqa: E402
from invcompcamtrack_torch.core.camera import CameraPyramid  # noqa: E402
from invcompcamtrack_torch.vo import engine  # noqa: E402

STREAMS = 4                     # chip_smoke.py's ENGINE_STREAMS
# outputs of these hold whatever memory they were given
_UNINIT = ("empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like")
# views, aliases and copies compute nothing, and one-element arguments
# draw extra ones (a detach in torch.where, a copy before a bmm) that a
# batch's do not: none is recorded
_SKIP = ("detach", "alias", "lift_fresh", "view", "_unsafe_view", "select", "slice",
         "unsqueeze", "squeeze", "expand", "permute", "transpose", "t", "as_strided",
         "unbind", "split", "split_with_sizes", "narrow", "diagonal", "unfold",
         "clone", "_reshape_alias")


def workload(S, small, n_frames):
    """chip_smoke.py::streams_workload's draws (the full path of 65 steps
    and then the seeds from each stream's generator), rendering only the
    first n_frames frames."""
    wh, fc, n_seeds = ((320, 192), (250.0, 300.0), 100) if small else \
        ((1280, 720), (1000.0, 1200.0), 400)
    rng = np.random.default_rng(1)
    scene = synthetic.make_scene(rng, wh=wh, fc=fc, z0=8.0, freq_range=(0.5, 6.0))
    poses, seeds = [], []
    for s in range(S):
        rr = np.random.default_rng(10 + s)
        path = [np.zeros(6)]
        for i in range(1, 66):
            path.append(path[-1] + np.r_[0.02, 0.01 * np.sin(i * 0.3), 0.01,
                                         rr.normal(size=3) * 0.001])
        seeds.append(synthetic.sample_plane_points(scene, rr, n_seeds, margin=24))
        poses.append(np.stack(path[:n_frames]))
    frames = np.stack([[synthetic.render(scene, lie.se3_exp(
        torch.tensor(p, dtype=torch.float64)).numpy()).astype(np.float32) for p in path]
        for path in poses])
    return scene, np.stack(poses), frames, seeds


def _name(func) -> str:
    return str(func.overloadpacket.__name__)


def _tensors(tree):
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


def _in_transform() -> bool:
    """Inside torch.func's vmap / jacfwd, whose wrapped tensors are not
    compared here (their results are, where they come out)."""
    f = sys._getframe(1)
    while f is not None:
        if "_functorch" in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


def _snap(ts):
    return [t.detach().clone() for t in ts]


class Recorder(TorchDispatchMode):
    """Each operation's name, inputs (before it runs) and outputs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _name(func) in _SKIP or _in_transform():
            return func(*args, **kwargs)
        raw = _tensors((args, kwargs))
        ins = _snap(raw)
        out = func(*args, **kwargs)
        outs = [] if _name(func) in _UNINIT else _snap(_tensors(out))
        self.ops.append((_name(func), ins, outs, out if not _tensors(out) else None,
                         [t.stride() for t in raw]))
        return out


def _replace_tensors(tree, new):
    """tree with its tensors, in _tensors' order, replaced by ``new``."""
    it = iter(new)

    def walk(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        if isinstance(x, list):
            return [walk(y) for y in x]
        if isinstance(x, tuple):
            return tuple(walk(y) for y in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x
    return walk(tree)


def _laid_out(t, stride):
    """A copy of t with the given strides (the single step's operand had
    them; a product's summation path can follow the layout)."""
    try:
        return torch.empty_strided(t.shape, stride, dtype=t.dtype, device=t.device).copy_(t)
    except RuntimeError:    # a broadcast (stride 0) operand
        return t.clone()


def _cut(t4, t1, s, S):
    """Stream s of a batch tensor t4, shaped as the single step's t1, or
    None where no axis is S times the single one."""
    if t4.shape == t1.shape:
        return t4
    if t4.dim() != t1.dim():
        return None
    dims = [d for d in range(t4.dim()) if t4.shape[d] != t1.shape[d]]
    if len(dims) != 1 or t4.shape[dims[0]] != S * t1.shape[dims[0]]:
        return None
    d = dims[0]
    return t4.narrow(d, s * t1.shape[d], t1.shape[d])


def _gap(a, b):
    """None if equal bit for bit (NaN equal to NaN), else the largest
    difference (inf where a NaN or a bool/int differs)."""
    if a.dtype != b.dtype:
        return float("inf")
    if a.dtype.is_floating_point:
        both_nan = torch.isnan(a) & torch.isnan(b)
        ne = (a != b) & ~both_nan
        if not bool(ne.any()):
            return None
        d = (a.double() - b.double()).abs()[ne]
        d = d[torch.isfinite(d)]
        return float(d.max()) if d.numel() else float("inf")
    return None if torch.equal(a, b) else float("inf")


def _site():
    fr = [f for f in traceback.extract_stack()
          if "invcompcamtrack_torch" in f.filename and "_python_dispatch" not in f.filename]
    return " < ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} ({f.name})"
                      for f in reversed(fr[-3:]))


class Comparer(TorchDispatchMode):
    """Operation i of a batch of S streams against operation i of stream
    s's own step (``singles[s]``, a Recorder's list)."""

    def __init__(self, singles, S):
        super().__init__()
        self.singles = singles
        self.S = S
        self.i = 0
        self.aligned = True
        self.misaligned_at = None
        self.origins = []               # (op index, stream, name, gap, site, shapes)
        self.variants = []              # the same, for _variant
        self.first_input_gap = [None] * self.S
        self.first_output_gap = [None] * self.S
        self.uncut = defaultdict(int)

    def _compare(self, batch_ts, single_ts, s, name, floats_only=False):
        worst, cut_all = None, True
        for t4, t1 in zip(batch_ts, single_ts):
            if floats_only and not t1.dtype.is_floating_point:
                continue
            c = _cut(t4, t1, s, self.S)
            if c is None:
                cut_all = False
                self.uncut[name] += 1
                continue
            g = _gap(c, t1)
            if g is not None:
                worst = g if worst is None else max(worst, g)
        return worst, cut_all

    def _variant(self, func, args, kwargs, ins, r_ins, r_strides, outs, r_outs, s):
        """The operation run again on stream s's cut of its inputs, against
        the cut of the batch's result: the gap, None where they agree or
        where the call cannot be cut (this sees every operation, also
        those behind an earlier origin)."""
        if not ins or not outs:
            return None
        cuts = [_cut(t4, t1, s, self.S) for t4, t1 in zip(ins, r_ins)]
        if any(c is None for c in cuts) or all(c is t4 for c, t4 in zip(cuts, ins)):
            return None
        # an integer operand that is not the single step's is an index
        # into the batch (point m of S * N): on one stream's cut it would
        # reach past the end, which on the card is a device-side assert
        if any(not t1.dtype.is_floating_point and _gap(c, t1) is not None
               for c, t1 in zip(cuts, r_ins)):
            return None
        a_s, k_s = _replace_tensors((args, kwargs),
                                    [_laid_out(c, st) for c, st in zip(cuts, r_strides)])
        try:
            out_s = _tensors(func(*a_s, **k_s))
        except Exception:       # sizes given as numbers: the batch's
            return None
        worst = None
        for o4, o1, r1 in zip(outs, out_s, r_outs):
            c = _cut(o4, r1, s, self.S) if o1.shape == r1.shape else None
            if c is None:
                return None
            g = _gap(c, o1)
            if g is not None:
                worst = g if worst is None else max(worst, g)
        return worst

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        if name in _SKIP or _in_transform():
            return func(*args, **kwargs)
        i = self.i
        self.i += 1
        if not self.aligned or any(i >= len(r) or r[i][0] != name
                                   for r in self.singles.values()):
            if self.aligned:
                self.aligned = False
                self.misaligned_at = (i, name, [r[i][0] if i < len(r) else None
                                                for r in self.singles.values()], _site())
            return func(*args, **kwargs)
        ins = _snap(_tensors((args, kwargs)))
        out = func(*args, **kwargs)
        if name in _UNINIT:
            return out
        outs = _tensors(out)
        for s, rec in self.singles.items():
            _, r_ins, r_outs, r_scalar, r_strides = rec[i]
            g_in, _ = self._compare(ins, r_ins, s, name)
            g_in_f, _ = self._compare(ins, r_ins, s, name, floats_only=True)
            if outs:
                g_out, _ = self._compare(outs, r_outs, s, name)
            else:  # a Python scalar (item, is_nonzero)
                g_out = None if out == r_scalar else float("inf")
            if g_in_f is not None and self.first_input_gap[s] is None:
                self.first_input_gap[s] = (i, name, g_in_f, _site())
            if g_out is not None and self.first_output_gap[s] is None and outs \
                    and outs[0].dtype.is_floating_point:
                self.first_output_gap[s] = (i, name, g_out, _site())
            # (an index made from nothing, arange(S * N), counts the
            # streams' points apart: a different number, not an origin)
            index_gen = not ins and outs and not outs[0].dtype.is_floating_point
            if g_in is None and g_out is not None and not index_gen:
                self.origins.append((i, s, name, g_out, _site(),
                                     [list(t.shape) for t in ins]))
            g_var = self._variant(func, args, kwargs, ins, r_ins, r_strides, outs, r_outs, s)
            if g_var is not None:
                self.variants.append((i, s, name, g_var, _site(),
                                      [list(t.shape) for t in ins]))
        return out


def clone_state(st):
    return engine._map_state(lambda a, d: a.clone(), st)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8, help="frames 2.. to probe")
    ap.add_argument("--check", type=int, nargs="*", default=None,
                    help="the streams to hold to their own steps (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="320x192, 3 levels (CPU)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "stream_batch_gap.json"))
    a = ap.parse_args()
    dev = torch.device(a.device)
    S, F = STREAMS, a.frames
    t0 = time.perf_counter()
    scene, poses, frames, seeds = workload(S, a.small, F + 2)
    if a.small:
        tracker = ICGNParams(lv_f=2, lv_l=0, psz=8, maxiter=10)
        cfg = engine.VOConfig(tracker=tracker, max_landmarks=128, window=4, keyframe_stride=2,
                              corners_per_kf=128, min_parallax_px=1.0)
    else:
        tracker = ICGNParams(lv_f=4, lv_l=0, psz=8, maxiter=10)
        cfg = engine.VOConfig(tracker=tracker, max_landmarks=512, window=5, keyframe_stride=2,
                              corners_per_kf=512, min_parallax_px=1.0)
    cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, tracker.num_levels, tracker.psz,
                               device=dev)
    engines = []
    for s in range(S):
        vo = engine.VisualOdometry(cam, scene.fc, scene.cc, cfg, device=dev)
        vo.bootstrap(frames[s, 0], frames[s, 1], poses[s, 0], poses[s, 1], seeds[s])
        engines.append(vo)
    imgs = torch.from_numpy(frames).to(dev)
    states = [e.states for e in engines]
    report = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "streams": S, "small": a.small, "frames": []}
    def tally():
        return defaultdict(lambda: {"count": 0, "max_gap": 0.0, "frames": set(),
                                    "streams": set()})
    by_site, var_by_site = tally(), tally()
    check = range(S) if a.check is None else a.check
    for f in range(2, F + 2):
        step = engine._keyframe_step if f % cfg.keyframe_stride == 0 else engine._track_step
        img_b = imgs[:, f].contiguous()
        pre = [clone_state(st) for st in states]
        row = {"frame": f, "kind": "keyframe" if step is engine._keyframe_step else "track",
               "streams": {}}
        # one stream at a time: the recorded operations of one step fill
        # gigabytes at full size
        for s in check:
            img_s = imgs[s, f][None]
            batch = engine.stack_states(pre)     # copies
            single = clone_state(pre[s])
            rec = Recorder()
            with rec:
                st, p1 = step(single, img_s, cam, cfg)
            cmp = Comparer({s: rec.ops}, S)
            with cmp:
                _, pS = step(batch, img_b, cam, cfg)
            gap = float((pS[s] - p1[0]).abs().max())
            states[s] = st
            row["streams"][s] = {
                "ops": cmp.i, "aligned": cmp.aligned, "misaligned_at": cmp.misaligned_at,
                "pose_gap": gap, "first_input_gap": cmp.first_input_gap[s],
                "first_output_gap": cmp.first_output_gap[s], "origins": len(cmp.origins),
                "uncut": dict(cmp.uncut)}
            row["streams"][s]["variants"] = len(cmp.variants)
            for found, table in ((cmp.origins, by_site), (cmp.variants, var_by_site)):
                for i, s_, name, g, site, shapes in found:
                    e = table[(name, site)]
                    e["count"] += 1
                    e["max_gap"] = max(e["max_gap"], g)
                    e["frames"].add(f)
                    e["streams"].add(s_)
                    e.setdefault("shapes", shapes)
            print(f"frame {f} ({row['kind']}), stream {s}: {cmp.i} ops, aligned "
                  f"{cmp.aligned}, pose gap {gap:.1e}, {len(cmp.origins)} origins, "
                  f"{len(cmp.variants)} variant calls", flush=True)
            if cmp.misaligned_at is not None:
                print(f"  the op sequences part at {cmp.misaligned_at}")
            if cmp.origins:
                o = cmp.origins[0]
                print(f"  first origin op {o[0]} {o[2]} gap {o[3]:.2e} at {o[4]}")
            fi = cmp.first_input_gap[s]
            if fi is not None and (not cmp.origins or fi[0] < cmp.origins[0][0]):
                print(f"  an input differs first, op {fi[0]} {fi[1]} gap {fi[2]:.2e} at {fi[3]}")
            del rec, cmp, batch
        for s in set(range(S)) - set(check):
            states[s], _ = step(states[s], imgs[s, f][None], cam, cfg)
        report["frames"].append(row)
    def listing(table):
        return sorted(({"op": k[0], "site": k[1], "count": v["count"], "max_gap": v["max_gap"],
                        "frames": sorted(v["frames"]), "streams": sorted(v["streams"]),
                        "input_shapes": v["shapes"]} for k, v in table.items()),
                      key=lambda e: -e["count"])
    sites, var_sites = listing(by_site), listing(var_by_site)
    report["origins_by_site"] = sites
    report["variants_by_site"] = var_sites
    report["seconds"] = time.perf_counter() - t0
    for what, lst in (("origins", sites), ("batch-variant calls (each operation run "
                                           "again on one stream's inputs)", var_sites)):
        print(f"{what} by operation and call site ({len(lst)}):")
        for e in lst:
            print(f"  {e['count']:6d} x {e['op']} (max gap {e['max_gap']:.2e}, frames "
                  f"{e['frames']}, streams {e['streams']}, inputs {e['input_shapes']}) at "
                  f"{e['site']}")
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    print(json.dumps({"stream_batch_gap": {"device": report["device"],
                                           "origins": sum(e["count"] for e in sites),
                                           "sites": len(sites),
                                           "variant_calls": sum(e["count"] for e in var_sites),
                                           "variant_sites": len(var_sites),
                                           "seconds": report["seconds"]}}))


if __name__ == "__main__":
    main()
