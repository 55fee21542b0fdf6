"""The C interface of the port's CUDA kernels against the table that
``ops/_build.py`` declares to ctypes, and the K1, K4, K5, K6 and K9
wrappers' calls into it.

A stale entry in ``_build._SIGNATURES`` makes ctypes pass a truncated
pointer or a wrong integer, and only a run on the card would show it.  So
every ``extern "C" int icgn_...(...)`` of ``csrc/*.cu`` is parsed here and
held to the table: the same names, the same number of arguments, each
pointer (``void*`` included) declared ``c_void_p`` and each ``int``
``c_int``.  Then the wrappers of the kernels that take the centres (K1,
K4, K5, K6, K9) run their card path on CPU tensors against a stand-in
library that records the call: what they pass, and that they prepare no
indices or weights (on the card such a call is one device op); K1, K5,
K6, K7 and K9 also on a stack of P planes, the multi-stream engine's
call, which passes P and the stack's pointer.  K7 passes the window
origins as they are (the kernel clamps them), and the clamping rule it
repeats is held to the plain path's at origins beyond every border.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from invcompcamtrack_torch.image import taps
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.ops import _build, ncc3, patch_gather, patch_prefetch

torch.set_num_threads(1)

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(icgn_\w+)\s*\(([^)]*)\)')


def _entry_points() -> dict:
    """name -> its declared arguments, e.g. ``["const float* img", "int Hp"]``."""
    found = {}
    for path in _build.sources():
        for name, args in _ENTRY.findall(path.read_text()):
            found[name] = [" ".join(a.split()) for a in args.split(",") if a.strip()]
    return found


ENTRIES = _entry_points()


def test_sources_define_the_kernels_entry_points():
    assert len(ENTRIES) >= 9, sorted(ENTRIES)
    # icgn_error_string returns a const char* and is declared in load()
    assert "icgn_error_string" not in ENTRIES


@pytest.mark.parametrize("name", sorted(set(ENTRIES) | set(_build._SIGNATURES)))
def test_signature_table_matches_the_source(name):
    assert name in ENTRIES, f"_SIGNATURES declares {name}, which no csrc/*.cu defines"
    assert name in _build._SIGNATURES, f"csrc defines {name}, which _SIGNATURES lacks"
    args, types = ENTRIES[name], _build._SIGNATURES[name]
    assert len(types) == len(args), f"{name}: {len(types)} types for {args}"
    for arg, ctype in zip(args, types):
        if "*" in arg:
            assert ctype is ctypes.c_void_p, f"{name}: {arg} is a pointer"
        else:
            assert arg.rsplit(" ", 1)[0] == "int", f"{name}: {arg} is neither int nor pointer"
            assert ctype is ctypes.c_int, f"{name}: {arg} is an int"


class _Recorder:
    """Stands in for the kernels' library: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _no_prep(*_args, **_kw):
    raise AssertionError("the wrapper prepared indices or weights in torch")


def _forbid_prep(monkeypatch):
    """Make the plain versions' index helpers raise: the support starts
    and weights (``bilinear_base``) and the clamping of supports and
    windows into the plane (``image/taps.py::clamp_to_fit``)."""
    monkeypatch.setattr(patch_gather, "bilinear_base", _no_prep)
    monkeypatch.setattr(taps, "clamp_to_fit", _no_prep)


def _host_ops(fn):
    """fn's result and the names of the torch ops it ran."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


# what a wrapper may run besides its launch: allocation and views
_ALLOC = {"aten::empty", "aten::empty_like", "aten::empty_strided"}
_VIEWS = {"aten::view", "aten::reshape", "aten::_reshape_alias", "aten::alias",
          "aten::as_strided"}


# kernel -> (module, launch count key, C entry point)
_CENTRE_KERNELS = {
    "gather_patches": (patch_gather, "gather_patches", "icgn_gather_patches"),
    "gather_patches_grad": (patch_gather, "gather_patches_grad", "icgn_gather_patches_grad"),
    "gather_ref_grad_windows": (patch_gather, "gather_ref_grad_windows",
                                "icgn_gather_ref_grad_windows"),
    "gather_ref_grad_windows_prefetch": (patch_prefetch, "gather_ref_grad_windows_prefetch",
                                         "icgn_gather_prefetch"),
    "ncc3_scores": (ncc3, "ncc3_scores", "icgn_ncc3_scores"),
}


@pytest.mark.parametrize("kernel", list(_CENTRE_KERNELS))
def test_k5_k6_wrappers_pass_centres_and_nothing_else(monkeypatch, kernel):
    """K5, K6 and the kernels that took their indices from torch before
    (K1, K9, K4): one entry call, the centres (and K1's and K9's window
    origins) passed as they are, nothing computed in torch before it."""
    _drive_card_path(monkeypatch, kernel, stacked=False)


@pytest.mark.parametrize("kernel", [k for k in _CENTRE_KERNELS if k != "ncc3_scores"])
def test_gather_wrappers_pass_a_plane_stack(monkeypatch, kernel):
    """K1, K5, K6 and K9 on a stack of P = 3 planes with centres (P, 7, 2)
    (the multi-stream engine's call): one entry call with P, the stack's
    pointer and the centres as they are, nothing computed before it."""
    _drive_card_path(monkeypatch, kernel, stacked=True)


def _drive_card_path(monkeypatch, kernel, stacked):
    lib = _Recorder()
    mod, key, entry_name = _CENTRE_KERNELS[kernel]
    monkeypatch.setattr(patch_gather, "on_card", lambda name, t: True)
    monkeypatch.setattr(ncc3, "on_card", lambda name, t: True)
    _forbid_prep(monkeypatch)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 1234)
    counts = {m: dict.fromkeys(m.launches, 0) for m in (patch_gather, patch_prefetch, ncc3)}
    for m, c in counts.items():
        monkeypatch.setattr(m, "launches", c)
    rng = np.random.default_rng(16)
    psz = 8 if kernel.startswith("gather_ref") else 6
    pad = psz
    lvls = [build_pyramid(torch.tensor(rng.uniform(0, 255, (40, 56)).astype(np.float32)),
                          1, pad)[0] for _ in range(3)]
    lvl = lvls[0]
    if stacked:
        lvl, q_img = (type(lvl)(*(torch.stack([lv[k] for lv in lvls]) for k in range(3))),
                      torch.stack([lv.img for lv in lvls[::-1]]))
    else:
        q_img = lvls[1].img
    centers = torch.tensor(rng.uniform(0, 50, (3, 7, 2)).astype(np.float32))
    origins = torch.tensor(rng.integers(-3, 50, (3, 7, 2)).astype(np.int32))
    uvs = (centers + 0.5, centers, centers - 0.25)
    if kernel == "gather_patches":
        args = (lvl.img, centers, psz, pad)
    elif kernel == "gather_patches_grad":
        args = (lvl.img, lvl.dx, lvl.dy, centers, psz, pad)
    elif kernel == "ncc3_scores":
        args = (*(lv.img for lv in lvls), *uvs, psz, pad)
    else:
        args = (lvl, q_img, centers, origins, psz, pad, 16)

    def ops_of(patch_norm):
        kw = {} if kernel == "ncc3_scores" else {"patch_norm": patch_norm}
        return _host_ops(lambda: getattr(mod, kernel)(*args, **kw))

    out, ran = ops_of(False)
    # what ran besides the call: allocation and views, no arithmetic
    assert "aten::empty" in ran
    views = _VIEWS | ({"aten::select"} if kernel == "ncc3_scores" else set())
    assert ran <= _ALLOC | views, ran
    (entry, args_c), = lib.calls
    assert entry == entry_name
    assert len(args_c) == len(_build._SIGNATURES[entry])
    for a, ctype in zip(args_c, _build._SIGNATURES[entry]):
        ctype(a)                                    # each converts as declared
    M = centers.shape[0] * centers.shape[1]
    Hp, Wp = lvl.img.shape[-2:]
    P = 3 if stacked else 1
    if kernel == "ncc3_scores":
        assert args_c[:5] == (*(lv.img.data_ptr() for lv in lvls), Hp, Wp)
        assert args_c[5:8] == tuple(u.data_ptr() for u in uvs)
        assert args_c[-4:] == (M, psz, pad, 1234)
        outs = out
        for o in outs:
            assert o.shape == (3, 7) and o.dtype == torch.float32
    elif kernel.startswith("gather_ref"):
        assert args_c[:7] == (lvl.img.data_ptr(), q_img.data_ptr(), P, Hp, Wp,
                              centers.data_ptr(), origins.data_ptr())
        assert args_c[7:11] == tuple(o.data_ptr() for o in out)
        assert args_c[-3:] == (M, pad, 1234)
        outs = out[:3]
        assert out[3].shape == (3, 7, 16, 16)
    else:
        outs = (out,) if kernel == "gather_patches" else out
        assert args_c[:5] == (lvl.img.data_ptr(), P, Hp, Wp, centers.data_ptr())
        assert args_c[5:5 + len(outs)] == tuple(o.data_ptr() for o in outs)
        assert args_c[-4:] == (M, psz, pad, 1234)
    if kernel != "ncc3_scores":
        for o in outs:
            assert o.shape == (3, 7, psz, psz) and o.dtype == torch.float32
    launched = {k: v for c in counts.values() for k, v in c.items() if v}
    assert launched == {key: 1}
    if kernel == "ncc3_scores":
        return
    # the patch mean is the plain version's torch.mean, after the launch
    assert "aten::mean" in ops_of(True)[1]
    assert mod.launches[key] == 2


@pytest.mark.parametrize("stacked", [False, True], ids=["plane", "stack"])
def test_k7_wrapper_passes_the_stack_and_clamped_origins(monkeypatch, stacked):
    """K7 on a plane and on a stack of P = 2 planes, with origins beyond
    the plane: one entry call with P, Hp, Wp and the origins' own pointer,
    unclamped (the kernel clamps them), and nothing computed or copied in
    torch before it, so that a call is one device op on the card."""
    lib = _Recorder()
    monkeypatch.setattr(patch_gather, "on_card", lambda name, t: True)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 1234)
    monkeypatch.setattr(patch_gather, "launches", dict.fromkeys(patch_gather.launches, 0))
    _forbid_prep(monkeypatch)
    rng = np.random.default_rng(17)
    P = 2 if stacked else 1
    planes = torch.tensor(rng.uniform(0, 255, (P, 30, 44)).astype(np.float32))
    img = planes if stacked else planes[0]
    origins = torch.tensor(rng.integers(-20, 50, (P, 5, 2)).astype(np.int32))
    origins[:, :2] = torch.tensor([[-7, 40], [25, -3]], dtype=torch.int32)
    out, ran = _host_ops(lambda: patch_gather.gather_windows(img, origins, 12, 12))
    assert "aten::empty" in ran and ran <= _ALLOC | _VIEWS, ran
    assert out.shape == (P, 5, 12, 12)
    (entry, args_c), = lib.calls
    assert entry == "icgn_gather_windows"
    assert len(args_c) == len(_build._SIGNATURES[entry])
    for a, ctype in zip(args_c, _build._SIGNATURES[entry]):
        ctype(a)                                    # each converts as declared
    assert args_c == (img.data_ptr(), P, 30, 44, origins.data_ptr(), out.data_ptr(),
                      P * 5, 12, 12, 1234)
    assert patch_gather.launches["gather_windows"] == 1
    # a stack of 3 planes with the origins of P groups
    with pytest.raises(ValueError, match="takes points"):
        patch_gather.gather_windows(torch.zeros(3, 30, 44), origins, 12, 12)


# origins (row, col) of a 12 x 10 window on a 30 x 44 plane beyond each
# border and corner, and just inside them
_BEYOND = {
    "above": [(-1, 7), (-25, 20), (0, 3)],
    "below": [(19, 7), (30, 20), (400, 0)],
    "left": [(5, -1), (9, -44), (17, 0)],
    "right": [(5, 35), (9, 44), (0, 10**6)],
    "corners": [(-3, -3), (-9, 60), (50, -2), (31, 45)],
}


@pytest.mark.parametrize("side", list(_BEYOND))
def test_k7_clamps_origins_beyond_the_plane_as_the_plain_path(side):
    """The rule the kernel applies to each origin, min(max(o, 0), extent -
    size), gives the windows of the plain path (``clamp_to_fit`` in
    ``image/taps.py``) for origins beyond every border: on a plane and on
    a stack of 2 planes, through the wrapper on CPU tensors."""
    rng = np.random.default_rng(18)
    planes = rng.uniform(0, 255, (2, 30, 44)).astype(np.float32)
    o = np.array(_BEYOND[side] * 2, np.int32).reshape(2, -1, 2)
    wh, ww = 12, 10
    r = np.clip(o[..., 0], 0, 30 - wh)
    c = np.clip(o[..., 1], 0, 44 - ww)
    want = np.stack([np.stack([planes[p, r[p, i]:r[p, i] + wh, c[p, i]:c[p, i] + ww]
                               for i in range(o.shape[1])]) for p in range(2)])
    got = patch_gather.gather_windows(torch.tensor(planes), torch.tensor(o), wh, ww)
    np.testing.assert_array_equal(got.numpy(), want)
    one = patch_gather.gather_windows(torch.tensor(planes[1]), torch.tensor(o[1]), wh, ww)
    np.testing.assert_array_equal(one.numpy(), want[1])
