"""The C interface of the port's CUDA kernels against the table that
``ops/_build.py`` declares to ctypes, and the K5 and K6 wrappers' calls
into it.

A stale entry in ``_build._SIGNATURES`` makes ctypes pass a truncated
pointer or a wrong integer, and only a run on the card would show it.  So
every ``extern "C" int icgn_...(...)`` of ``csrc/*.cu`` is parsed here and
held to the table: the same names, the same number of arguments, each
pointer (``void*`` included) declared ``c_void_p`` and each ``int``
``c_int``.  Then the K5 and K6 wrappers run their card path on CPU tensors
against a stand-in library that records the call: what they pass, and
that they prepare no indices or weights (on the card such a call is one
device op).
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.ops import _build, patch_gather

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


@pytest.mark.parametrize("kernel", ["gather_patches", "gather_patches_grad"])
def test_k5_k6_wrappers_pass_centres_and_nothing_else(monkeypatch, kernel):
    lib = _Recorder()
    monkeypatch.setattr(patch_gather, "on_card", lambda name, t: True)
    monkeypatch.setattr(patch_gather, "support_of", _no_prep)
    monkeypatch.setattr(patch_gather, "bilinear_base", _no_prep)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 1234)
    monkeypatch.setattr(patch_gather, "launches", dict.fromkeys(patch_gather.launches, 0))
    rng = np.random.default_rng(16)
    psz, pad = 6, 6
    lvl = build_pyramid(torch.tensor(rng.uniform(0, 255, (40, 56)).astype(np.float32)),
                        1, pad)[0]
    centers = torch.tensor(rng.uniform(0, 50, (3, 7, 2)).astype(np.float32))
    planes = (lvl.img,) if kernel == "gather_patches" else (lvl.img, lvl.dx, lvl.dy)

    def ops_of(patch_norm):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = getattr(patch_gather, kernel)(*planes, centers, psz, pad, patch_norm)
        return out, {e.name for e in prof.events()}

    out, ran = ops_of(False)
    # what ran besides the call: allocation and views, no arithmetic
    assert "aten::empty" in ran
    assert ran <= {"aten::empty", "aten::empty_like", "aten::empty_strided", "aten::view",
                   "aten::reshape", "aten::_reshape_alias", "aten::alias",
                   "aten::as_strided"}, ran
    (entry, args), = lib.calls
    assert entry == "icgn_" + kernel
    assert len(args) == len(_build._SIGNATURES[entry])
    for a, ctype in zip(args, _build._SIGNATURES[entry]):
        ctype(a)                                    # each converts as declared
    M = centers.shape[0] * centers.shape[1]
    outs = (out,) if kernel == "gather_patches" else out
    Hp, Wp = lvl.img.shape
    assert args[:4] == (lvl.img.data_ptr(), Hp, Wp, centers.data_ptr())
    assert args[4:4 + len(outs)] == tuple(o.data_ptr() for o in outs)
    assert args[-4:] == (M, psz, pad, 1234)
    for o in outs:
        assert o.shape == (3, 7, psz, psz) and o.dtype == torch.float32
    assert patch_gather.launches == {**dict.fromkeys(patch_gather.launches, 0), kernel: 1}
    # the patch mean is the plain version's torch.mean, after the launch
    assert "aten::mean" in ops_of(True)[1]
    assert patch_gather.launches[kernel] == 2
