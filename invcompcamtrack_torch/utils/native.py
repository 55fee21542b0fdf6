"""ctypes bindings for the native runtime library (native/loader.cpp).

Provides the C++-backed host data path: PNM decode, the threaded
sequence prefetcher, and the binary protocol codec.  Builds the shared
library on first use (cached); every entry point has a pure-Python
fallback so the package works without a toolchain.

The port's own copy of ``invcompcamtrack_tpu/utils/native.py``: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
from typing import Optional, Sequence

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SO = _ROOT / "native" / "build" / "libicct.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _SO.exists() or (_SO.stat().st_mtime
                                < (_ROOT / "native" / "loader.cpp").stat().st_mtime):
            subprocess.run(
                ["make", "-C", str(_ROOT / "native")],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(str(_SO))
        lib.icct_decode_pnm.restype = ctypes.c_int
        lib.icct_image_data.restype = ctypes.c_int
        lib.icct_prefetch_create.restype = ctypes.c_void_p
        lib.icct_prefetch_query.restype = ctypes.c_int
        lib.icct_prefetch_fetch.restype = ctypes.c_int
        lib.icct_read_pointcam.restype = ctypes.c_int
        lib.icct_write_pointcam.restype = ctypes.c_int
        _lib = lib
    except (subprocess.CalledProcessError, OSError):
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def decode_pnm(path) -> np.ndarray:
    """PGM/PPM -> grayscale float32 (native, falls back to PIL)."""
    lib = _load()
    if lib is None:
        from invcompcamtrack_torch.utils.image import load_gray
        return load_gray(path)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.icct_decode_pnm(str(path).encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"decode_pnm failed ({rc}) for {path}")
    out = np.empty((h.value, w.value), np.float32)
    lib.icct_image_data(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


class SequencePrefetcher:
    """Threaded lookahead loader over an image sequence (the C++ data
    loader around the device loop).  Falls back to synchronous PIL."""

    def __init__(self, paths: Sequence[str], num_threads: int = 2):
        self.paths = [str(p) for p in paths]
        self._lib = _load()
        self._handle = None
        if self._lib is not None and all(
            p.lower().endswith((".pgm", ".ppm", ".pnm")) for p in self.paths
        ):
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._handle = self._lib.icct_prefetch_create(
                arr, len(self.paths), num_threads
            )

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int, release: bool = True) -> np.ndarray:
        if self._handle is None:
            from invcompcamtrack_torch.utils.image import load_gray
            return load_gray(self.paths[idx])
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.icct_prefetch_query(
            ctypes.c_void_p(self._handle), idx, ctypes.byref(w), ctypes.byref(h)
        )
        if rc != 0:
            raise IOError(f"prefetch failed ({rc}) for {self.paths[idx]}")
        out = np.empty((h.value, w.value), np.float32)
        rc = self._lib.icct_prefetch_fetch(
            ctypes.c_void_p(self._handle),
            idx,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            1 if release else 0,
        )
        if rc != 0:
            raise IOError(f"prefetch fetch failed ({rc})")
        return out

    def close(self):
        if self._handle is not None:
            self._lib.icct_prefetch_destroy(ctypes.c_void_p(self._handle))
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_pointcam_native(path, capacity: int = 10000):
    """Native binary-protocol reader; same result as utils.io.read_pointcam."""
    lib = _load()
    if lib is None:
        from invcompcamtrack_torch.utils import io
        return io.read_pointcam(path)
    pose = np.empty(6, np.float64)
    fc = np.empty(2, np.float32)
    cc = np.empty(2, np.float32)
    wh = np.empty(2, np.uint32)
    n = ctypes.c_uint64()
    xyz = np.empty(3 * capacity, np.float64)
    xy = np.empty(2 * capacity, np.float32)
    rc = lib.icct_read_pointcam(
        str(path).encode(),
        pose.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        fc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        wh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(n),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        capacity,
    )
    if rc != 0:
        raise IOError(f"read_pointcam failed ({rc}) for {path}")
    from invcompcamtrack_torch.utils import io
    k = n.value
    return io.PointCamFile(
        pose, fc, cc, wh,
        np.stack([xyz[:k], xyz[k:2 * k], xyz[2 * k:3 * k]], 1),
        np.stack([xy[:k], xy[k:2 * k]], 1),
    )
