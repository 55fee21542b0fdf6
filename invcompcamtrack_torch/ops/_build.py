"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled with ``nvcc`` on first use, one process per
source started together, and linked into one shared library with a
plain C interface, ``build/torch_kernels/libicgn_kernels.so`` at the
root of the checkout.  The library is rebuilt when a hash of the
sources and flags changes, and is loaded with ``ctypes``: every pointer
and the stream are passed as ``c_void_p``.  A failed build raises.

Nothing here runs at import time; the CPU tests import the kernel
modules without a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

# the patch and window sides K1, K2, K3 and K9 are compiled for
# (csrc/common.cuh: kPsz, kWin); K4-K7 take theirs at run time
PSZ = 8
WIN = 16

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libicgn_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # rimg, qimg, Hp, Wp, idx, wts, p_img, p_dx, p_dy, qwin, M, pad, stream
    "icgn_gather_ref_grad_windows": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _P],
    # K9 takes K1's arguments
    "icgn_gather_prefetch": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # img, flow, out, H, W, stream
    "icgn_warp_image": [_P, _P, _P, _I, _I, _P],
    # img, Hp, Wp, centers, out, M, psz, pad, stream
    "icgn_gather_patches": [_P, _I, _I, _P, _P, _I, _I, _I, _P],
    # img, Hp, Wp, centers, p_img, p_dx, p_dy, M, psz, pad, stream
    "icgn_gather_patches_grad": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    # img, Wp, idx, out, M, wh, ww, stream
    "icgn_gather_windows": [_P, _I, _P, _P, _I, _I, _I, _P],
    # img_b, img_r, img_f, Hp, Wp, idx, wts, out, M, psz, stream
    "icgn_ncc3_scores": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P],
    # qwin, ref, pdx, pdy, row_w, col_w, wts, valid, out, M, norm, bf16, stream
    "icgn_resample_project": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # qwin, ref, row_w, col_w, wts, valid, out, M, norm, bf16, stream
    "icgn_resample_pdiff": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _run_all(cmds: list[list[str]], log) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log.write(f"$ {' '.join(cmd)}\n{out}\n")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile and link the kernels unless the library is up to date."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    with open(BUILD_DIR / "build.log", "w") as log:
        _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources(), objs)], log)
        tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]], log)
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.icgn_error_string.argtypes = [ctypes.c_int]
    lib.icgn_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = lib.icgn_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}: {msg})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
