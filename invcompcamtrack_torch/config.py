"""Solver / pipeline configuration (the port's own copy of
``invcompcamtrack_tpu/config.py``: same fields, defaults and derived
properties, held equal by ``tests/test_torch_import.py``).

Mirrors the reference's ``optparam`` struct (reference: utilities.h:46-61)
so that reference experiment configurations are directly reproducible:
``lv_f lv_l psz maxiter normdp_ratio donorm dopatchnorm`` with the derived
fields ``pszd2 = psz/2``, ``novals = psz*psz``
(reference: run_io_reprojection_test.cpp:112-127).

All fields are static (hashable); there is no ``maxpttrack``: capacity
is simply the array length N of the (fixed-shape) point batch.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ICGNParams:
    """Static configuration of the IC-GN pose tracker.

    Canonical reference defaults (KITTI-ish):
    ``lv_f=4 lv_l=0 psz=8 maxiter=10 normdp_ratio=0.01 donorm=True``
    (reference: run_odometer_test.m:232, run_ransac_test.m:98-106).
    """

    lv_f: int = 4            # coarsest pyramid level (level 0 = full res)
    lv_l: int = 0            # finest pyramid level used
    psz: int = 8             # patch size (pixels, square)
    maxiter: int = 10        # max GN iterations per level
    normdp_ratio: float = 0.01  # stop when |dp|_1 / |dp_first|_1 <= ratio
    donorm: bool = True      # zero-mean/variance normalize cloud + pose
    dopatchnorm: bool = False  # subtract patch mean before residuals
    verbosity: int = 0
    # cache a (psz+8)^2 window per point per scale and resample query
    # patches from it each GN iteration (bit-exact while positions stay
    # within +-(slack) px of the scale-entry projection; clamped beyond).
    # False gathers the query patches from the image every iteration.
    # With psz == 8 the cached path is the fused one (K1 + K2).
    window_cache: bool = True
    # store the per-scale gradient patches, reference patches and cached
    # query windows in bfloat16 inside the fused GN iteration (arithmetic
    # stays f32 in the kernel; the 6x6 Hessian is built from the f32
    # planes before the downcast).  Only the fused path reads it.
    bf16_gather: bool = False
    # the JAX package splits the per-scale dual gather in two launches
    # with this flag to fit its kernel's fast memory; accepted here and
    # changes nothing.
    gather_split: bool = False
    # route the per-scale dual gather through the prefetch-pipelined
    # variant of K1 (K9 of the JAX package), which is not ported yet:
    # the tracker raises NotImplementedError when it is set.
    gather_prefetch: bool = False

    @property
    def window_size(self) -> int:
        return self.psz + 8

    @property
    def pszd2(self) -> int:
        return self.psz // 2

    @property
    def novals(self) -> int:
        return self.psz * self.psz

    @property
    def num_levels(self) -> int:
        """Number of pyramid levels that must exist (0..lv_f)."""
        return self.lv_f + 1

    def __post_init__(self):
        if self.psz % 2 != 0:
            raise ValueError(f"psz must be even, got {self.psz}")
        if not (0 <= self.lv_l <= self.lv_f):
            raise ValueError(f"need 0 <= lv_l <= lv_f, got {self.lv_l}, {self.lv_f}")
