"""Analytic communication model for the distributed paths (copy of
``invcompcamtrack_tpu/parallel/model.py``).

Every collective the sharded programs execute is enumerable from shapes
alone: these functions count the bytes of the landmark-sharded window BA
(``ba/distributed.py``), the keyframe-sharded temporal BA
(``ba/temporal.py``) and the tracker's point-axis psums.  The JAX module
also states a TPU link rate; the port states none: ``model_step`` takes
the all-reduce rate as an argument, which the caller measures on its own
link.
"""

from __future__ import annotations

from dataclasses import dataclass

@dataclass
class CommModel:
    bytes_per_step: float
    comm_time_s: float
    compute_time_s: float

    @property
    def scaling_efficiency(self) -> float:
        """Modeled 1->N strong-scaling efficiency: compute shrinks with N
        (already folded into compute_time_s), comm does not."""
        return self.compute_time_s / (self.compute_time_s + self.comm_time_s)


def tracker_psum_bytes(batch: int, iters_per_scale: int, num_scales: int,
                       dtype_bytes: int = 4) -> float:
    """Point-axis (tp) sharded IC-GN: per scale one (B,6,6) Hessian psum
    + per iteration one (B,6) rhs psum (XLA-inserted under GSPMD)."""
    per_scale = batch * 36 * dtype_bytes
    per_iter = batch * 6 * dtype_bytes
    return num_scales * (per_scale + iters_per_scale * per_iter)


def ba_psum_bytes(K: int, lm_iters: int, reduced_solver: str = "dense",
                  cg_iters: int = 32, dtype_bytes: int = 4) -> float:
    """Landmark-sharded Schur BA: per LM iteration
    dense: Hpp (K,6,6) + bp (K,6) + S_off (6K)^2 + rhs (K,6)
    cg:    Hpp + bp + rhs + block-precond (K,6,6) + cg_iters x (K,6)."""
    hpp = K * 36 * dtype_bytes
    vec = K * 6 * dtype_bytes
    if reduced_solver == "dense":
        per_iter = hpp + vec + (6 * K) ** 2 * dtype_bytes + vec
    else:
        per_iter = hpp + vec + vec + hpp + cg_iters * vec
    return lm_iters * per_iter


def model_step(bytes_per_step: float, compute_time_s: float,
               allreduce_bytes_per_s: float,
               n_collectives: int = 0,
               latency_per_collective_s: float = 0.0) -> CommModel:
    """``allreduce_bytes_per_s``: the effective all-reduce rate of the
    link the step runs on, measured by the caller on that link (the port
    states no link rate of its own)."""
    return CommModel(
        bytes_per_step=bytes_per_step,
        comm_time_s=(bytes_per_step / allreduce_bytes_per_s
                     + n_collectives * latency_per_collective_s),
        compute_time_s=compute_time_s,
    )


def engine_keyframe_psums(K: int, struct_iters: int, joint_iters: int,
                          reduced_solver: str = "dense", cg_iters: int = 32,
                          dtype_bytes: int = 4):
    """Collective traffic of ONE landmark-sharded engine keyframe step
    (vo/engine.py::_promote_commit with VOConfig.ba_mesh set, hybrid
    mode): the structure pre-pass + joint phase BA psums, plus the
    per-iteration scalar cost/count psums of the accept/reject loop.

    Returns (bytes_per_keyframe, n_collectives) — feed ``model_step``
    with a measured per-collective dispatch latency
    (measured on the link the step runs on) for the full model.
    """
    iters = struct_iters + joint_iters
    ba_bytes = ba_psum_bytes(K, iters, reduced_solver, cg_iters, dtype_bytes)
    # accept/reject cost evaluation: 2 scalars (sum, count) per
    # candidate evaluation; per-landmark accept adds one more pass
    cost_evals = 2 * iters + 2
    scalar_bytes = cost_evals * 2 * dtype_bytes
    if reduced_solver == "dense":
        n_coll = iters * 4 + cost_evals
    else:
        n_coll = iters * (4 + cg_iters) + cost_evals
    return ba_bytes + scalar_bytes, n_coll


def temporal_ba_psum_bytes(L: int, lm_iters: int, cg_iters: int = 48,
                           dtype_bytes: int = 4) -> float:
    """Keyframe-sharded (SP) temporal BA (ba/temporal.py): per LM
    iteration the landmark-block psums Hxx (L,3,3) + bx (L,3), per CG
    iteration one (L,3) psum on the reduced camera system plus 2 scalar
    pdots, the back-substitution (L,3) psum, 2 cost psums (scalar
    sum+count), and 4 (6,)-vector ppermute halos (chain residual + rhs
    + per-matvec edges fold into the CG term).  Independent of K — the
    whole point of the SP layout: window length scales out with devices
    while the wire cost stays O(L)."""
    hxx = L * 9 * dtype_bytes
    lvec = L * 3 * dtype_bytes
    halo = 6 * dtype_bytes
    per_cg = lvec + 2 * dtype_bytes + 2 * halo
    per_iter = (hxx + lvec           # normal-equation landmark blocks
                + cg_iters * per_cg  # reduced-system PCG
                + lvec               # landmark back-substitution
                + 2 * 2 * dtype_bytes  # accept/reject cost psums
                + 4 * halo)          # chain residual/rhs edge exchange
    return lm_iters * per_iter
