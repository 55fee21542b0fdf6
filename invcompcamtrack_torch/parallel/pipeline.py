"""Device-stage pipeline parallelism (PP) for streaming sequences (port of
``invcompcamtrack_tpu/parallel/pipeline.py``).

The per-window work pyramid -> track -> triangulate -> refine is laid out
over the ranks of a mesh axis, and a stream of microbatches flows through
the stages GPipe-style: stage s of microbatch m runs at tick m + s, so in
steady state all P ranks are busy and the throughput is one microbatch
per tick.

The JAX module runs one SPMD program inside ``shard_map`` and picks each
device's stage with ``lax.switch`` on ``lax.axis_index``; here every rank
runs the tick loop and calls its own stage.  Inter-stage transfers are
ring shifts (``parallel/comm.py::ring_shifts``, the JAX module's
``lax.ppermute``); payloads are one fixed-shape float32 carrier, into
which heterogeneous stages pack their inputs and outputs.  A stage idles
on the ticks where it holds no microbatch (the JAX program computes them
and discards the result).  The last stage's emissions reach every rank
by one broadcast from it (the JAX module psums the emissions, which are
zero on every other device).

``vo_stage_fns`` provides the toy VO chain (pyramid / track / triangulate
/ refine) of the JAX module's tests; ``parallel/vo_pipeline.py`` runs the
engine's own stages.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from invcompcamtrack_torch.parallel.comm import axis_size, broadcast_from, ring_shift


def pipeline_ticks(stage: Callable, n_micro: int, mesh, axis: str,
                   ingest: Callable, emit: Callable, buf: torch.Tensor) -> None:
    """The tick loop every rank of a pipeline runs: ``n_micro + P - 1``
    ticks over the P ranks of ``mesh`` axis ``axis``; at each tick every
    rank ring-shifts its last output ``buf`` (one fixed-shape carrier) to
    the next rank, then runs its ``stage`` on the microbatch it holds,
    if any.  Stage 0 runs on ``ingest(m, prev)`` (microbatch ``m``,
    ``prev`` what the last stage sent round the ring), the others on
    what they received; the last stage hands each output to
    ``emit(m, out)``."""
    n_stage = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)
    for t in range(n_micro + n_stage - 1):
        prev = ring_shift(buf, group, 1)
        m = t - idx                     # the microbatch this stage holds
        if not 0 <= m < n_micro:
            continue
        buf = stage(ingest(m, prev) if idx == 0 else prev)
        if idx == n_stage - 1:
            emit(m, buf)


def pipeline_run(stage_fns: Sequence[Callable], xs: torch.Tensor, mesh,
                 axis: str = "stage") -> torch.Tensor:
    """Stream microbatches through per-rank stages.

    stage_fns: P callables, each ``(S,) f32 -> (S,) f32`` (pack/unpack
    inside); P must equal the size of ``mesh`` axis ``axis``.
    xs: (T, S) microbatch stream, the same on every rank (rank 0 takes
    it).  Returns (T, S): microbatch t's output after all P stages, the
    same on every rank.
    """
    n_stage = axis_size(mesh, axis)
    if len(stage_fns) != n_stage:
        raise ValueError(f"{len(stage_fns)} stages != mesh axis {n_stage}")
    T, S = xs.shape
    ys = torch.zeros((T, S), dtype=xs.dtype, device=xs.device)

    def emit(m, y):
        ys[m] = y

    pipeline_ticks(stage_fns[mesh.get_local_rank(axis)], T, mesh, axis,
                   lambda m, prev: xs[m], emit, torch.zeros_like(xs[0]))
    # replicate the last stage's emissions to every rank
    return broadcast_from(ys, mesh.get_group(axis), n_stage - 1)


def sequential_reference(stage_fns: Sequence[Callable], xs: torch.Tensor) -> torch.Tensor:
    """Oracle: the same stages composed sequentially per microbatch."""
    def one(x):
        for f in stage_fns:
            x = f(x)
        return x
    return torch.stack([one(x) for x in xs])


# ---------------------------------------------------------------------------
# The VO stage chain on the carrier-buffer convention.


def _pack(img, uv, extra):
    return torch.cat([img.reshape(-1), uv.reshape(-1), extra.reshape(-1)]).to(torch.float32)


def _conv_same(a, dim):
    """``jnp.convolve(r, [0.25, 0.5, 0.25], "same")`` along ``dim``: zeros
    beyond the border."""
    z = torch.zeros_like(a.narrow(dim, 0, 1))
    left = torch.cat([z, a.narrow(dim, 0, a.shape[dim] - 1)], dim=dim)
    right = torch.cat([a.narrow(dim, 1, a.shape[dim] - 1), z], dim=dim)
    return 0.25 * left + 0.5 * a + 0.25 * right


def vo_stage_fns(hw: tuple, n_pts: int, fc: tuple, cc: tuple):
    """Pyramid -> LK-style track -> triangulate -> refine as carrier-
    buffer stages for ``pipeline_run``.

    Carrier layout: [img (H*W), uv (n_pts*2), extra (n_pts*4)] where
    extra rows carry per-point scratch: depth estimate + residual terms.
    The bodies are compact single-step versions of the real subsystems
    (one smoothing level, one GN flow step, one midpoint triangulation,
    one depth refinement): the pipelining is what is under test.
    """
    H, W = hw
    S_img, S_uv = H * W, n_pts * 2

    def unpack(buf):
        img = buf[:S_img].reshape(H, W)
        uv = buf[S_img:S_img + S_uv].reshape(n_pts, 2)
        extra = buf[S_img + S_uv:].reshape(n_pts, 4)
        return img, uv, extra

    def stage_pyramid(buf):
        img, uv, extra = unpack(buf)
        # one smoothing level: 3x3 binomial blur (the pyramid kernel)
        sm = _conv_same(_conv_same(img, 1), 0)
        return _pack(sm, uv, extra)

    def stage_track(buf):
        img, uv, extra = unpack(buf)
        gy, gx = torch.gradient(img)
        ui = torch.clamp(uv[:, 0].to(torch.int32), 0, W - 1).long()
        vi = torch.clamp(uv[:, 1].to(torch.int32), 0, H - 1).long()
        g = torch.stack([gx[vi, ui], gy[vi, ui]], dim=1)
        r = img[vi, ui] - 128.0
        # one diagonal GN step toward the local mean intensity
        duv = -g * (r / (torch.sum(g * g, dim=1) + 1e-3))[:, None]
        return _pack(img, uv + 0.1 * duv, extra)

    def stage_triangulate(buf):
        img, uv, extra = unpack(buf)
        # inverse-depth init from the pixel offset (midpoint-style)
        x = (uv[:, 0] - cc[0]) / fc[0]
        y = (uv[:, 1] - cc[1]) / fc[1]
        depth = 8.0 / (1.0 + 0.05 * torch.sqrt(x * x + y * y))
        extra = extra.clone()
        extra[:, 0] = depth
        return _pack(img, uv, extra)

    def stage_refine(buf):
        img, uv, extra = unpack(buf)
        # one damped depth-refinement step against the ray constraint
        depth = extra[:, 0]
        target = 8.0
        depth = depth + 0.5 * (target - depth) / (1.0 + depth)
        extra = extra.clone()
        extra[:, 0] = depth
        return _pack(img, uv, extra)

    return [stage_pyramid, stage_track, stage_triangulate, stage_refine]
