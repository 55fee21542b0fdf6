"""Flow-transfer point tracking with forward/backward verification (port
of ``invcompcamtrack_tpu/match/track.py``; the reference's ``oftrack``
class, misc_src/classoftrack.py:37-130).

The track store is a fixed-capacity masked table of fixed-shape tensors,
so the whole per-frame update runs on the table's device without a host
synchronisation:

- ``transfer_points``: bilinear interpolation of a dense flow field at
  track heads with out-of-bounds invalidation (classoftrack.py:4-34),
- forward/backward consistency gate: BOTH the error/displacement ratio
  (< 0.2) and the absolute error (< 1 px) must hold
  (classoftrack.py:85-93),
- dead tracks are recycled in place instead of compacted: new corners
  claim free slots via a prefix-sum slot assignment.

A track's history lives in a ring window of ``W`` recent positions (the
reference's ``bsize``), with NaNs marking pre-birth entries.  ``head``
and ``frame`` are 0-d tensors on the table's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from invcompcamtrack_torch.device import resolve

_FAR = float(2 ** 30)


def _norm(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(d * d, dim=1))


def transfer_points(xy: torch.Tensor, flow: torch.Tensor):
    """Transfer points by a dense flow field.

    xy: (N, 2); flow: (H, W, 2).  Returns (xy_new (N, 2), valid (N,)).
    The reference's validity rule: floor AND ceil of both coords must be
    inside the field (classoftrack.py:13); invalid results are NaN and
    masked.
    """
    H, W = flow.shape[0], flow.shape[1]
    finite = torch.all(torch.isfinite(xy), dim=1)
    xf = torch.floor(xy)
    f = xy - xf
    # (a non-finite or huge coordinate converts to int differently on the
    # CPU and on the card: such a point is invalid either way)
    xi = torch.clamp(torch.where(finite[:, None], xf, -torch.ones_like(xf)),
                     -_FAR, _FAR).long()
    x0, y0 = xi[:, 0], xi[:, 1]
    valid = (x0 >= 0) & (x0 + 1 < W) & (y0 >= 0) & (y0 + 1 < H) & finite
    x0c = torch.clamp(x0, 0, W - 2)
    y0c = torch.clamp(y0, 0, H - 2)
    w00 = f[:, 0] * f[:, 1]          # flow[y0+1, x0+1]
    w01 = (1 - f[:, 0]) * f[:, 1]    # flow[y0+1, x0]
    w10 = f[:, 0] * (1 - f[:, 1])    # flow[y0,   x0+1]
    w11 = (1 - f[:, 0]) * (1 - f[:, 1])
    flat = flow.reshape(-1, 2)

    def tap(yy, xx):
        return flat[yy * W + xx]

    d = (w00[:, None] * tap(y0c + 1, x0c + 1)
         + w01[:, None] * tap(y0c + 1, x0c)
         + w10[:, None] * tap(y0c, x0c + 1)
         + w11[:, None] * tap(y0c, x0c))
    xy_new = torch.where(valid[:, None], xy + d, torch.full_like(xy, float("nan")))
    return xy_new, valid


class TrackTable(NamedTuple):
    """Fixed-capacity track store (capacity C, history window W)."""

    xy: torch.Tensor          # (C, W, 2) ring buffer of positions; slot
                              # `head` is the current frame's position
    alive: torch.Tensor       # (C,) bool
    age: torch.Tensor         # (C,) int32 frames since birth
    total_move: torch.Tensor  # (C,) |first - current| (classoftrack.py:92)
    birth_xy: torch.Tensor    # (C, 2) position at track start
    head: torch.Tensor        # () int32, ring index of the current frame
    frame: torch.Tensor       # () int32, global frame counter


def make_track_table(capacity: int, window: int,
                     device: torch.device | str | None = None) -> TrackTable:
    dev = resolve(device)
    return TrackTable(
        xy=torch.full((capacity, window, 2), float("nan"), dtype=torch.float32, device=dev),
        alive=torch.zeros(capacity, dtype=torch.bool, device=dev),
        age=torch.zeros(capacity, dtype=torch.int32, device=dev),
        total_move=torch.zeros(capacity, dtype=torch.float32, device=dev),
        birth_xy=torch.full((capacity, 2), float("nan"), dtype=torch.float32, device=dev),
        head=torch.zeros((), dtype=torch.int32, device=dev),
        frame=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _column(xy: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """xy (C, W, 2), slot () -> (C, 2), the ring's entry at ``slot``."""
    return xy.index_select(1, slot.reshape(1).long())[:, 0]


def advance_tracks(state: TrackTable, flow_f: torch.Tensor, flow_b: torch.Tensor,
                   new_xy: torch.Tensor, new_valid: torch.Tensor,
                   ratio_th: float = 0.2, abs_th: float = 1.0) -> TrackTable:
    """One frame step: transfer live tracks through (flow_f, flow_b) with
    the fwd/bwd gate, then seed new tracks into free slots.

    new_xy: (K, 2) candidate corners for this frame; new_valid: (K,).
    All shapes fixed; nothing is read back to the host.
    """
    C, W, _ = state.xy.shape
    dev = state.xy.device
    cur = _column(state.xy, state.head % W)

    xy_f, ok_f = transfer_points(cur, flow_f)
    xy_fb, ok_b = transfer_points(xy_f, flow_b)
    err = _norm(cur - xy_fb)
    disp = _norm(cur - xy_f)
    gate = (err / torch.clamp(disp, min=1e-12) < ratio_th) & (err < abs_th)
    alive = state.alive & ok_f & ok_b & gate

    new_head = (state.head + 1) % W
    at = new_head.reshape(1).long()
    nan = torch.full_like(xy_f, float("nan"))
    xy = state.xy.index_copy(
        1, at, torch.where(alive[:, None], xy_f, nan).to(state.xy.dtype)[:, None])
    total_move = torch.where(alive, _norm(state.birth_xy - xy_f), state.total_move)

    # recycle dead slots with new corners: k-th valid corner -> k-th free slot
    free = ~alive
    slot_rank = torch.cumsum(free.to(torch.int32), 0) - 1       # rank among free slots
    cand_rank = torch.cumsum(new_valid.to(torch.int32), 0) - 1  # rank among candidates
    K = new_xy.shape[0]
    # cand_for_rank[r] = index of the candidate with rank r: a scatter into
    # C + 1 slots whose last takes the invalid candidates and the ranks
    # >= C and is discarded
    scatter_idx = torch.clamp(torch.where(new_valid, cand_rank, C), max=C).long()
    cand_for_rank = torch.full((C + 1,), -1, dtype=torch.int32, device=dev).scatter(
        0, scatter_idx, torch.arange(K, dtype=torch.int32, device=dev))[:C]
    take = cand_for_rank[torch.clamp(slot_rank, 0, C - 1).long()]
    seeds = free & (take >= 0)
    seed_xy = new_xy[torch.clamp(take, 0, K - 1).long()].to(xy.dtype)

    # seeded slots: wipe history to NaN, then place the seed at the head
    xy = torch.where(seeds[:, None, None], torch.full_like(xy, float("nan")), xy)
    xy = xy.index_copy(1, at, torch.where(seeds[:, None], seed_xy, _column(xy, new_head))[:, None])

    return TrackTable(
        xy=xy,
        alive=alive | seeds,
        age=torch.where(seeds, torch.zeros_like(state.age),
                        torch.where(alive, state.age + 1, state.age)),
        total_move=torch.where(seeds, torch.zeros_like(total_move),
                               total_move).to(state.total_move.dtype),
        birth_xy=torch.where(seeds[:, None], seed_xy, state.birth_xy),
        head=new_head,
        frame=state.frame + 1,
    )


def point_pairs(state: TrackTable, min_move: float = -1.0):
    """(prev, cur) positions of tracks alive across the last step: the
    reference's ``getpttransfer`` (classoftrack.py:103-130).

    Returns (pairs (C, 2, 2), valid (C,)): fixed shape and a mask instead
    of a compacted list.
    """
    W = state.xy.shape[1]
    cur = _column(state.xy, state.head % W)
    prev = _column(state.xy, (state.head - 1) % W)
    valid = (state.alive & (state.age >= 1) & torch.all(torch.isfinite(prev), dim=1)
             & (state.total_move > min_move))
    return torch.stack([prev, cur], dim=1), valid
