"""Pipeline parallelism over the real VO chain (port of
``invcompcamtrack_tpu/parallel/vo_pipeline.py``).

The engine's keyframe step splits into its four sub-stages, one per rank
of a 4-rank ``stage`` axis:

  stage 0: pyramid build + IC-GN pose track     (engine._track_frame)
  stage 1: measured LK re-observation           (engine._promote_reobserve)
  stage 2: corner detect + LK + triangulation   (engine._promote_triangulate)
  stage 3: ring write + windowed BA + commit    (engine._promote_commit)

The frame chain is recurrent (stage 3's state feeds the stream's next
window at stage 0), so one stream cannot be pipelined; R = 4 independent
streams are round-robined into the ring instead: stream r's window w+1
enters stage 0 exactly when its window w leaves stage 3 over the ring's
wrap-around hop.  Every stream computes exactly the sequential engine's
operations: the stages are the engine's own functions, called on a state
of one stream (the steps' stream axis of 1).

Carrier: one flat float32 tensor per stream in flight, with the JAX
module's segments [ state | keyframe frames (or pyramids) | pose (6) |
extra | frame ]; ``extra`` holds whichever stage boundary (``_ReobsOut``
or ``_TriOut``) is live.  The port's state keeps ``kf_ptr``,
``frame_idx`` and a ``_TriOut``'s ``old_slot`` on the host: they ride as
floats (exact for small ints) and are read back as host ints when a
stage unpacks the carrier (one device-to-host copy per unpack), and the
host mirror ``kf_valid_host`` is derived from ``kf_valid`` in the same
copy.  The slim carrier ships the K keyframe frames in place of their
pyramid stacks (a pyramid's level-0 interior is its edge-padded source
frame), and every stage rebuilds the pyramids it needs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.image.pyramid import PyramidLevel, build_pyramid
from invcompcamtrack_torch.parallel.comm import axis_size, broadcast_from
from invcompcamtrack_torch.parallel.pipeline import pipeline_ticks
from invcompcamtrack_torch.vo.engine import (
    VOConfig,
    VOState,
    _promote_commit,
    _promote_reobserve,
    _promote_triangulate,
    _ReobsOut,
    _track_frame,
    _TriOut,
    make_empty_state,
    stream_state,
    with_stream_axis,
)

N_STAGES = 4


class _Seg(NamedTuple):
    """One carrier segment: offset and length."""

    off: int
    size: int


class _Fields(NamedTuple):
    """How an object of one stream rides in a carrier segment: per entry
    its key (a field name, or ``("kf_pyr", level, plane)``), shape and
    dtype; dtype None marks a host int (one float)."""

    entries: tuple
    size: int


def _fields(entries) -> _Fields:
    entries = tuple(entries)
    return _Fields(entries, sum(math.prod(shape) for _, shape, _ in entries))


def _get(obj, key):
    if isinstance(key, tuple):
        return obj.kf_pyr[key[1]][key[2]]
    return getattr(obj, key)


def _ravel(obj, fields: _Fields, device) -> torch.Tensor:
    parts = []
    for key, _, dt in fields.entries:
        v = _get(obj, key)
        parts.append(torch.tensor([float(v)], device=device) if dt is None
                     else v.reshape(-1).to(torch.float32))
    return torch.cat(parts)


def _unravel(flat: torch.Tensor, fields: _Fields, host_too=()) -> dict:
    """The entries of a segment by key, tensors as views cast back to
    their dtype and host ints as ints; the entries named in ``host_too``
    are also returned as host lists (under ``(key, "host")``).  One
    device-to-host copy for everything read to the host."""
    out, pos, host = {}, [], []
    off = 0
    for key, shape, dt in fields.entries:
        n = math.prod(shape)
        if dt is None or key in host_too:
            pos.extend(range(off, off + n))
            host.append((key, n))
        if dt is not None:
            out[key] = flat[off:off + n].reshape(shape).to(dt)
        off += n
    if pos:
        vals = flat[torch.tensor(pos, device=flat.device)].tolist()
        i = 0
        for key, n in host:
            if n == 1 and key not in host_too:
                out[key] = int(vals[i])
            else:
                out[(key, "host")] = vals[i:i + n]
            i += n
    return out


class _PyrHolder(NamedTuple):
    """A pyramid where ``_ravel`` reads one: under ``kf_pyr``."""

    kf_pyr: tuple


class VOPipelineSpec(NamedTuple):
    """Static carrier layout + the four stage bodies."""

    stage_fns: tuple
    carrier_size: int
    seg_pose: _Seg
    seg_frame: _Seg
    pack_state_fn: object    # (carrier, VOState) -> carrier
    unpack_state_fn: object  # carrier -> VOState
    device: torch.device

    def pack_init(self, state: VOState) -> torch.Tensor:
        """Carrier holding a bootstrapped stream state (one stream, the
        JAX module's shapes; the frame is injected at stage-0 ingestion)."""
        buf = torch.zeros((self.carrier_size,), dtype=torch.float32, device=self.device)
        return self.pack_state_fn(buf, state)

    def unpack_state(self, buf) -> VOState:
        return self.unpack_state_fn(buf)

    def unpack_pose(self, buf) -> torch.Tensor:
        s = self.seg_pose
        return buf[s.off:s.off + 6]

    def inject_frame(self, buf, img) -> torch.Tensor:
        s = self.seg_frame
        buf = buf.clone()
        buf[s.off:s.off + s.size] = torch.as_tensor(img, device=buf.device).reshape(-1)
        return buf


def make_vo_pipeline(cam: CameraPyramid, cfg: VOConfig, wh, dtype=torch.float32,
                     slim_carrier: bool = True) -> VOPipelineSpec:
    """Build the carrier layout and the four stage bodies for image size
    ``wh`` = (W, H), on the camera's device.  The pipelined engine
    promotes EVERY frame (keyframe_stride must be 1: each microbatch is
    one keyframe step).

    ``slim_carrier`` (the default) ships the K keyframe FRAMES instead of
    their pyramid stacks, and no current-frame pyramid segment: every
    stage rebuilds the pyramids it needs at entry, which is exact (the
    pyramid is a deterministic function of its level-0 interior, the
    frame).  ``slim_carrier=False`` keeps the pyramids on the ring."""
    if cfg.keyframe_stride != 1:
        raise ValueError("pipelined VO requires keyframe_stride=1 "
                         "(one keyframe step per microbatch)")
    cfgt = cfg.tracker
    H, W = int(wh[1]), int(wh[0])
    K, L = cfg.window, cfg.max_landmarks
    psz, levels = cfgt.psz, cfgt.num_levels
    dev = cam.fx.device
    f32, b, i32 = torch.float32, torch.bool, torch.int32

    # --- segment layouts: the state's fields in VOState order (host
    # mirror kf_valid_host derived), the stage boundaries' at S = 1 ---
    state_ex = stream_state(make_empty_state(cfg, wh, dtype, dev), 0)
    st_entries = []
    for name in VOState._fields:
        v = getattr(state_ex, name)
        if name == "kf_valid_host":
            continue
        if name == "kf_pyr":
            if not slim_carrier:
                st_entries += [(("kf_pyr", s, j), tuple(a.shape), a.dtype)
                               for s, lvl in enumerate(v) for j, a in enumerate(lvl)]
        elif name in ("kf_ptr", "frame_idx"):
            st_entries.append((name, (1,), None))
        else:
            st_entries.append((name, tuple(v.shape), v.dtype))
    f_state = _fields(st_entries)
    # the current frame's pyramid (fat carrier): one stream's levels
    f_pyr = _fields(((("kf_pyr", s, j), (1,) + tuple(lvl.img.shape[1:]), dtype)
                     for s, lvl in enumerate(state_ex.kf_pyr) for j in range(3)))
    f_ro = _fields((("xy_meas", (1, L, 2), dtype), ("reobs", (1, L), b),
                    ("lm_fail", (1, L), i32), ("lm_valid", (1, L), b)))
    f_tri = _fields((("landmarks", (1, L, 3), dtype), ("lm_valid", (1, L), b),
                     ("lm_fail", (1, L), i32), ("old_slot", (1,), None),
                     ("old_obs", (1, L, 2), dtype), ("old_obs_mask", (1, L), b),
                     ("new_obs", (1, L, 2), dtype), ("new_obs_mask", (1, L), b),
                     ("n_seeded", (1,), i32)))
    n_state, n_pyr = f_state.size, f_pyr.size
    n_extra = max(f_ro.size, f_tri.size)
    n_frame = H * W
    n_kff = K * H * W if slim_carrier else 0

    off_state = 0
    off_kff = n_state                      # slim only (n_kff = 0 otherwise)
    off_pyr = off_kff + n_kff              # fat only (segment absent in slim)
    off_pose = off_pyr + (0 if slim_carrier else n_pyr)
    off_extra = off_pose + 6
    off_frame = off_extra + n_extra
    size = off_frame + n_frame

    def get(buf, off, n):
        return buf[off:off + n]

    def put(buf, off, flat):
        buf[off:off + flat.numel()] = flat.reshape(-1).to(f32)
        return buf

    def u_state(buf) -> VOState:
        v = _unravel(get(buf, off_state, n_state), f_state, host_too=("kf_valid",))
        kf_valid_host = tuple(x != 0.0 for x in v.pop(("kf_valid", "host")))
        if slim_carrier:
            kff = get(buf, off_kff, n_kff).reshape(K, H, W).to(dtype)
            kf_pyr = build_pyramid(kff, levels, psz)
        else:
            kf_pyr = tuple(PyramidLevel(*(v.pop(("kf_pyr", s, j)) for j in range(3)))
                           for s in range(levels))
        return VOState(**v, kf_pyr=kf_pyr, kf_valid_host=kf_valid_host)

    def pack_state(buf, st: VOState):
        if slim_carrier:
            # level-0 interior == the source frame (pad_level edge-pads)
            put(buf, off_kff, st.kf_pyr[0].img[:, psz:-psz, psz:-psz])
        return put(buf, off_state, _ravel(st, f_state, buf.device))

    def u_pyr(buf):
        if slim_carrier:
            img = get(buf, off_frame, n_frame).reshape(1, H, W).to(dtype)
            return build_pyramid(img, levels, psz)
        v = _unravel(get(buf, off_pyr, n_pyr), f_pyr)
        return tuple(PyramidLevel(*(v[("kf_pyr", s, j)] for j in range(3)))
                     for s in range(levels))

    def u_pose(buf):
        return get(buf, off_pose, 6).to(dtype)[None]

    def put_extra(buf, obj, f):
        flat = _ravel(obj, f, buf.device)
        return put(buf, off_extra, torch.cat([flat, flat.new_zeros(n_extra - flat.numel())]))

    # --- the four stage bodies (carrier -> carrier; each writes into a
    # copy of its input) ---

    def stage_track(buf):
        buf = buf.clone()
        state = with_stream_axis(u_state(buf))
        img = get(buf, off_frame, n_frame).reshape(1, H, W).to(dtype)
        pyr = build_pyramid(img, levels, psz)
        p_new = _track_frame(state, pyr, cam, cfgt)
        if not slim_carrier:
            put(buf, off_pyr, _ravel(_PyrHolder(pyr), f_pyr, buf.device))
        return put(buf, off_pose, p_new[0])

    def stage_reobserve(buf):
        buf = buf.clone()
        ro = _promote_reobserve(with_stream_axis(u_state(buf)), u_pyr(buf), u_pose(buf),
                                cam, cfg)
        return put_extra(buf, ro, f_ro)

    def stage_triangulate(buf):
        buf = buf.clone()
        ro = _ReobsOut(**_unravel(get(buf, off_extra, f_ro.size), f_ro))
        tri = _promote_triangulate(with_stream_axis(u_state(buf)), u_pyr(buf), u_pose(buf),
                                   cam, cfg, ro)
        return put_extra(buf, tri, f_tri)

    def stage_commit(buf):
        buf = buf.clone()
        state = u_state(buf)
        tri = _TriOut(**_unravel(get(buf, off_extra, f_tri.size), f_tri))
        st2 = _promote_commit(with_stream_axis(state), u_pyr(buf), u_pose(buf), cam, cfg, tri)
        st2 = stream_state(st2._replace(frame_idx=state.frame_idx + 1), 0)
        pack_state(buf, st2)
        return put(buf, off_pose, st2.cur_pose)

    return VOPipelineSpec(
        stage_fns=(stage_track, stage_reobserve, stage_triangulate, stage_commit),
        carrier_size=size,
        seg_pose=_Seg(off_pose, 6),
        seg_frame=_Seg(off_frame, n_frame),
        pack_state_fn=pack_state,
        unpack_state_fn=u_state,
        device=dev,
    )


def vo_pipeline_run(spec: VOPipelineSpec, init_states, frames, mesh, axis: str = "stage"):
    """Run R = mesh[axis] interleaved VO streams through the 4-stage ring.

    Every rank calls it with the same arguments.  init_states: R
    bootstrapped one-stream ``VOState``s (``VisualOdometry.state``).
    frames: (R, W, H, Wd), stream-major window frames (numpy or tensor).
    Returns (poses (R, W, 6), final_states: a list of R one-stream
    ``VOState``s), the same on every rank: what R sequential engines
    produce.

    Schedule: tick t ingests stream ``t % R`` window ``t // R`` at stage
    0; its committed carrier leaves stage 3 at tick t + 3 and wraps
    straight back into stage 0 for the stream's next window.  R*W + 3
    ticks for R*W keyframe steps.
    """
    R = axis_size(mesh, axis)
    if R != N_STAGES:
        raise ValueError(f"mesh axis {axis}={R}, need {N_STAGES} "
                         "(streams are round-robined over stages)")
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.asarray(frames, np.float32))
    frames = frames.to(device=spec.device, dtype=torch.float32)
    n_stream, n_win = frames.shape[:2]
    if n_stream != R:
        raise ValueError(f"{n_stream} streams != {R} stages")
    n_in = R * n_win
    # tick-major frame stream: tick t serves stream t % R, window t // R
    frames_flat = frames.transpose(0, 1).reshape(n_in, -1)
    poses = torch.zeros((R, n_win, 6), dtype=torch.float32, device=spec.device)
    finals = torch.zeros((R, spec.carrier_size), dtype=torch.float32, device=spec.device)

    def ingest(m, prev):
        # the first R ticks ingest the bootstrapped states; afterwards the
        # ring's wrap-around is the feedback (stage 3 of window w -> stage
        # 0 of window w + 1)
        inp = spec.pack_init(init_states[m]) if m < R else prev
        return spec.inject_frame(inp, frames_flat[m])

    def emit(m, out):
        poses[m % R, m // R] = spec.unpack_pose(out)
        if m // R == n_win - 1:
            finals[m % R] = out

    pipeline_ticks(spec.stage_fns[mesh.get_local_rank(axis)], n_in, mesh, axis, ingest, emit,
                   torch.zeros((spec.carrier_size,), dtype=torch.float32, device=spec.device))
    group = mesh.get_group(axis)
    last = N_STAGES - 1
    poses = broadcast_from(poses, group, last)
    finals = [spec.unpack_state(c) for c in broadcast_from(finals, group, last)]
    return poses, finals


def pp_ring_bytes_per_step(spec: VOPipelineSpec) -> float:
    """Modeled link bytes per keyframe step: each tick moves one carrier
    per rank over its ring link, and one tick completes one step."""
    return float(N_STAGES * spec.carrier_size * 4)
