"""Carry the trackers' state from the JAX package (or plain numpy) into
the port, and back.

The trackers have no weights: their state is the pyramids, the camera,
the world points, the poses, for the optical-flow point tracker the
track table, for the VO engine its ``VOState`` and for the pose-graph
optimiser its ``PoseGraph``; the VGG feature extractor's weights are a
flax parameter tree.  These helpers take them as numpy arrays, or
anything ``numpy.asarray`` accepts (a JAX array included, without this
module importing JAX), and return the port's tensors on one device: the
card, unless the caller passes ``device="cpu"``.  The tests feed both
packages through them.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from invcompcamtrack_torch.ba.pose_graph import PoseGraph
from invcompcamtrack_torch.ba.temporal import TemporalBAProblem
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.device import resolve
from invcompcamtrack_torch.image.pyramid import Pyramid, PyramidLevel, build_pyramid
from invcompcamtrack_torch.match.track import TrackTable
from invcompcamtrack_torch.vo.engine import VOState


def tensor_from_numpy(a, device: torch.device | str | None = None,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """Copy an array to a tensor (dtype kept unless one is given)."""
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=resolve(device), dtype=dtype)


def pyramid_from_numpy(levels: Iterable, device: torch.device | str | None = None,
                       dtype: torch.dtype = torch.float32) -> Pyramid:
    """A sequence of (img, dx, dy) padded planes per level -> Pyramid."""
    device = resolve(device)
    return tuple(PyramidLevel(*(tensor_from_numpy(a, device, dtype) for a in lvl))
                 for lvl in levels)


def camera_from_numpy(cam, device: torch.device | str | None = None) -> CameraPyramid:
    """Any object with (L,) fields fx, fy, cx, cy, swo, sho and an int
    ``padding`` (such as the JAX package's CameraPyramid) ->
    the port's CameraPyramid, float32."""
    device = resolve(device)
    return CameraPyramid(
        **{k: tensor_from_numpy(getattr(cam, k), device, torch.float32)
           for k in ("fx", "fy", "cx", "cy", "swo", "sho")},
        padding=int(cam.padding))


def nposes_from_numpy(poses, pt3d, inlier_masks, images: Sequence,
                      num_levels: int | None = None, padding: int | None = None,
                      device: torch.device | str | None = None):
    """The verifier's inputs (``solver/chain.py::track_nposes``) on one
    device.

    poses (S, 6), pt3d (N, 3), inlier_masks (S, N) bool.  ``images``
    holds one entry per frame: either a 2-D image, from which the pyramid
    is built here (``num_levels`` and ``padding`` are then required), or
    a sequence of per-level (img, dx, dy) padded planes, carried over as
    they are.  Returns (pyramids, poses, pt3d, inlier_masks): a list of
    Pyramids, two float32 tensors and a bool tensor.
    """
    device = resolve(device)
    pyramids = []
    for im in images:
        if getattr(im, "ndim", None) == 2:
            if num_levels is None or padding is None:
                raise ValueError("nposes_from_numpy: 2-D images need num_levels "
                                 "and padding to build their pyramids")
            pyramids.append(build_pyramid(
                tensor_from_numpy(im, device, torch.float32), num_levels, padding))
        else:
            pyramids.append(pyramid_from_numpy(im, device))
    masks = tensor_from_numpy(np.asarray(inlier_masks, bool), device)
    return (pyramids, tensor_from_numpy(poses, device, torch.float32),
            tensor_from_numpy(pt3d, device, torch.float32), masks)


def track_table_from_numpy(table, device: torch.device | str | None = None) -> TrackTable:
    """Any object with the fields of ``match/track.py::TrackTable`` (such
    as the JAX package's table) -> the port's table on one device, each
    field with its own type (float32, bool, int32)."""
    device = resolve(device)
    types = dict(xy=torch.float32, alive=torch.bool, age=torch.int32,
                 total_move=torch.float32, birth_xy=torch.float32,
                 head=torch.int32, frame=torch.int32)
    return TrackTable(**{k: tensor_from_numpy(np.asarray(getattr(table, k)), device, dt)
                         for k, dt in types.items()})


def track_table_to_numpy(table: TrackTable) -> dict:
    """The table's fields as numpy arrays, by name."""
    return {k: v.detach().cpu().numpy() for k, v in table._asdict().items()}


def vo_state_from_numpy(state, device: torch.device | str | None = None):
    """Any object with the fields of the JAX package's ``VOState`` (such
    as that state, its leaves numpy or JAX arrays) -> the port's one-stream
    ``vo/engine.py::VOState`` on one device, with its host mirror derived
    (``kf_ptr`` and ``frame_idx`` as ints, ``kf_valid_host`` from
    ``kf_valid``).  Assign it to ``VisualOdometry.state`` to run the port
    from the JAX engine's state."""
    device = resolve(device)

    def t(name, dtype):
        return tensor_from_numpy(np.asarray(getattr(state, name)), device, dtype)

    f32, b, i32 = torch.float32, torch.bool, torch.int32
    kf_valid = np.asarray(state.kf_valid, bool)
    return VOState(
        landmarks=t("landmarks", f32), lm_valid=t("lm_valid", b),
        lm_fail=t("lm_fail", i32), kf_poses=t("kf_poses", f32), kf_valid=t("kf_valid", b),
        kf_obs=t("kf_obs", f32), kf_obs_mask=t("kf_obs_mask", b), kf_rel=t("kf_rel", f32),
        kf_rel_valid=t("kf_rel_valid", b), kf_rel_info=t("kf_rel_info", f32),
        kf_pyr=pyramid_from_numpy([[np.asarray(a) for a in lvl] for lvl in state.kf_pyr],
                                  device),
        kf_ptr=int(np.asarray(state.kf_ptr)), cur_pose=t("cur_pose", f32),
        frame_idx=int(np.asarray(state.frame_idx)),
        kf_valid_host=tuple(bool(v) for v in kf_valid))


def temporal_problem_from_numpy(prob, device: torch.device | str | None = None,
                                dtype: torch.dtype = torch.float32):
    """Any object with the fields of ``ba/temporal.py::TemporalBAProblem``
    (such as the JAX package's problem) -> the port's problem on one
    device: poses, landmarks, observations, intrinsics, odometry and its
    weight as ``dtype``, the masks bool."""
    device = resolve(device)
    return TemporalBAProblem(**{
        k: tensor_from_numpy(np.asarray(v), device,
                             torch.bool if k in ("mask", "fixed_pose_mask") else dtype)
        for k, v in prob._asdict().items()})


def pose_graph_from_numpy(g, device: torch.device | str | None = None,
                          dtype: torch.dtype = torch.float32) -> PoseGraph:
    """Any object with the fields of ``ba/pose_graph.py::PoseGraph`` (such
    as the JAX package's graph) -> the port's graph on one device: poses,
    measurements and weights as ``dtype``, the edge indices int64, the
    anchors bool."""
    device = resolve(device)

    def t(name, dt):
        return tensor_from_numpy(np.asarray(getattr(g, name)), device, dt)

    return PoseGraph(poses=t("poses", dtype), edges_i=t("edges_i", torch.int64),
                     edges_j=t("edges_j", torch.int64), edges_meas=t("edges_meas", dtype),
                     edges_weight=t("edges_weight", dtype),
                     fixed_mask=t("fixed_mask", torch.bool))


def features_params_from_numpy(params) -> dict:
    """The flax ``VGGFeatures`` parameter tree (``{"params": {"conv0_0":
    {"kernel": (3, 3, I, O), "bias": (O,)}, ...}}``, numpy or JAX arrays)
    -> the port's ``VGGFeatures`` ``state_dict``: kernels HWIO -> OIHW,
    float32 CPU tensors, for ``module.load_state_dict``."""
    tree = params.get("params", params)
    out = {}
    for name, p in tree.items():
        kernel = np.asarray(p["kernel"], np.float32)
        out[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        out[f"{name}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))
    return out
