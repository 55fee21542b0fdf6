"""Checkpoint / resume for the streaming VO state (port of
``invcompcamtrack_tpu/utils/checkpoint.py``).

The reference persists tracker state only as npz archives (reference:
classoftrack.py:133-134).  Here a checkpoint is a flat dict of numpy
arrays, saved atomically as npz.  ``vo_state_dict`` writes the JAX
module's keys for the port's one-stream engine (``"state" +
jax.tree_util.keystr(path)`` of its ``VOState``: ``state.landmarks``, ...,
``state.kf_pyr[0].img``, ``state.kf_ptr``, ``state.frame_idx``, built here
from the field names and the pyramid's level index, plus
``img_wh_host``, ``frame_idx_host`` and ``trajectory``), so a checkpoint
written by the JAX engine restores into the port and back.  The JAX
module saves through orbax where it is installed; the port reads and
writes npz only (the dict itself is the interchange).
"""

from __future__ import annotations

import pathlib
import re
import types
from typing import Any, Dict

import numpy as np
import torch

# the JAX VOState's fields, in its order (the port's adds only the host
# mirror kf_valid_host, derived from kf_valid on restore)
_FIELDS = ("landmarks", "lm_valid", "lm_fail", "kf_poses", "kf_valid", "kf_obs",
           "kf_obs_mask", "kf_rel", "kf_rel_valid", "kf_rel_info", "kf_pyr",
           "kf_ptr", "cur_pose", "frame_idx")
_LEVEL = ("img", "dx", "dy")


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path, tree: Dict[str, Any]) -> None:
    """Atomic npz save of a flat dict of arrays (``path`` with its
    suffix replaced by ``.npz``)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".npz.tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **{k: _to_numpy(v) for k, v in tree.items()})
    tmp.rename(path.with_suffix(".npz"))


def restore_checkpoint(path) -> Dict[str, np.ndarray]:
    npz = np.load(pathlib.Path(path).with_suffix(".npz"))
    return {k: npz[k] for k in npz.files}


def vo_state_dict(vo) -> Dict[str, np.ndarray]:
    """The checkpointable state of a ``VisualOdometry`` engine, under the
    JAX module's keys.  The full device state, the keyframe pyramid
    stacks included, is copied to the host, so a restored engine
    continues bit for bit without re-feeding images."""
    st = vo.state
    out = {}
    for name in _FIELDS:
        v = getattr(st, name)
        if name == "kf_pyr":
            for s, lvl in enumerate(v):
                for k, a in zip(_LEVEL, lvl):
                    out[f"state.kf_pyr[{s}].{k}"] = _to_numpy(a)
        elif name in ("kf_ptr", "frame_idx"):
            out[f"state.{name}"] = np.asarray(v, np.int32)
        else:
            out[f"state.{name}"] = _to_numpy(v)
    # the level-0 keyframe stack is (K, H+2p, W+2p): the unpadded size
    pad = vo.cfg.tracker.psz
    img0 = out["state.kf_pyr[0].img"]
    out["img_wh_host"] = np.asarray([img0.shape[2] - 2 * pad, img0.shape[1] - 2 * pad])
    out["frame_idx_host"] = np.asarray(vo._frame_idx)
    out["trajectory"] = (np.asarray(vo.trajectory) if vo.trajectory
                         else np.zeros((0, 3)))
    return out


def restore_vo_state(vo, state: Dict[str, np.ndarray]) -> None:
    """Load a checkpoint (the port's or the JAX engine's) into an engine
    built with the same config and camera, on the engine's device."""
    from invcompcamtrack_torch.convert import vo_state_from_numpy

    n_levels = 1 + max(int(m.group(1)) for k in state
                       if (m := re.fullmatch(r"state\.kf_pyr\[(\d+)\]\.img", k)))
    fields = {name: state[f"state.{name}"] for name in _FIELDS if name != "kf_pyr"}
    fields["kf_pyr"] = [[state[f"state.kf_pyr[{s}].{k}"] for k in _LEVEL]
                        for s in range(n_levels)]
    vo.state = vo_state_from_numpy(types.SimpleNamespace(**fields), vo.device)
    vo._frame_idx = int(state["frame_idx_host"])
    vo.trajectory = [c for c in np.asarray(state["trajectory"])]
