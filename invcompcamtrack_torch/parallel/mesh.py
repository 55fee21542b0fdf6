"""Device-mesh and sharding helpers (port of
``invcompcamtrack_tpu/parallel/mesh.py``).

- mesh axis ``"data"``: independent work items (RANSAC hypotheses,
  image pairs, sequences); no collectives.
- mesh axis ``"model"``: the point/landmark axis within one problem;
  per-rank partial normal equations are all-reduced over this axis
  (``ba/distributed.py``).

The JAX module's ``Mesh`` holds the devices of one controller; here a
``torch.distributed.device_mesh.DeviceMesh`` spans the ranks of the
initialised world (``parallel/runtime.py::initialize_distributed``), one
device per rank, and an axis's collectives run over
``mesh.get_group(axis)`` (``parallel/comm.py``).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from invcompcamtrack_torch.device import resolve


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device_type: str | None = None) -> DeviceMesh:
    """A ("data", "model") mesh over the ranks of the initialised world,
    on the card unless ``device_type`` says otherwise (``"cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed world "
                           "(parallel/runtime.py::initialize_distributed)")
    n_total = dist.get_world_size()
    if n_data is None:
        n_data = n_total // n_model
    if n_data * n_model != n_total:
        raise ValueError(f"mesh {n_data}x{n_model} != {n_total} devices")
    return init_device_mesh(resolve(device_type).type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def shard_batch(mesh: DeviceMesh, *axes: str | None) -> list:
    """The placements that put array dim d on mesh axis ``axes[d]``
    (None = a replicated dim), one per mesh dim: ``Shard(d)`` for the
    mesh dim that carries array dim d, ``Replicate()`` for the others
    (the JAX module's ``NamedSharding(mesh, P(*axes))``)."""
    names = mesh.mesh_dim_names
    for a in axes:
        if a is not None and a not in names:
            raise ValueError(f"{a!r} is not an axis of the mesh {names}")
    return [next((Shard(d) for d, a in enumerate(axes) if a == name), Replicate())
            for name in names]
