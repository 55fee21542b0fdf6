"""The collectives of the port's SPMD programs, on ``torch.distributed``.

The JAX package runs its sharded programs inside ``jax.shard_map`` on one
controller; the port is multi-controller: every rank of a
``torch.distributed`` world runs the same Python program on replicated
inputs and works on its own shard.  The JAX primitives map to:

- ``lax.psum`` -> :func:`psum`, an all-reduce (SUM) of a copy over the
  axis's process group.  Every rank ends with the same sum, bit for bit,
  so host decisions taken on reduced values agree across ranks.
- ``lax.ppermute`` over a ring -> :func:`ring_shifts`, paired
  ``isend``/``irecv`` to the ring neighbours in one
  ``batch_isend_irecv``.  On a ring of one rank it sends nothing: a
  ppermute to oneself is the identity.
- ``lax.axis_index`` / ``lax.axis_size`` -> ``mesh.get_local_rank(axis)``
  / :func:`axis_size` of a ``DeviceMesh`` axis, whose process group is
  ``mesh.get_group(axis)``.

Transport: gloo all-reduces and broadcasts CUDA tensors, but its
point-to-point ``send``/``recv`` take CPU tensors only.  So a ring shift
of a CUDA tensor over a gloo group goes through an explicit copy to the
host and back (``_p2p_buffer``); the compute stays on the card.  Under
NCCL the tensors travel as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _check_group(group) -> None:
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"expected a torch.distributed ProcessGroup (or None), "
                        f"got {type(group).__name__}")


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along one named axis of a ``DeviceMesh``."""
    return dist.get_world_size(mesh.get_group(axis))


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (``lax.psum``); ``group``
    None is the one-device program and returns ``x`` itself.  Integer
    tensors (counts) are reduced as float64, exact below 2**53."""
    if group is None:
        return x
    _check_group(group)
    if x.is_floating_point():
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y
    y = x.to(torch.float64)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def broadcast_from(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Rank ``src`` of ``group`` (a group-local rank) sends ``x`` to all;
    every rank returns the same tensor (a copy)."""
    _check_group(group)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(y, src=dist.get_global_rank(group, src), group=group)
    return y


def _p2p_buffer(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous tensor that the group's backend can send: a host copy
    for CUDA tensors under gloo (its send/recv take CPU tensors only)."""
    x = x.detach().contiguous()
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return x.cpu()
    return x


def ring_shifts(pairs, group) -> list:
    """``lax.ppermute`` over the ring of ``group``, several at once:
    for each ``(x, shift)`` of ``pairs`` every rank i sends its ``x`` to
    rank ``(i + shift) % n`` and receives the ``x`` of rank
    ``(i - shift) % n``.  Returns the received tensors, on the devices of
    the sent ones.  With one rank nothing is sent (each ``x`` comes
    back as it is)."""
    _check_group(group)
    n = dist.get_world_size(group)
    if n == 1:
        return [x for x, _ in pairs]
    i = dist.get_rank(group)
    ops, outs = [], []
    for tag, (x, shift) in enumerate(pairs):
        buf = _p2p_buffer(x, group)
        out = torch.empty_like(buf)
        to = dist.get_global_rank(group, (i + shift) % n)
        frm = dist.get_global_rank(group, (i - shift) % n)
        ops.append(dist.P2POp(dist.isend, buf, to, group, tag))
        ops.append(dist.P2POp(dist.irecv, out, frm, group, tag))
        outs.append(out)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [out.to(x.device) for out, (x, _) in zip(outs, pairs)]


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """One :func:`ring_shifts` of ``x`` by ``shift`` ranks."""
    return ring_shifts([(x, shift)], group)[0]
