"""Thin multi-process runtime harness (port of
``invcompcamtrack_tpu/parallel/runtime.py``).

- ``initialize_distributed``: ``torch.distributed.init_process_group``
  with bounded retries (a rendezvous may not be up yet when a worker
  starts); a single process returns at once, decided from the
  environment alone.
- ``checkpointed_loop``: drive a step function with periodic checkpoints
  (``utils/checkpoint.py``) and resume from the last one, so a restarted
  worker re-joins from the last state; detecting the failure is the
  scheduler's job (a dead rank fails the collective, the job restarts,
  this harness resumes).
- ``spawn_processes`` / ``spawn_world``: start the ranks of a world on
  this host (the ``spawn`` context, safe once CUDA is up), join them by
  one deadline, kill what is left and fail; ``spawn_world`` also hands
  every rank a ``file://`` rendezvous and brings each rank's return
  value (or its traceback) back to the caller.  The port has no JAX
  counterpart of these: one JAX controller drives every device.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

from invcompcamtrack_torch.device import resolve
from invcompcamtrack_torch.utils.checkpoint import restore_checkpoint, save_checkpoint


def _launched_multiprocess() -> bool:
    """Whether a launcher started this process as one of several: the
    variables torchrun and its kind set (a rendezvous address, a world
    of more than one, an elastic run)."""
    env = os.environ
    try:
        world = int(env.get("WORLD_SIZE", "1"))
    except ValueError:
        world = 1
    return bool(env.get("MASTER_ADDR")) or world > 1 or bool(env.get("TORCHELASTIC_RUN_ID"))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           retries: int = 5, retry_delay_s: float = 5.0,
                           backend: Optional[str] = None,
                           timeout_s: float = 60.0) -> bool:
    """Bounded-retry wrapper over ``torch.distributed.init_process_group``.

    ``coordinator``: the init method (``tcp://host:port`` or
    ``file://path``); None reads the launcher's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  With no
    coordinator and no multi-process launcher in the environment it
    returns False (a single process needs no world).  ``backend``: None
    is ``"nccl"``, for the card; ``"cpu"`` is ``"gloo"``; any other name
    is passed on (``"gloo"`` with CUDA tensors puts several ranks on one
    card).  Returns True once the world is up.
    """
    if num_processes in (None, 1) and coordinator is None and not _launched_multiprocess():
        return False
    if backend is None:
        resolve(None)                     # the card, or an error
        backend = "nccl"
    elif backend == "cpu":
        backend = "gloo"
    kw = {"init_method": coordinator or "env://",
          "timeout": datetime.timedelta(seconds=timeout_s)}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    last = None
    for _ in range(retries):
        try:
            dist.init_process_group(backend, **kw)
            return True
        except (RuntimeError, ValueError, OSError) as e:  # rendezvous not up yet, ...
            last = e
            time.sleep(retry_delay_s)
    raise RuntimeError(f"distributed init failed after {retries} tries: {last}")


def _like(ref, a):
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(a).to(ref.device)
    return a


def checkpointed_loop(step_fn: Callable[[dict, int], dict], state: dict,
                      num_steps: int, ckpt_path, every: int = 10,
                      resume: bool = True):
    """Run ``state = step_fn(state, i)`` with periodic checkpoints and
    resume-from-checkpoint.  ``state`` is a flat dict of arrays or
    tensors; the checkpoint adds an integer ``"step"`` entry this loop
    maintains.  A restored entry is a tensor on the device of the given
    state's entry of that name where that is a tensor, else a numpy array.
    """
    start = 0
    if resume:
        try:
            restored = restore_checkpoint(ckpt_path)
            start = int(restored.pop("step"))
            state = {**state, **{k: _like(state.get(k), v) for k, v in restored.items()}}
        except (FileNotFoundError, KeyError, OSError):
            pass

    for i in range(start, num_steps):
        state = step_fn(state, i)
        if (i + 1) % every == 0 or i == num_steps - 1:
            save_checkpoint(ckpt_path, {**state, "step": i + 1})
    return state


def spawn_processes(target: Callable, n: int, args_of_rank: Callable[[int], tuple],
                    timeout_s: float) -> list:
    """Run ``target(*args_of_rank(r))`` in ``n`` processes started with
    the ``spawn`` context (``target`` must be a module-level function: a
    spawned process imports its module).  Every process is joined by one
    deadline ``timeout_s`` seconds away; those still alive then are
    killed and ``TimeoutError`` names them.  Returns the exit codes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of_rank(r), daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise TimeoutError(f"ranks {hung} of a world of {n} did not finish in {timeout_s} s")
    return [p.exitcode for p in procs]


def _world_rank(target: Callable, rank: int, n: int, tmp: str, args: tuple) -> None:
    try:
        payload = ("ok", target(rank, n, f"file://{tmp}/rendezvous", *args))
    except BaseException:  # noqa: BLE001  (reported to the parent, which raises)
        payload = ("error", traceback.format_exc())
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(payload, f)


def spawn_world(target: Callable, n: int, tmp, timeout_s: float, args: tuple = ()) -> list:
    """Run ``target(rank, n, init_method, *args)`` on every rank of an
    ``n``-process world (:func:`spawn_processes`) and return the ranks'
    return values, in rank order.  ``init_method`` is a ``file://``
    rendezvous under the directory ``tmp``, fresh for this world (no TCP
    port to race for); ``target`` initialises its process group on it
    (``initialize_distributed``) and destroys it.  A rank's return value
    travels back by pickle under ``tmp``; ``RuntimeError`` carries the
    traceback of a rank that raised, or names one that died without a
    result."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    for stale in [tmp / "rendezvous", *(tmp / f"rank{r}.pkl" for r in range(n))]:
        stale.unlink(missing_ok=True)
    codes = spawn_processes(_world_rank, n, lambda r: (target, r, n, str(tmp), args), timeout_s)
    results = []
    for r in range(n):
        path = tmp / f"rank{r}.pkl"
        if not path.exists():
            raise RuntimeError(f"rank {r} of a world of {n} exited with {codes[r]} and no result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} of a world of {n} failed:\n{value}")
        results.append(value)
    return results
