"""Process-level glue of the data mesh: the process group and the batch.

Counterpart of ``rovit_kan_tpu/parallel/multihost.py``. The JAX package
brings up ``jax.distributed``; the port brings up a ``torch.distributed``
process group from the variables torchrun sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), which ``cli.train
--devices N`` also sets for the workers it starts. A single process (no
``WORLD_SIZE``, or 1) makes no group.

- ``maybe_initialize_distributed``: the group, once, with a timeout, so a
  rank that dies does not leave the others waiting for ever, destroyed at
  exit;
- ``local_batch_slice``: which rows of the global batch this process feeds;
- ``global_mesh``: the mesh over every process of the job;
- ``make_global_array``: the global batch from every rank's rows.
"""
from __future__ import annotations

import atexit
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

#: Seconds a collective may wait for a rank before the job fails.
TIMEOUT_S = 600


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def maybe_initialize_distributed(backend: Optional[str] = None,
                                 timeout_s: float = TIMEOUT_S) -> bool:
    """Initialize the default process group once from torchrun's variables;
    a no-op for a single process. ``backend`` defaults to NCCL where a card
    is visible and gloo elsewhere. Returns whether the job has more than
    one process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return False
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} but {missing} unset: start "
                           f"the ranks with torchrun or cli.train --devices")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend, world_size=world, rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    atexit.register(_destroy_at_exit)
    return True


def _destroy_at_exit() -> None:
    """Destroy the process group and every group made from it before the
    interpreter's own teardown: left to that, gloo's threads can outlive
    their objects and abort a rank (SIGABRT, "terminate called without an
    active exception") after its work is done, in about half of the
    launches of eight CPU ranks."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Every process waits here for the others (no-op alone)."""
    if process_count() > 1:
        dist.barrier()


def global_mesh(backend: Optional[str] = None, device=None):
    """The 1-D data mesh over every process in the job."""
    from rovit_kan_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(-1, backend=backend, device=device)


def rank_rows(global_batch_size: int, n_proc: int, rank: int) -> slice:
    """Rank ``rank``'s contiguous rows of a global batch split over
    ``n_proc`` ranks. Raises when the batch does not divide: silent
    truncation would drop trailing rows from every batch on every rank."""
    if global_batch_size % n_proc:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{n_proc} processes — pad or resize the batch")
    per = global_batch_size // n_proc
    return slice(per * rank, per * (rank + 1))


def local_batch_slice(global_batch_size: int) -> slice:
    """The contiguous rows of the global batch this process loads."""
    return rank_rows(global_batch_size, process_count(), process_index())


def make_global_array(local_rows: Any, mesh) -> Any:
    """The global batch from every rank's rows (a tensor or a dict of
    them), in rank order, on every rank."""
    if isinstance(local_rows, dict):
        return {k: make_global_array(v, mesh) for k, v in local_rows.items()}
    return mesh.all_gather(local_rows)


def broadcast_one_to_all(value: Any) -> Any:
    """Process 0's ``value`` (any picklable object) on every process."""
    if process_count() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def any_process(flag: bool) -> bool:
    """Whether ``flag`` is set on any process."""
    if process_count() == 1:
        return bool(flag)
    flags = [None] * process_count()
    dist.all_gather_object(flags, bool(flag))
    return any(flags)
