"""The data-parallel mesh: one process per card on ``torch.distributed``.

Counterpart of ``rovit_kan_tpu/parallel/mesh.py``. The JAX package runs one
SPMD program over a 1-D ``"data"`` mesh; the port runs one process per card
(rank r on ``cuda:r``, or on the CPU) in one process group, and a ``Mesh``
is that process's view of it: its rank, the world's size, its device and
the group's collectives. A step over N ranks computes the same step as one
device on the whole global batch (``training/trainer.py``).

The backend is NCCL for a card and gloo for the CPU. gloo with tensors on
a card is taken only when the caller names it (two ranks sharing one card,
which NCCL refuses); its collectives then go through host copies, since
gloo's CUDA support lacks ``all_gather``. ``all_gather`` and
``reduce_scatter`` work along any dimension (the FSDP step's weights and
gradients, ``parallel/fsdp.py``). A mesh of 1 makes no process
group and runs no collective.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from rovit_kan_tpu_torch import resolve_device
from rovit_kan_tpu_torch.parallel.multihost import (
    local_rank,
    maybe_initialize_distributed,
    rank_rows,
)

# The one-tensor collectives under their current names (older torch has
# only the ``*_tensor`` ones, which newer torch deprecates).
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class Mesh:
    """This process's place in a 1-D data mesh of ``size`` ranks."""

    #: The mesh's one axis, the JAX package's data axis.
    axis_names = ("data",)

    def __init__(self, size: int, rank: int, device: torch.device,
                 backend: Optional[str]):
        self.size = size
        self.rank = rank
        self.device = device
        self.backend = backend

    def __repr__(self) -> str:
        return (f"Mesh(size={self.size}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    def rows(self, global_batch: int) -> slice:
        """This rank's contiguous rows of a global batch; refuses a batch
        the ranks do not divide."""
        return rank_rows(global_batch, self.size, self.rank)

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self.size == 1:
            return t
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host)
            t.copy_(host)
        else:
            dist.all_reduce(t)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim``, in rank order."""
        if self.size == 1:
            return t
        src = t.movedim(dim, 0)
        src = src.cpu() if self._staged(t) else src.contiguous()
        out = src.new_empty((self.size * src.shape[0], *src.shape[1:]))
        _ALL_GATHER(out, src)
        return out.to(t.device).movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """``t`` summed over the ranks and split into ``size`` equal chunks
        along ``dim``; returns this rank's chunk."""
        if self.size == 1:
            return t
        src = t.movedim(dim, 0)
        src = src.cpu() if self._staged(t) else src.contiguous()
        if src.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)}"
                             f" is not divisible by {self.size} ranks")
        out = src.new_empty((src.shape[0] // self.size, *src.shape[1:]))
        _REDUCE_SCATTER(out, src)
        return out.to(t.device).movedim(0, dim)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
        if self.size == 1:
            return t
        if self._staged(t):
            host = t.cpu()
            dist.broadcast(host, src)
            t.copy_(host)
        else:
            dist.broadcast(t, src)
        return t


def make_mesh(n_devices: int = -1, backend: Optional[str] = None,
              device=None) -> Mesh:
    """The data mesh of this process.

    Under a process group of N ranks (``parallel.multihost``), the mesh
    spans all N: ``n_devices`` is -1 or N. Without one, only a mesh of 1
    exists. ``device`` defaults to ``cuda:LOCAL_RANK`` on a card and to the
    CPU where none is visible."""
    if device is None:
        device = (f"cuda:{local_rank()}" if torch.cuda.is_available()
                  else "cpu")
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    maybe_initialize_distributed(backend=backend)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices not in (-1, world):
        raise ValueError(
            f"a mesh of {n_devices} devices needs {n_devices} processes, "
            f"one per device; this job has {world} (start one process per "
            f"device: cli.train --devices N, or torchrun)")
    if world == 1:
        return Mesh(1, 0, device, None)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"the mesh asked for {backend}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(world, dist.get_rank(), device, backend)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global batch (a tensor, an array or a dict of
    them)."""
    if mesh is None or mesh.size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    return batch[mesh.rows(batch.shape[0])]


@torch.no_grad()
def replicate(tensors, mesh: Mesh):
    """Broadcast rank 0's tensors (a module's state or a dict of tensors)
    to every rank, in place; returns them."""
    if mesh is None or mesh.size == 1:
        return tensors
    items = (tensors.state_dict().values()
             if isinstance(tensors, torch.nn.Module) else tensors.values())
    for t in items:
        mesh.broadcast_(t)
    return tensors
