"""The device mesh: one process per card on ``torch.distributed``.

Counterpart of ``rovit_kan_tpu/parallel/mesh.py`` and of the 2-D and 3-D
meshes of ``rovit_kan_tpu/parallel/tensor.py`` and ``pipeline.py``. The JAX
package runs one SPMD program over a 1-D ``"data"`` mesh, a 2-D ``("data",
X)`` one, X being ``"model"`` (tensor parallelism), ``"expert"`` (expert
parallelism) or ``"pipe"`` (the GPipe pipeline), or the 3-D ``("data",
"pipe", "model")`` one (the pipeline's stages tensor-parallel); the port
runs one process per card (rank r on ``cuda:r``, or on the CPU) in one
process group, and a ``Mesh`` is that process's view of it: its
coordinates, the axes' sizes, its device and the collectives over each
axis. A step over N ranks computes the same step as one device on the
whole global batch (``training/trainer.py``).

``size`` and ``rank`` are always the data axis: the number of data indices
and this process's. ``axis_size(axis)`` and ``axis_rank(axis)`` answer for
any axis by name: for the axes the mesh has, and 1 and 0 for any other, so
a collective over an absent axis is a no-op; ``model_size`` and
``model_rank`` are the ``"model"`` axis's alone (1 and 0 on an expert or
pipeline mesh); ``inner_axes`` names the axes beside ``"data"``.
``make_mesh`` gives the 1-D mesh; ``make_2d_mesh(data, model)``,
``make_moe_mesh(data, expert)`` and ``make_pipeline_mesh(data, pipe,
model)`` lay the job's ranks out as JAX lays devices out, row-major with
the last axis innermost: global rank ``d * X + x`` sits at data index d and
index x of the second axis, and on the 3-D mesh rank ``(d * P + p) * T +
m`` at data index d, stage p and model index m. Each line of each axis
(the ranks that share every other coordinate) is a process group
(``dist.new_group``); a collective names its axis, ``"data"`` by default,
so every caller written for the 1-D mesh works over the data axis of the
others. ``broadcast_`` spans every rank of the job, or one axis; ``isend``
and ``recv`` reach a rank by its index on an axis (the pipeline's stages).

The backend is NCCL for a card and gloo for the CPU. gloo with tensors on
a card is taken only when the caller names it (two ranks sharing one card,
which NCCL refuses); its collectives then go through host copies, since
gloo's CUDA support lacks ``all_gather``. ``all_gather`` and
``reduce_scatter`` work along any dimension (the FSDP step's weights and
gradients, ``parallel/fsdp.py``). A mesh of 1 makes no process
group and runs no collective.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

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
    """This process's place in a mesh of ``size`` data indices (and
    ``second_size`` indices of the second axis, ``third_size`` of the third,
    on a 2-D or 3-D mesh)."""

    #: The 1-D mesh's one axis, the JAX package's data axis; a 2-D mesh
    #: has ``("data", X)``, X one of ``"model"``, ``"expert"``, ``"pipe"``;
    #: the 3-D mesh ``("data", "pipe", "model")``.
    axis_names = ("data",)

    def __init__(self, size: int, rank: int, device: torch.device,
                 backend: Optional[str], second_size: int = 1,
                 second_rank: int = 0, groups: Optional[dict] = None,
                 axis_names=None, third_size: int = 1, third_rank: int = 0):
        self.size = size
        self.rank = rank
        self.device = device
        self.backend = backend
        #: Each axis's process group (absent: the default group).
        self.groups = dict(groups or {})
        if axis_names is not None:
            self.axis_names = tuple(axis_names)
        n = len(self.axis_names)
        #: Each axis's size and this process's index on it, in axis order.
        self.shape = (size, second_size, third_size)[:n]
        self.coords = (rank, second_rank, third_rank)[:n]

    @property
    def world(self) -> int:
        """Every rank of the mesh: the product of the axes' sizes."""
        return math.prod(self.shape)

    def _flat(self, coords) -> int:
        """The global rank at ``coords``: row-major, the last axis
        innermost, as JAX lays devices out."""
        r = 0
        for c, n in zip(coords, self.shape):
            r = r * n + c
        return r

    @property
    def global_rank(self) -> int:
        """This process's rank in the job."""
        return self._flat(self.coords)

    @property
    def inner_axes(self) -> Tuple[str, ...]:
        """The axes beside ``"data"``: none on a 1-D mesh."""
        return self.axis_names[1:]

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``: 1 for an axis the mesh does not have."""
        if axis not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(axis)]

    def axis_rank(self, axis: str) -> int:
        """This process's index on ``axis``: 0 for an axis the mesh does
        not have."""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    @property
    def model_size(self) -> int:
        """The ``"model"`` axis's size (tensor parallelism)."""
        return self.axis_size("model")

    @property
    def model_rank(self) -> int:
        """This process's index on the ``"model"`` axis."""
        return self.axis_rank("model")

    def peer(self, axis: str, index: int) -> int:
        """The global rank at ``index`` on ``axis`` that shares this
        process's other coordinates."""
        coords = list(self.coords)
        coords[self.axis_names.index(axis)] = index
        return self._flat(coords)

    def __repr__(self) -> str:
        inner = "".join(f", {a}_size={self.axis_size(a)}, "
                        f"{a}_rank={self.axis_rank(a)}"
                        for a in self.inner_axes)
        return (f"Mesh(size={self.size}, rank={self.rank}{inner}, "
                f"device={self.device}, backend={self.backend})")

    def rows(self, global_batch: int) -> slice:
        """This rank's contiguous rows of a global batch; refuses a batch
        the ranks do not divide."""
        return rank_rows(global_batch, self.size, self.rank)

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    def all_reduce_(self, t: torch.Tensor, axis: str = "data"
                    ) -> torch.Tensor:
        """Sum ``t`` over the ranks of ``axis``, in place; returns ``t``."""
        if self.axis_size(axis) == 1:
            return t
        group = self.groups.get(axis)
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   axis: str = "data") -> torch.Tensor:
        """Every rank's ``t`` (over ``axis``) concatenated along ``dim``, in
        rank order."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        src = t.movedim(dim, 0)
        src = src.cpu() if self._staged(t) else src.contiguous()
        out = src.new_empty((n * src.shape[0], *src.shape[1:]))
        _ALL_GATHER(out, src, group=self.groups.get(axis))
        return out.to(t.device).movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0,
                       axis: str = "data") -> torch.Tensor:
        """``t`` summed over the ranks of ``axis`` and split into as many
        equal chunks along ``dim``; returns this rank's chunk."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        src = t.movedim(dim, 0)
        src = src.cpu() if self._staged(t) else src.contiguous()
        if src.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)}"
                             f" is not divisible by {n} ranks")
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        _REDUCE_SCATTER(out, src, group=self.groups.get(axis))
        return out.to(t.device).movedim(0, dim)

    def broadcast_(self, t: torch.Tensor, src: int = 0,
                   axis: Optional[str] = None) -> torch.Tensor:
        """Global rank ``src``'s ``t`` on every rank of the job, in place;
        with ``axis``, the ``t`` of index ``src`` on that axis on every
        rank of this process's group of it. Returns ``t``."""
        if axis is not None:
            if self.axis_size(axis) == 1:
                return t
            group, src = self.groups.get(axis), self.peer(axis, src)
        elif self.world == 1:
            return t
        else:
            group = None
        if self._staged(t):
            host = t.cpu()
            dist.broadcast(host, src, group=group)
            t.copy_(host)
        else:
            dist.broadcast(t, src, group=group)
        return t

    def isend(self, t: torch.Tensor, axis: str, index: int):
        """Send ``t`` to the rank at ``index`` on ``axis``; returns the
        request (``wait()`` before ``t`` is reused: a staged send holds its
        own host copy)."""
        src = t.detach().cpu() if self._staged(t) else t.detach().contiguous()
        return dist.isend(src, self.peer(axis, index))

    def recv(self, like: torch.Tensor, axis: str, index: int
             ) -> torch.Tensor:
        """A tensor shaped and typed as ``like``, received from the rank at
        ``index`` on ``axis`` (blocking)."""
        if self._staged(like):
            host = torch.empty(like.shape, dtype=like.dtype)
            dist.recv(host, self.peer(axis, index))
            return host.to(like.device)
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.recv(out, self.peer(axis, index))
        return out


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


def _axes_mesh(data: int, inner: Sequence[Tuple[str, int]],
               backend: Optional[str], device, need: str) -> Mesh:
    """The ``("data", *inner axes)`` mesh over every process of the job,
    ``data=-1`` taking the ranks the inner axes leave; ``need`` opens the
    JAX error for a data axis below 1. The global rank is row-major over
    the axes, the last innermost (module docstring); the device and
    backend are ``make_mesh``'s."""
    if device is None:
        device = (f"cuda:{local_rank()}" if torch.cuda.is_available()
                  else "cpu")
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    maybe_initialize_distributed(backend=backend)
    world = dist.get_world_size() if dist.is_initialized() else 1
    names = ("data",) + tuple(a for a, _ in inner)
    per = math.prod(n for _, n in inner)
    if data == -1:
        data = world // per
    if data < 1:
        raise ValueError(
            f"{need} (data axis resolved to {data} from {world} "
            f"device(s))")
    n = data * per
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs {n} processes, one per device; "
            f"this job has {world} (start one process per device: "
            f"cli.train --devices N, or torchrun)")
    shape = (data,) + tuple(n for _, n in inner)
    if world == 1:
        return Mesh(1, 0, device, None, axis_names=names)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"the mesh asked for {backend}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = dist.get_rank()
    groups = {}
    # Every rank makes every group, in one order (dist.new_group's rule):
    # for each axis, one group a line of it (the ranks that share every
    # other coordinate); an axis that spans the job keeps the default
    # group.
    for i, name in enumerate(names):
        if shape[i] in (1, world):
            continue
        lines: dict = {}
        for g in range(world):
            c = _coords(g, shape)
            lines.setdefault(c[:i] + c[i + 1:], []).append(g)
        for key in sorted(lines):
            group = dist.new_group(lines[key], backend=backend)
            if rank in lines[key]:
                groups[name] = group
    coords = _coords(rank, shape)
    kw = {}
    for prefix, size, c in zip(("second", "third"), shape[1:], coords[1:]):
        kw[f"{prefix}_size"], kw[f"{prefix}_rank"] = size, c
    return Mesh(shape[0], coords[0], device, backend, groups=groups,
                axis_names=names, **kw)


def _coords(rank: int, shape) -> Tuple[int, ...]:
    """The coordinates of global ``rank`` on a row-major mesh of
    ``shape``."""
    out = []
    for size in reversed(shape):
        out.insert(0, rank % size)
        rank //= size
    return tuple(out)


def make_2d_mesh(data: int = -1, model: int = 1,
                 backend: Optional[str] = None, device=None) -> Mesh:
    """The ``("data", "model")`` mesh of tensor parallelism, with the JAX
    ``make_2d_mesh``'s errors."""
    return _axes_mesh(data, [("model", model)], backend, device,
                      f"2-D mesh needs at least model = {model} devices")


def make_moe_mesh(data: int = -1, expert: int = 1,
                  backend: Optional[str] = None, device=None) -> Mesh:
    """The ``("data", "expert")`` mesh of expert parallelism, with the JAX
    ``make_moe_mesh``'s errors."""
    return _axes_mesh(data, [("expert", expert)], backend, device,
                      f"2-D mesh needs at least expert = {expert} devices")


def make_pipeline_mesh(data: int = -1, pipe: int = 2, model: int = 1,
                       backend: Optional[str] = None, device=None) -> Mesh:
    """The ``("data", "pipe")`` mesh of the GPipe pipeline, with the JAX
    ``make_pipeline_mesh``'s errors; with ``model > 1`` the 3-D ``("data",
    "pipe", "model")`` mesh, "model" innermost: global rank ``(d * pipe +
    p) * model + m`` (the pipeline's stages of Megatron-sharded blocks,
    ``parallel/pipeline.py``)."""
    inner = [("pipe", pipe)] + ([("model", model)] if model > 1 else [])
    return _axes_mesh(
        data, inner, backend, device,
        f"pipeline mesh needs at least pipe*model = {pipe * model} devices")


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global batch (a tensor, an array or a dict of
    them): its data index's, which every index of the second axis
    shares."""
    if mesh is None or mesh.size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    return batch[mesh.rows(batch.shape[0])]


@torch.no_grad()
def replicate(tensors, mesh: Mesh):
    """Broadcast rank 0's tensors (a module's state or a dict of tensors)
    to every rank of the job, in place; returns them."""
    if mesh is None or mesh.world == 1:
        return tensors
    items = (tensors.state_dict().values()
             if isinstance(tensors, torch.nn.Module) else tensors.values())
    for t in items:
        mesh.broadcast_(t)
    return tensors
