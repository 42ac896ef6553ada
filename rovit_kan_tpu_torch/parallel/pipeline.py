"""Pipeline parallelism: the GPipe schedule over the ``("data", "pipe")`` mesh
and the 3-D ``("data", "pipe", "model")`` one.

Counterpart of ``rovit_kan_tpu/parallel/pipeline.py``. The depth blocks are
split into S contiguous stages, one per index of the mesh's ``"pipe"``
axis: stage s holds blocks ``[s*depth/S, (s+1)*depth/S)``, the ``P("pipe")``
split of the JAX package's stacked depth axis, and every other leaf (patch
embedding, CLS and position embeddings, final norm, heads, KAN) whole on
every pipe rank.

- **Layouts.** ``split_params`` and ``merge_params`` convert JAX-layout
  trees (``backbone/blocks_i`` subtrees <-> one ``backbone/blocks`` subtree
  stacked on a leading depth axis), as the JAX functions do, and
  ``pipeline_param_specs`` gives the JAX spec tree of a split tree. The
  port keeps its per-block names: a stage's state is the state_dict of its
  blocks and the whole leaves (``Pipeline.local``), and checkpoints hold
  the one-process state_dict (``Pipeline.gather_full``), as the JAX
  ``Trainer`` saves the merged tree.
- **Schedule** (``PipeAxis.run``, the JAX ``pipeline_blocks``). The local
  batch is cut into M microbatches. Over ticks ``t = 0 .. M + S - 2`` stage
  s takes microbatch ``t - s`` where that is one: stage 0 from the
  embedding's output, every other stage from the activation the stage
  before sends (point-to-point), and runs its blocks through the ordinary
  ``Block.forward``, so under the "auto" policy the flagship's stages
  launch #1 once a microbatch and a block, and #2 in the backward. The
  last stage's outputs go to every pipe rank (a broadcast over ``"pipe"``,
  where the JAX package psums the last stage's masked fp32 outputs: the
  same bits). The backward runs the ticks in reverse: each stage
  backpropagates its microbatches, last first, from the gradient the next
  stage sends (the last stage from its own output gradient), the block
  gradients adding up over the microbatches, and sends its input gradient
  back. Stage 0's input gradient goes to every pipe rank, so the
  replicated embedding gets the same gradient on every one.
- **Everything outside the block stack** runs on every pipe rank alike:
  the embedding, the final norm, the heads (their dropout drawn from the
  step's generator, the same masks on every pipe rank) and the loss;
  ``Pipeline.__call__`` is the JAX ``pipelined_forward``. So the whole
  leaves' gradients are equal over ``"pipe"`` and only the data axis
  reduces them; the blocks' squares are summed over ``"pipe"`` in the flat
  AdamW's norm (``training/optimizer.py``).
- **Route.** The JAX stages run the plain ``_block_xla`` (rematerialised);
  the port's stages run what the model's policy gives each block (the
  fused block #1/#2 at the flagship's width, which keeps only a block's
  input), a departure in route, not in results.
- **The 3-D mesh** (``make_pipeline_mesh(data, pipe, model)``, "model"
  innermost). The JAX package leaves "model" to GSPMD inside its
  partial-manual ``shard_map``, so each stage runs Megatron tensor
  parallelism from ``pipeline_param_specs(tp=True)`` alone, its blocks
  still the plain ``_block_xla``. Here each rank keeps its stage's blocks
  cut on its model index as ``TensorParallel`` cuts them, and the blocks
  run ``Block._tp_forward`` over the model axis (``parallel/tensor.py``'s
  operators; the heads' attention core through #5/#6 where the policy
  would take the fused block). A sharded block's output is whole on every
  model rank, so stage s at (d, s, m) sends to (d, s + 1, m), and the
  broadcasts over ``"pipe"`` run on each model index's own line.

Point-to-point sends on gloo take host tensors: on a card under gloo they
are staged through the host, as ``Mesh``'s collectives are. A stage
receives before it computes and sends after, in the tick order, so no
send waits on a peer that is itself sending.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from rovit_kan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_pipeline_mesh,
)
from rovit_kan_tpu_torch.parallel.tensor import (
    ModelAxis,
    ShardedModel,
    megatron_specs,
    path_spec,
)

PIPE_AXIS = "pipe"
MODEL_AXIS = "model"

BLOCKS = "backbone.model.blocks."


def is_pipeline_mesh(mesh) -> bool:
    return mesh is not None and PIPE_AXIS in getattr(mesh, "axis_names", ())


def fit_microbatches(n_micro: int, local_batch: int) -> int:
    """The largest count of microbatches at most ``n_micro`` that divides
    ``local_batch`` (the JAX ``Trainer``'s fit: fewer microbatches, a larger
    bubble)."""
    n = max(int(n_micro), 1)
    while n > 1 and local_batch % n:
        n -= 1
    return n


# -- the JAX layouts ----------------------------------------------------------

def _stack(*xs):
    if torch.is_tensor(xs[0]):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def _tree_map(fn: Callable, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _block_keys(params: Dict[str, Any]) -> List[str]:
    n = sum(1 for k in params["backbone"] if k.startswith("blocks_"))
    return [f"blocks_{i}" for i in range(n)]


def split_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """JAX-layout tree -> the pipelined layout: the ``backbone/blocks_i``
    subtrees stacked on a leading ``(depth, ...)`` axis as one
    ``backbone/blocks`` subtree; everything else as it is. Numpy arrays or
    tensors. Inverse: ``merge_params``."""
    keys = _block_keys(params)
    bb = {k: v for k, v in params["backbone"].items() if k not in keys}
    bb["blocks"] = _tree_map(_stack, *(params["backbone"][k] for k in keys))
    return {**{k: v for k, v in params.items() if k != "backbone"},
            "backbone": bb}


def merge_params(split: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``split_params``."""
    stacked = split["backbone"]["blocks"]
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    bb = {k: v for k, v in split["backbone"].items() if k != "blocks"}
    for i in range(leaf.shape[0]):
        bb[f"blocks_{i}"] = _tree_map(lambda x, i=i: x[i], stacked)
    return {**{k: v for k, v in split.items() if k != "backbone"},
            "backbone": bb}


def pipeline_param_specs(split: Dict[str, Any], tp: bool = False) -> Any:
    """The JAX spec tree of a split tree, one axis name (or None) a dim:
    ``("pipe",)`` for every ``backbone/blocks`` leaf, ``()`` elsewhere. With
    ``tp=True`` (the 3-D mesh) each stacked block leaf's trailing dims also
    take the JAX Megatron rule (``parallel/tensor.py``), so the stacked qkv
    kernel is ``("pipe", None, "model")``."""
    def spec(node, path):
        if isinstance(node, dict):
            return {k: spec(v, path + (k,)) for k, v in node.items()}
        if path[:2] != ("backbone", "blocks"):
            return ()
        return (PIPE_AXIS,) + (tuple(path_spec(path)) if tp else ())
    return spec(split, ())


def _same_structure(a, b) -> bool:
    if isinstance(a, dict) != isinstance(b, dict):
        return False
    if not isinstance(a, dict):
        return True
    return a.keys() == b.keys() and all(_same_structure(a[k], b[k])
                                        for k in a)


def map_param_subtrees(tree: Any, template_params: Any, fn) -> Any:
    """``fn`` applied to every subtree of ``tree`` shaped as the param tree
    ``template_params`` (its dicts' keys, level by level), the JAX function
    for optimizer states; other nodes are walked (dicts, lists, tuples,
    named tuples) or left as they are. The port's optimizer state is flat
    (``ShardedState.local_opt_state`` cuts it); this serves trees."""
    def rec(node):
        if isinstance(node, dict) and _same_structure(node, template_params):
            return fn(node)
        if hasattr(node, "_fields"):
            return type(node)(*(rec(getattr(node, f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(rec(c) for c in node)
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return node
    return rec(tree)


# -- the schedule -------------------------------------------------------------

class _GPipe(torch.autograd.Function):
    """``apply(axis, blocks, remat, x, *params)`` -> the stack's output on
    every pipe rank. The stage's parameters are inputs so that the call is
    recorded; their gradients reach ``.grad`` inside ``backward``, which
    returns none for them."""

    @staticmethod
    def forward(ctx, axis, blocks, remat, x, *params):
        ctx.axis, ctx.n_params = axis, len(params)
        with torch.enable_grad():
            out, ctx.saved = axis.forward_schedule(x, blocks, remat, True)
        return out

    @staticmethod
    def backward(ctx, g):
        gx = ctx.axis.backward_schedule(ctx.saved, g)
        ctx.saved = None
        return (None, None, None, gx) + (None,) * ctx.n_params


class PipeAxis:
    """This rank's stage on the ``"pipe"`` axis: the blocks ``[lo, hi)``
    it holds and the GPipe schedule (module docstring). ``n_micro``: the
    microbatches of a local batch, which must divide it."""

    def __init__(self, mesh: Mesh, lo: int, hi: int, n_micro: int):
        self.mesh = mesh
        self.size = mesh.axis_size(PIPE_AXIS)
        self.stage = mesh.axis_rank(PIPE_AXIS)
        self.lo, self.hi = lo, hi
        self.n_micro = int(n_micro)

    def _micro(self, batch: int) -> int:
        if batch % self.n_micro:
            raise ValueError(f"local batch {batch} not divisible by "
                             f"n_micro={self.n_micro}")
        return self.n_micro

    def run(self, x: torch.Tensor, blocks: nn.ModuleList,
            remat: bool = False) -> torch.Tensor:
        """The block stack on ``x (B_loc, N, D)``, which every pipe rank
        holds alike; returns the last block's output on every pipe
        rank."""
        mine = [blocks[i] for i in range(self.lo, self.hi)]
        params = [p for b in mine for p in b.parameters()]
        if torch.is_grad_enabled() and (x.requires_grad or any(
                p.requires_grad for p in params)):
            return _GPipe.apply(self, mine, remat, x, *params)
        return self.forward_schedule(x, mine, False, False)[0]

    @staticmethod
    def _apply(x: torch.Tensor, blocks, remat: bool) -> torch.Tensor:
        for blk in blocks:
            if remat and torch.is_grad_enabled() and not blk.runs_fused:
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        return x

    def forward_schedule(self, x: torch.Tensor, blocks, remat: bool,
                         record: bool):
        """The forward ticks: the stack's output on every pipe rank and,
        with ``record``, each microbatch's (input, output) of this stage
        for ``backward_schedule``."""
        M, S, s = self._micro(x.shape[0]), self.size, self.stage
        xm = x.detach().chunk(M)
        outs, saved, sends = [None] * M, [None] * M, []
        for t in range(M + S - 1):
            m = t - s
            if not 0 <= m < M:
                continue
            inp = xm[m] if s == 0 else self.mesh.recv(xm[0], PIPE_AXIS,
                                                      s - 1)
            if record:
                inp = inp.detach().requires_grad_()
            y = self._apply(inp, blocks, remat)
            if record:
                saved[m] = (inp, y)
            if s < S - 1:
                sends.append((self.mesh.isend(y, PIPE_AXIS, s + 1), y))
            else:
                outs[m] = y.detach()
        for work, _ in sends:
            work.wait()
        out = (torch.cat(outs) if s == S - 1
               else torch.empty_like(x, memory_format=torch.contiguous_format))
        self.mesh.broadcast_(out, S - 1, PIPE_AXIS)
        return out, saved

    def backward_schedule(self, saved, g: torch.Tensor) -> torch.Tensor:
        """The reverse ticks from the output gradient ``g``: the block
        gradients accumulated into their ``.grad``; returns the stack's
        input gradient on every pipe rank."""
        M, S, s = len(saved), self.size, self.stage
        gm = g.chunk(M)
        gin, sends = [None] * M, []
        for t in reversed(range(M + S - 1)):
            m = t - s
            if not 0 <= m < M:
                continue
            inp, y = saved[m]
            gy = gm[m] if s == S - 1 else self.mesh.recv(y, PIPE_AXIS, s + 1)
            torch.autograd.backward(y, gy)
            saved[m] = None
            if s > 0:
                sends.append((self.mesh.isend(inp.grad, PIPE_AXIS, s - 1),
                              inp.grad))
            else:
                gin[m] = inp.grad
        for work, _ in sends:
            work.wait()
        gx = (torch.cat(gin) if s == 0
              else torch.empty_like(g, memory_format=torch.contiguous_format))
        return self.mesh.broadcast_(gx, 0, PIPE_AXIS)


# -- the wrapper --------------------------------------------------------------

class Pipeline(ShardedModel):
    """A ``RoViTKAN`` pipelined over the mesh's ``"pipe"`` axis: this
    rank's stage keeps its blocks' weights, the other stages' blocks are
    emptied, and the trunk gets the ``PipeAxis`` (module docstring). The
    model's interface is ``TensorParallel``'s (``parallel/tensor.py``), the
    whole-state conversions its own (``local``, ``gather_full``,
    ``full_module``): it stands where the model stands in the train and
    eval steps and the optimizer; ``model_sharded`` names the stage's
    block leaves (the flat AdamW sums their squares over ``"pipe"``);
    ``specs`` gives each block leaf a dim for ``fsdp.sharded_size`` (a
    stage holds 1/S of the blocks).

    On the 3-D ``("data", "pipe", "model")`` mesh the stage's blocks are
    also Megatron-sharded on the rank's model index (``tp_specs``: qkv and
    fc1 by column, proj and fc2 by row, as ``TensorParallel`` cuts them),
    and each block runs ``Block._tp_forward`` with the mesh's
    ``ModelAxis``: the activations the stages send are whole on both model
    ranks of a stage. ``leaf_axes`` then puts a cut leaf on ``"pipe"`` and
    ``"model"`` and the stage's other block leaves on ``"pipe"``. Refuses a
    mesh without the axis, a depth the axis does not divide, MoE blocks
    (the stages need identical blocks, as the JAX stage scan does) and a
    width the model axis does not divide."""

    shard_axis = PIPE_AXIS

    def __init__(self, model: nn.Module, mesh: Mesh, n_micro: int = 4):
        if PIPE_AXIS not in mesh.axis_names:
            raise ValueError(f"the pipeline needs a 'pipe' axis on the mesh "
                             f"(got {mesh.axis_names})")
        vit = model.backbone.model
        depth, S = len(vit.blocks), mesh.axis_size(PIPE_AXIS)
        if depth % S:
            raise ValueError(f"depth {depth} not divisible by pipe={S}")
        if any(hasattr(b, "moe") for b in vit.blocks):
            raise ValueError("MoE blocks do not compose with the pipeline: "
                             "the stages need identical blocks, and MoE "
                             "blocks differ")
        self.model, self.mesh = model, mesh
        self.per, self.stage = depth // S, mesh.axis_rank(PIPE_AXIS)
        self._all = dict(model.named_parameters())
        self.full_shapes = {k: tuple(p.shape) for k, p in self._all.items()}
        self.device = next(model.parameters()).device
        self._suffixes = [k for k, _ in vit.blocks[0].named_parameters()]
        self.block_leaves = frozenset(k for k in self._all
                                      if k.startswith(BLOCKS))
        self.model_sharded = frozenset(self.stage_names(self.stage))
        self.partial = frozenset()
        self.specs = {k: (0 if k in self.block_leaves else None)
                      for k in self._all}
        #: The block leaves cut over "model" -> the dim (3-D mesh).
        self.tp_specs: Dict[str, int] = {}
        self.model_axis = None
        if mesh.axis_size(MODEL_AXIS) > 1:
            self.tp_specs = {k: d for k, d in
                             megatron_specs(model, mesh).items()
                             if d is not None}
            self.model_axis = ModelAxis(mesh, False, vit.pos_embed.shape[1])
        self._params = {k: p for k, p in self._all.items()
                        if k not in self.block_leaves
                        or k in self.model_sharded}
        with torch.no_grad():
            for k in self.block_leaves - self.model_sharded:
                self._all[k].data = self._all[k].data.new_empty(0)
            cut = self.local({k: self._all[k].data for k in self.tp_specs
                              if k in self.model_sharded})
            for k, t in cut.items():
                self._all[k].data = t.clone()
        self.axis = PipeAxis(mesh, self.stage * self.per,
                             (self.stage + 1) * self.per, n_micro)
        self._attach(self.axis)

    @property
    def leaf_axes(self) -> Dict[str, Tuple[str, ...]]:
        """Every block leaf's axes: ``"pipe"``, and ``"model"`` where the
        3-D mesh cuts it."""
        return {k: ((PIPE_AXIS, MODEL_AXIS) if k in self.tp_specs
                    else (PIPE_AXIS,)) for k in self.block_leaves}

    def stage_names(self, stage: int) -> List[str]:
        """Stage ``stage``'s block leaves, block by block in the model's
        order."""
        return [f"{BLOCKS}{i}.{suffix}"
                for i in range(stage * self.per, (stage + 1) * self.per)
                for suffix in self._suffixes]

    def _attach(self, axis: Optional[PipeAxis]) -> None:
        vit = self.model.backbone.model
        vit.pipe = axis
        for blk in vit.blocks:
            blk.tp = self.model_axis if axis is not None else None
            blk._kernel_params = blk._kernel_key = None

    # -- whole tensors -----------------------------------------------------
    def local(self, full: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """This rank's tensors of a whole state_dict: its stage's, cut on
        its model index where the 3-D mesh shards them (no collective)."""
        t, m = self.mesh.axis_size(MODEL_AXIS), self.mesh.axis_rank(
            MODEL_AXIS)
        return {k: (v.chunk(t, self.tp_specs[k])[m] if k in self.tp_specs
                    else v) for k, v in full.items() if k in self._params}

    def _all_blocks(self, state: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Every stage's block tensors on every pipe rank, from each
        stage's ``state``: the model-cut leaves gathered over ``"model"``,
        then one all-gather over ``"pipe"`` of the stages' flattened blocks
        (collective)."""
        mine = self.stage_names(self.stage)
        sizes = [int(torch.Size(self.full_shapes[k]).numel()) for k in mine]
        parts = []
        for k in mine:
            v = state[k].to(self.device)
            if k in self.tp_specs:
                v = self.mesh.all_gather(v, self.tp_specs[k], MODEL_AXIS)
            parts.append(v.reshape(-1))
        every = self.mesh.all_gather(torch.cat(parts), 0, PIPE_AXIS)
        out = {}
        for j, part in enumerate(every.chunk(
                self.mesh.axis_size(PIPE_AXIS))):
            for k, t in zip(self.stage_names(j), torch.split(part, sizes)):
                out[k] = t.view(self.full_shapes[k])
        return out

    @torch.no_grad()
    def gather_full(self, state: Optional[Dict[str, torch.Tensor]]
                    ) -> Optional[Dict[str, torch.Tensor]]:
        """A stage-level state_dict whole, in the model's order, on the host
        of rank 0; None on the other ranks. Every rank must call it."""
        if state is None:
            return None
        blocks = self._all_blocks(state)
        if self.mesh.global_rank != 0:
            return None
        return {k: (blocks[k] if k in blocks else state[k])
                .detach().to("cpu", copy=True) for k in self.full_shapes}

    @contextlib.contextmanager
    def full_module(self, weights: Optional[Dict[str, torch.Tensor]] = None,
                    keep: bool = False):
        """The model whole meanwhile, every block on every pipe rank, whole
        on the model axis, and the stack run block after block: the stages'
        blocks gathered (from ``weights``, a ``state_dict``-layout dict of
        the rank, where given; the live ones else) and each whole leaf from
        ``weights`` where given. With ``keep``, the rank's part of the
        blocks at the exit becomes the live one (and the whole leaves stay
        as they were left). At the exit the module is pipelined again, its
        fused blocks' weight caches cleared."""
        src = self.state_dict() if weights is None else weights
        blocks = self._all_blocks(src)
        kept = {}
        try:
            for k, p in self._all.items():
                kept[k] = p.data
                if k in self.block_leaves:
                    p.data = blocks[k].clone()
                elif weights is not None:
                    p.data = weights[k].to(self.device, copy=True)
            self._attach(None)
            yield self.model
            if keep:
                with torch.no_grad():
                    mine = self.local({k: self._all[k].data
                                       for k in self.model_sharded})
                    for k, v in mine.items():
                        kept[k].copy_(v)
        finally:
            for k, p in self._all.items():
                p.data = kept[k]
            self._attach(self.axis)
