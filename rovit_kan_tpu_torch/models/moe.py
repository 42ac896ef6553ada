"""Mixture-of-Experts MLP with expert-choice routing (opt-in).

Counterpart of ``rovit_kan_tpu/models/moe.py``. Each expert takes its top-C
tokens of the gate's probabilities, so every expert is full by construction
and no balancing loss is needed; the flagship stays dense
(``ModelConfig.moe_experts = 0``).

- **Routing** runs in fp32 on the fp32 input, whatever the compute dtype.
  Each expert's C tokens are the first C of a stable descending sort of its
  scores, which is the set ``jax.lax.top_k`` picks: on a tie the lower
  token index wins (``torch.topk`` makes no such promise, and with one
  expert every probability is 1.0).
- **Dispatch and combine are one-hot batched matmuls**, as in the JAX
  module, not ``index_add_``: the card's atomics would give other bits on a
  repeated call, in remat's recompute and in the backward.
- **The expert FFN** takes its operands in ``dtype`` and sums in fp32 (the
  JAX einsums' ``preferred_element_type``): the operands are rounded to
  ``dtype`` and multiplied in fp32, as ``models/vit.py``'s plain attention
  does; ``b1`` and ``b2`` are added in fp32 and the output is cast to
  ``dtype``.
- **Parameters**: ``gate`` is a bias-free ``Linear(D, E)``, whose ``weight
  (E, D)`` is the JAX ``gate/kernel (D, E)`` transposed; ``w1 (E, D, H)``,
  ``b1 (E, H)``, ``w2 (E, H, D)`` and ``b2 (E, D)`` are the JAX leaves as
  they are. Tokens no expert picks get zero, and the residual stream
  carries them.
- **Sequence-parallel filler** (``n_valid``, ``models/vit.py``): tokens at
  ``n_valid`` and after score ``-inf`` in the gate and the capacity comes
  from ``n_valid``, so a filler token never takes a slot and the real
  tokens' outputs do not depend on the padding.
- **Expert parallelism** (``parallel/tensor.py::ExpertParallel`` sets
  ``ep``, an ``ExpertAxis``): rank r of ep on the ``"expert"`` axis holds
  experts ``[r*E/ep, (r+1)*E/ep)`` of ``w1``, ``b1``, ``w2``, ``b2``, and
  the gate whole. The batch is sharded over ``"data"`` only, so the expert
  ranks of one data index see the same rows and route them alike with the
  whole gate (the JAX layout under ``P("expert")`` weights). Each rank
  dispatches to, runs and combines its own experts into an fp32 partial of
  ``(B, S, D)``; the partials are summed over ``"expert"`` and rounded to
  ``dtype`` once, the one-process rounding point. ``x`` and the gate
  weight enter through ``ExpertAxis.input``, whose backward sums their
  gradients over ``"expert"``: a rank's experts see only their slots, so
  each rank's gradient of them is a partial.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def expert_capacity(num_tokens: int, num_experts: int,
                    capacity_factor: float) -> int:
    """Tokens each expert processes: ceil(S * cf / E), clipped to [1, S]."""
    c = math.ceil(num_tokens * capacity_factor / num_experts)
    return max(1, min(c, num_tokens))


def route(x: torch.Tensor, gate_weight: torch.Tensor, capacity: int,
          n_valid: Optional[int] = None):
    """The expert-choice routing of ``x (B, S, D)``: each expert's chosen
    token indices ``(B, E, C)`` and their fp32 gate probabilities; tokens
    at ``n_valid`` and after are never chosen."""
    probs = torch.softmax(F.linear(x.float(), gate_weight.float()), dim=-1)
    scores = probs.transpose(1, 2)                       # (B, E, S)
    S = scores.shape[-1]
    if n_valid is not None and n_valid < S:
        valid = torch.arange(S, device=scores.device) < n_valid
        scores = scores.masked_fill(~valid, float("-inf"))
    idx = torch.sort(scores, dim=-1, descending=True,
                     stable=True).indices[..., :capacity]
    return idx, torch.gather(scores, -1, idx)


class MoEMlp(nn.Module):
    """Expert-choice MoE FFN in place of ``vit.Mlp`` (``x`` is the block's
    fp32 ``norm2`` output). Routing never mixes batch rows. With one expert
    and ``capacity_factor >= 1`` (C = S) it is the dense ``Mlp`` with
    expert 0's weights."""

    def __init__(self, dim: int = 192, hidden: int = 768,
                 num_experts: int = 8, capacity_factor: float = 2.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.gate = nn.Linear(dim, num_experts, bias=False)
        self.w1 = nn.Parameter(torch.zeros(num_experts, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(num_experts, hidden))
        self.w2 = nn.Parameter(torch.zeros(num_experts, hidden, dim))
        self.b2 = nn.Parameter(torch.zeros(num_experts, dim))
        #: The expert axis under expert parallelism (``w1`` .. ``b2`` then
        #: hold this rank's experts).
        self.ep = None

    def forward(self, x: torch.Tensor,
                n_valid: Optional[int] = None) -> torch.Tensor:
        B, S, D = x.shape
        E, dt, ep = self.num_experts, self.dtype, self.ep
        C = expert_capacity(S if n_valid is None else n_valid, E,
                            self.capacity_factor)
        gate = self.gate.weight
        if ep is not None:
            x, gate = ep.input(x), ep.input(gate)
        idx, w = route(x, gate, C, n_valid)
        if ep is not None:
            # This rank's experts: their slots of the whole routing.
            lo, hi = ep.experts(E)
            idx, w, E = idx[:, lo:hi], w[:, lo:hi], hi - lo
        disp = F.one_hot(idx, S).to(dt).reshape(B, E * C, S)
        xin = torch.bmm(disp, x.to(dt)).reshape(B, E, C, D)
        h = torch.einsum("becd,edh->bech", xin.float(),
                         self.w1.to(dt).float())
        h = F.gelu(h + self.b1[None, :, None, :])      # exact erf GELU
        out = torch.einsum("bech,ehd->becd", h.to(dt).float(),
                           self.w2.to(dt).float())
        out = (out + self.b2[None, :, None, :]) * w[..., None]
        # Token s sums every expert slot that chose it.
        y = torch.bmm(disp.float().transpose(1, 2),
                      out.reshape(B, E * C, D))
        if ep is not None:
            y = ep.combine(y)          # the fp32 partials summed
        return y.to(dt)
