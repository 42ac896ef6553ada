"""Cumulative-link ordinal regression math.

Counterpart of ``rovit_kan_tpu/ops/ordinal.py``: the head emits K-1
cumulative logits ``c_k = sigmoid(logit_k)``, and the class probabilities
are ``c_0``, the adjacent differences, and ``1 - c_{K-2}``.
"""
from __future__ import annotations

import torch


def cumulative_to_class_probs(cum_logits: torch.Tensor) -> torch.Tensor:
    """Convert ``(B, K-1)`` cumulative logits to ``(B, K)`` class probs."""
    c = torch.sigmoid(cum_logits)
    first = c[:, :1]
    middle = c[:, 1:] - c[:, :-1]
    last = 1.0 - c[:, -1:]
    return torch.cat([first, middle, last], dim=-1)


def ordinal_expected_severity(cum_logits: torch.Tensor) -> torch.Tensor:
    """Expected severity ``E[y] = sum_k k * P(y=k)``, shape ``(B, 1)``."""
    probs = cumulative_to_class_probs(cum_logits)
    levels = torch.arange(probs.shape[-1], dtype=probs.dtype,
                          device=probs.device)
    return torch.sum(probs * levels, dim=-1, keepdim=True)
