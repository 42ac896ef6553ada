"""Task heads on the CLS embedding, fp32.

Counterpart of ``rovit_kan_tpu/models/heads.py``: Linear -> ReLU -> Dropout
-> Linear for the classification (K logits) and ordinal (K-1 cumulative
logits) heads, and a shared trunk with ``fc_mu`` / ``fc_logvar`` for the
uncertainty head, ``log_var`` clipped to [-10, 10]. Key names are the
reference's ``fc1`` / ``fc2`` / ``fc_mu`` / ``fc_logvar``.

Dropout draws its mask from the ``torch.Generator`` passed down through the
forward (the global RNG when it is None), so a training step's draws are
reproducible; it is the identity in eval mode and when p = 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout with a mask ``rand(generator) >= p``."""
    if not training or p == 0.0:
        return x
    mask = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * mask / (1.0 - p)


class ClassificationHead(nn.Module):
    def __init__(self, in_dim: int = 192, hidden_dim: int = 128,
                 num_classes: int = 4, dropout: float = 0.3):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.p = dropout
        self.fc2 = nn.Linear(hidden_dim, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(F.relu(self.fc1(x)), self.p, self.training, generator)
        return self.fc2(x)


class OrdinalHead(ClassificationHead):
    def __init__(self, in_dim: int = 192, hidden_dim: int = 128,
                 num_classes: int = 4, dropout: float = 0.3):
        super().__init__(in_dim, hidden_dim, num_classes - 1, dropout)


class UncertaintyHead(nn.Module):
    def __init__(self, in_dim: int = 192, hidden_dim: int = 128,
                 dropout: float = 0.3):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.p = dropout
        self.fc_mu = nn.Linear(hidden_dim, 1)
        self.fc_logvar = nn.Linear(hidden_dim, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = dropout(F.relu(self.fc1(x)), self.p, self.training, generator)
        return self.fc_mu(x), torch.clamp(self.fc_logvar(x), -10.0, 10.0)
