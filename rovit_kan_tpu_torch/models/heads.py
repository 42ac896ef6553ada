"""Task heads on the CLS embedding, fp32.

Counterpart of ``rovit_kan_tpu/models/heads.py``: Linear -> ReLU -> Dropout
-> Linear for the classification (K logits) and ordinal (K-1 cumulative
logits) heads, and a shared trunk with ``fc_mu`` / ``fc_logvar`` for the
uncertainty head, ``log_var`` clipped to [-10, 10]. Dropout is the identity
in eval mode. Key names are the reference's ``fc1`` / ``fc2`` / ``fc_mu`` /
``fc_logvar``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class ClassificationHead(nn.Module):
    def __init__(self, in_dim: int = 192, hidden_dim: int = 128,
                 num_classes: int = 4, dropout: float = 0.3):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.dropout = nn.Dropout(dropout)
        self.fc2 = nn.Linear(hidden_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.dropout(F.relu(self.fc1(x))))


class OrdinalHead(ClassificationHead):
    def __init__(self, in_dim: int = 192, hidden_dim: int = 128,
                 num_classes: int = 4, dropout: float = 0.3):
        super().__init__(in_dim, hidden_dim, num_classes - 1, dropout)


class UncertaintyHead(nn.Module):
    def __init__(self, in_dim: int = 192, hidden_dim: int = 128,
                 dropout: float = 0.3):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.dropout = nn.Dropout(dropout)
        self.fc_mu = nn.Linear(hidden_dim, 1)
        self.fc_logvar = nn.Linear(hidden_dim, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.dropout(F.relu(self.fc1(x)))
        return self.fc_mu(x), torch.clamp(self.fc_logvar(x), -10.0, 10.0)
