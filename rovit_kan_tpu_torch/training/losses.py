"""Multi-task losses, computed in fp32.

Counterpart of ``rovit_kan_tpu/training/losses.py``. The curriculum enters as
a 0/1 mask per term, ``(stage >= n) * head_present``, so one function serves
every stage; a head that the model lacks contributes exactly 0. Every loss
reduces by the batch mean, or by the mean over the rows that ``valid`` marks.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def focal_loss_per_example(logits: torch.Tensor, targets: torch.Tensor,
                           gamma: float = 2.0,
                           alpha: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Unreduced focal loss ``alpha_t * (1 - p_t)^gamma * CE``."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    ce = -log_probs.gather(-1, targets.long()[:, None])[:, 0]
    pt = torch.exp(-ce)
    focal = (1.0 - pt) ** gamma * ce
    if alpha is not None:
        focal = alpha[targets.long()] * focal
    return focal


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 2.0,
               alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-mean focal loss; ``alpha`` is an optional ``(K,)`` per-class
    weight."""
    return focal_loss_per_example(logits, targets, gamma, alpha).mean()


def _masked_mean(per_example: torch.Tensor,
                 valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Batch mean, or the mean over the rows ``valid`` (0/1) marks."""
    if valid is None:
        return per_example.mean()
    return (per_example * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def ordinal_bce_per_example(cum_logits: torch.Tensor,
                            targets: torch.Tensor) -> torch.Tensor:
    """Per-example BCE over the K-1 cumulative thresholds, targets
    ``[y > k]``, in the numerically stable with-logits form."""
    cum_logits = cum_logits.float()
    ks = torch.arange(cum_logits.shape[-1], device=cum_logits.device)
    binary = (targets[:, None] > ks[None, :]).float()
    bce = (torch.clamp(cum_logits, min=0.0) - cum_logits * binary
           + torch.log1p(torch.exp(-cum_logits.abs())))
    return bce.mean(dim=-1)


def ordinal_bce_loss(cum_logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    return ordinal_bce_per_example(cum_logits, targets).mean()


def _column(targets: torch.Tensor) -> torch.Tensor:
    return targets[:, None].float() if targets.dim() == 1 else targets


def uncertainty_per_example(mu: torch.Tensor, log_var: torch.Tensor,
                            targets: torch.Tensor) -> torch.Tensor:
    """Heteroscedastic Gaussian NLL
    ``0.5 * ((t - mu)^2 * exp(-log_var) + log_var)``, mean over the last
    axis."""
    recon = (_column(targets) - mu) ** 2 * torch.exp(-log_var)
    return (0.5 * (recon + log_var)).mean(dim=-1)


def uncertainty_loss(mu: torch.Tensor, log_var: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    return uncertainty_per_example(mu, log_var, targets).mean()


def kan_regression_per_example(predictions: torch.Tensor,
                               targets: torch.Tensor) -> torch.Tensor:
    """Squared error of the KAN severity against the severity label."""
    return ((predictions - _column(targets)) ** 2).mean(dim=-1)


def kan_regression_loss(predictions: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    return kan_regression_per_example(predictions, targets).mean()


def joint_loss(outputs: Dict[str, torch.Tensor], class_targets: torch.Tensor,
               severity_targets: torch.Tensor, stage, *,
               lambda_ord: float = 1.0, mu_unc: float = 0.5,
               nu_kan: float = 0.5, focal_gamma: float = 2.0,
               focal_alpha: Optional[torch.Tensor] = None,
               head_mask: Optional[Dict[str, bool]] = None,
               mixup: Optional[Dict[str, torch.Tensor]] = None,
               valid: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """Stage-masked ``L = L_cls + l*L_ord + m*L_unc + n*L_kan``.

    Args:
        stage: int (or 0-dim tensor) in [1, 4].
        head_mask: presence flags of the ordinal, uncertainty and KAN heads.
        mixup: optional ``labels_a``, ``labels_b``, ``lam``: the
            classification term becomes ``lam * L(a) + (1 - lam) * L(b)``;
            severity targets stay unmixed.
        valid: optional 0/1 per example (padded batches).

    Returns:
        ``cls_loss``, ``ord_loss``, ``unc_loss``, ``kan_loss``,
        ``total_loss``, each a 0-dim fp32 tensor.
    """
    head_mask = head_mask or {"ordinal": True, "uncertainty": True,
                              "kan": True}
    logits = outputs["cls_logits"]
    if mixup is not None:
        la = focal_loss_per_example(logits, mixup["labels_a"], focal_gamma,
                                    focal_alpha)
        lb = focal_loss_per_example(logits, mixup["labels_b"], focal_gamma,
                                    focal_alpha)
        lam = mixup["lam"]
        cls = _masked_mean(lam * la + (1.0 - lam) * lb, valid)
    else:
        cls = _masked_mean(focal_loss_per_example(
            logits, class_targets, focal_gamma, focal_alpha), valid)

    # A Python stage stays on the host (no copy to the device per step).
    on = ((lambda n: (stage >= n).float()) if torch.is_tensor(stage)
          else (lambda n: float(stage >= n)))
    m_ord = on(2) * float(head_mask["ordinal"])
    m_unc = on(3) * float(head_mask["uncertainty"])
    m_kan = on(4) * float(head_mask["kan"])

    ord_l = m_ord * _masked_mean(ordinal_bce_per_example(
        outputs["ordinal_logits"], severity_targets), valid)
    unc_l = m_unc * _masked_mean(uncertainty_per_example(
        outputs["mu"], outputs["log_var"], severity_targets), valid)
    kan_l = m_kan * _masked_mean(kan_regression_per_example(
        outputs["kan_severity"], severity_targets), valid)

    total = cls + lambda_ord * ord_l + mu_unc * unc_l + nu_kan * kan_l
    return {"cls_loss": cls, "ord_loss": ord_l, "unc_loss": unc_l,
            "kan_loss": kan_l, "total_loss": total}
