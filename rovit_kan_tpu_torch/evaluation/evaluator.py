"""Rebuilding a trained model from a checkpoint.

Counterpart of ``rovit_kan_tpu/evaluation/evaluator.py::
load_model_for_evaluation``; the ``Evaluator`` itself is not ported yet.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.convert import transfer_resolution
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN, build_model
from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint


def load_model_for_evaluation(checkpoint_path,
                              config: Optional[Config] = None,
                              image_size: Optional[int] = None,
                              use_ema: bool = True, device="cuda",
                              **model_kwargs
                              ) -> Tuple[RoViTKAN, Dict[str, torch.Tensor]]:
    """Rebuild the model from a checkpoint in eval mode on ``device`` and
    return ``(model, state_dict)``.

    The architecture comes from the config stored in the checkpoint's
    sidecar when there is one, else from ``config``. With an EMA in the
    checkpoint, its weights are loaded (the trainer validated and picked the
    best epoch with them) unless ``use_ema=False``. ``image_size`` serves at
    another resolution than the checkpoint was trained at: the position
    embedding is resampled by ``transfer_resolution``."""
    ck = load_checkpoint(checkpoint_path)
    if ck.get("config"):
        config = Config.from_dict(ck["config"])
    elif config is None:
        raise ValueError("checkpoint has no embedded config; pass one")
    state = (ck["ema_params"] if use_ema and ck.get("ema_params") is not None
             else ck["params"])
    if image_size is not None and image_size != config.data.image_size:
        config = copy.deepcopy(config)     # never mutate a caller's config
        config.data.image_size = image_size
        state = transfer_resolution(state, image_size,
                                    config.model.patch_size)
    model = build_model(config, **{"inference": True, "device": device,
                                   **model_kwargs})
    model.load_state_dict(state)
    return model, state
