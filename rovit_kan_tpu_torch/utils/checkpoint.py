"""Checkpoints of the train state and their JSON metadata sidecar.

Counterpart of ``rovit_kan_tpu/utils/checkpoint.py``, in the port's own
format (orbax needs JAX): a checkpoint is a directory holding ``model.pt``,
a ``torch.save`` of

- ``model_state_dict``: the model's parameters under the reference's key
  names, the patch embedding in the reference's convolution layout
  ``(D, 3, p, p)``, i.e. the state_dict the reference trainer writes, which
  the JAX package's ``convert_reference_checkpoint`` reads;
- ``optimizer_state_dict`` (optional): the flat AdamW's state
  (``FlatAdamW.state_dict``);
- ``ema_state_dict`` (optional): the EMA of the parameters, laid out as
  ``model_state_dict``; what evaluation uses when present.

Beside it, ``<name>.meta.json`` holds the epoch, the best validation loss,
the early-stopping counter, the metrics and the config, with the JAX
package's keys and path scheme.

Durability, as in the JAX package: a save writes a temporary directory,
renames it (atomically) to the staging name ``<name>.next`` with its
sidecar, and only then swaps the stage into the final name, so the last
committed checkpoint survives the whole write. ``block=False`` copies the
tensors to the host and returns; a background thread writes, and
``wait_for_checkpoints`` (or the next save or load) joins it and finishes
the swap. ``promote_staging`` adopts a committed stage left by a crash.

Under a process group (``parallel.multihost``), as the JAX package does:
every rank calls the same functions in the same order, rank 0 alone
writes, stages, promotes and deletes, and every rank waits at a barrier
before it acts on the directory. Rank 0's background writer is joined
before that barrier.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from rovit_kan_tpu_torch.parallel.multihost import barrier, process_index

_STAGE_SUFFIX = ".next"
_TMP_SUFFIX = ".tmp"
_FILE = "model.pt"
_PATCH_KEY = "backbone.model.patch_embed.proj.weight"

# final-path str -> staging Path, for saves whose swap is outstanding.
_PENDING: Dict[str, Path] = {}
# The background writer of a block=False save and the error it raised.
_WRITER: Dict[str, Any] = {"thread": None, "error": None}


def _writer() -> bool:
    """Whether this process touches the checkpoint directory (rank 0)."""
    return process_index() == 0


def _stage_for(path: Path) -> Path:
    return path.with_name(path.name + _STAGE_SUFFIX)


def _meta_for(path: Path) -> Path:
    return path.parent / (path.name + ".meta.json")


def _to_reference(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's state_dict with the patch embedding in the reference's
    convolution layout: the port flattens each patch in (row, col, channel)
    order, ``(D, p * p * 3)`` -> ``(D, 3, p, p)``."""
    out = dict(sd)
    w = sd.get(_PATCH_KEY)
    if w is not None and w.dim() == 2:
        p = int(round((w.shape[1] // 3) ** 0.5))
        out[_PATCH_KEY] = w.reshape(w.shape[0], p, p, 3).permute(
            0, 3, 1, 2).contiguous()
    return out


def patch_weight_from_conv(w: torch.Tensor) -> torch.Tensor:
    """A patch-embedding convolution weight ``(D, C, p, p)`` as the port's
    Linear weight ``(D, p * p * C)``, each patch flattened in (row, col,
    channel) order; its transpose is the JAX ``PatchEmbed`` kernel."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()


def _from_reference(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of ``_to_reference``."""
    out = dict(sd)
    w = sd.get(_PATCH_KEY)
    if w is not None and w.dim() == 4:
        out[_PATCH_KEY] = patch_weight_from_conv(w)
    return out


def _swap_into_place(final: Path, stage: Path) -> None:
    """Replace ``final`` with the committed ``stage`` (and its sidecar)."""
    try:
        if final.exists():
            shutil.rmtree(final)
        stage.rename(final)
    except FileNotFoundError:
        return                     # another reader already promoted it
    stage_meta = _meta_for(stage)
    if stage_meta.exists():
        stage_meta.replace(_meta_for(final))


def _join_writer() -> None:
    t = _WRITER["thread"]
    if t is not None:
        t.join()
        _WRITER["thread"] = None
    err, _WRITER["error"] = _WRITER["error"], None
    if err is not None:
        raise RuntimeError("background checkpoint write failed") from err


def _complete_pending() -> None:
    """Swap every committed staging directory into its final name. Call only
    after the writer has been joined."""
    had_pending = bool(_PENDING)
    for final_s in list(_PENDING):
        stage = _PENDING.pop(final_s)
        if _writer() and is_finalized(stage):
            _swap_into_place(Path(final_s), stage)
    if had_pending:
        # No other rank reads (or stages over) the final names before rank
        # 0's swaps have landed.
        barrier()


def wait_for_checkpoints() -> None:
    """Join the in-flight background write (no-op when none) and finish its
    swap, so readers see committed checkpoints under their final names."""
    _join_writer()
    _complete_pending()


def is_finalized(path) -> bool:
    """True iff ``path`` is a committed checkpoint: a directory under its
    name (written elsewhere and renamed, so never a torso) holding the
    checkpoint file."""
    path = Path(path).absolute()
    return path.is_dir() and (path / _FILE).is_file()


def _meta_epoch(path: Path) -> Optional[int]:
    try:
        return int(json.loads(_meta_for(path).read_text())["epoch"])
    except (OSError, ValueError, TypeError, KeyError):
        return None


def promote_staging(path) -> bool:
    """Crash recovery: adopt a committed ``<path>.next`` over ``path``
    (unless the sidecars say the final is newer), or finish a half-swap
    whose sidecar was left behind. Returns whether ``path`` is a committed
    checkpoint afterwards."""
    path = Path(path).absolute()
    stage = _stage_for(path)
    stage_meta = _meta_for(stage)
    if _writer():
        if is_finalized(stage):
            fe, se = _meta_epoch(path), _meta_epoch(stage)
            final_newer = (is_finalized(path) and fe is not None
                           and se is not None and fe > se)
            if not final_newer:
                _swap_into_place(path, stage)
        elif (stage_meta.exists() and not stage.exists()
              and is_finalized(path)):
            stage_meta.replace(_meta_for(path))
    barrier()
    return is_finalized(path)


def discard_staging(path) -> None:
    """Delete ``path``, its ``<path>.next`` staging directory and both
    sidecars (whatever of them exists)."""
    path = Path(path).absolute()
    if _writer():
        for d in (path, _stage_for(path)):
            if d.exists():
                shutil.rmtree(d)
            meta = _meta_for(d)
            if meta.exists():
                meta.unlink()
    barrier()


def _to_jsonable(x):
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    if hasattr(x, "item") and getattr(x, "ndim", None) == 0:
        return x.item()
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return str(x)


def _to_host(tree):
    """A host copy of every tensor in ``tree`` (never a view of a live
    tensor, which training would go on changing)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _write(stage: Path, payload: Dict, meta: Dict) -> None:
    tmp = stage.with_name(stage.name + _TMP_SUFFIX)
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save(payload, tmp / _FILE)
    tmp.rename(stage)
    _meta_for(stage).write_text(json.dumps(meta))


def save_checkpoint(path, params: Dict[str, torch.Tensor],
                    opt_state: Optional[Dict] = None, epoch: int = 0,
                    best_val_loss: float = float("inf"),
                    metrics: Optional[Dict] = None, config: Any = None,
                    ema_params: Optional[Dict[str, torch.Tensor]] = None,
                    epochs_without_improvement: int = 0,
                    block: bool = True) -> None:
    """Save the parameters (a model ``state_dict``), optionally the
    optimizer state and the EMA, and the JSON sidecar.

    ``block=False`` returns once the tensors are copied to the host; the
    write goes on in a background thread (the trainer's best-model saves use
    this). Join with ``wait_for_checkpoints``."""
    path = Path(path).absolute()
    # Join and finish any earlier save first (possibly to this same path):
    # the staging directory must be free, and an earlier committed write
    # must land under its final name before a newer one is staged.
    wait_for_checkpoints()
    stage = _stage_for(path)
    _PENDING[str(path)] = stage
    if not _writer():
        barrier()                 # rank 0 cleans the stage
        if block:
            _complete_pending()
        return
    if stage.exists():
        shutil.rmtree(stage)       # a torso, or a stage about to be replaced
    for torso in path.parent.glob("*" + _STAGE_SUFFIX + _TMP_SUFFIX):
        shutil.rmtree(torso, ignore_errors=True)
    barrier()
    payload = {"model_state_dict": _to_reference(_to_host(params))}
    if opt_state is not None:
        payload["optimizer_state_dict"] = _to_host(opt_state)
    if ema_params is not None:
        payload["ema_state_dict"] = _to_reference(_to_host(ema_params))
    meta = {"epoch": epoch, "best_val_loss": best_val_loss,
            "epochs_without_improvement": epochs_without_improvement,
            "metrics": _to_jsonable(metrics or {})}
    if config is not None:
        meta["config"] = (config.to_dict() if hasattr(config, "to_dict")
                          else _to_jsonable(config))
    if block:
        _write(stage, payload, meta)
        _complete_pending()
        return

    def run():
        try:
            _write(stage, payload, meta)
        except Exception as e:      # re-raised by wait_for_checkpoints
            _WRITER["error"] = e

    _WRITER["thread"] = threading.Thread(target=run, daemon=True)
    _WRITER["thread"].start()


def load_checkpoint(path) -> Dict[str, Any]:
    """Load a checkpoint: ``params`` (the model's state_dict, on the host),
    ``opt_state`` and ``ema_params`` where saved, and the sidecar's keys
    (``epoch``, ``best_val_loss``, ``epochs_without_improvement``,
    ``metrics``, ``config``)."""
    wait_for_checkpoints()
    path = Path(path).absolute()
    promote_staging(path)
    ck = torch.load(path / _FILE, map_location="cpu", weights_only=True)
    tree = {"params": _from_reference(ck["model_state_dict"])}
    if "optimizer_state_dict" in ck:
        tree["opt_state"] = ck["optimizer_state_dict"]
    if "ema_state_dict" in ck:
        tree["ema_params"] = _from_reference(ck["ema_state_dict"])
    meta_path = _meta_for(path)
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return {**tree, **meta}


def load_meta(path) -> Dict[str, Any]:
    """The sidecar alone (``{}`` when there is none), after joining any
    in-flight save and adopting a committed stage."""
    wait_for_checkpoints()
    path = Path(path).absolute()
    promote_staging(path)
    meta_path = _meta_for(path)
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}


def update_meta(path, **fields) -> Dict[str, Any]:
    """Merge ``fields`` into a checkpoint's sidecar (atomic replace), e.g.
    a calibration temperature fitted after training; returns the merged
    dict."""
    path = Path(path).absolute()
    meta = {**load_meta(path), **{k: _to_jsonable(v)
                                  for k, v in fields.items()}}
    if _writer():
        meta_path = _meta_for(path)
        tmp = meta_path.parent / (meta_path.name + ".tmp")
        tmp.write_text(json.dumps(meta))
        tmp.replace(meta_path)
    barrier()
    return meta
