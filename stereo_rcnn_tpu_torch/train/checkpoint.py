"""Checkpoints of the training state, and the params-only export.

Port of ``stereo_rcnn_tpu.train.checkpoint`` (orbax there, ``torch.save``
here).  A checkpoint is one file ``<ckpt_dir>/ckpt_<step>.pt`` holding the
:class:`~stereo_rcnn_tpu_torch.train.step.TrainState`: ``step``, the
model's ``state_dict`` (upstream names), ``uncert`` and the optimizer's
momentum ``trace``; the newest ``max_to_keep`` are kept.  The params
export (``<export_dir>/params.pt``) is the model's ``state_dict`` alone,
for inference consumers.  Every file is written under a private name and
renamed into place, so a run stopped during a save (SIGTERM, a kill)
leaves the previous checkpoint as the latest, never a truncated one.
Files are read with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

from stereo_rcnn_tpu_torch.config import Config
from stereo_rcnn_tpu_torch.device import resolve_device
from stereo_rcnn_tpu_torch.models.detector import build_model
from stereo_rcnn_tpu_torch.train.losses import LOSS_NAMES
from stereo_rcnn_tpu_torch.train.step import TrainState, trainable_params

_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")
PARAMS_FILE = "params.pt"


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _cpu_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match,
                                               os.listdir(ckpt_dir)) if m)


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step}.pt")


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    max_to_keep: int = 5) -> None:
    """Save ``state`` at its step, then delete all but the newest
    ``max_to_keep`` checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _atomic_save({"step": int(state.step),
                  "model": _cpu_state_dict(state.model),
                  "uncert": state.uncert.detach().cpu(),
                  "trace": {k: v.detach().cpu()
                            for k, v in state.trace.items()}},
                 checkpoint_path(ckpt_dir, int(state.step)))
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(checkpoint_path(ckpt_dir, old))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, template: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Restore into ``template`` (from ``init_train_state`` of the same
    config): its model is loaded in place (``strict=True``), the other
    fields come back on its device.  Raises on a mismatched tree."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    ck = torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu",
                    weights_only=True)
    template.model.load_state_dict(ck["model"], strict=True)
    names = set(trainable_params(template))
    unknown = sorted(set(ck["trace"]) - names)
    if unknown:
        raise KeyError(f"checkpoint momentum for unknown parameters "
                       f"{unknown[:5]}")
    dev = template.uncert.device
    if ck["uncert"].shape != template.uncert.shape:
        raise ValueError(f"uncert {tuple(ck['uncert'].shape)} != "
                         f"{tuple(template.uncert.shape)}")
    return TrainState(
        step=int(ck["step"]), model=template.model,
        uncert=ck["uncert"].to(dev).requires_grad_(True),
        trace={k: v.to(dev) for k, v in ck["trace"].items()})


def restore_train_state(ckpt_dir: str, cfg: Config,
                        device: torch.device | str | None = None,
                        step: Optional[int] = None) -> TrainState:
    """:func:`restore_checkpoint` into a template of ``cfg`` built on
    ``device`` (default: the CUDA card) without drawing random weights:
    every tensor comes from the checkpoint."""
    device = resolve_device(device)
    template = TrainState(
        step=0, model=build_model(cfg).to(device).train(),
        uncert=torch.zeros(len(LOSS_NAMES), device=device), trace={})
    return restore_checkpoint(ckpt_dir, template, step)


def export_params(export_dir: str, model: torch.nn.Module) -> None:
    """Save the model's ``state_dict`` alone (no optimizer state, no
    uncertainty weights) for inference consumers."""
    os.makedirs(export_dir, exist_ok=True)
    _atomic_save(_cpu_state_dict(model), os.path.join(export_dir,
                                                      PARAMS_FILE))


def restore_params(export_dir: str, template: torch.nn.Module
                   ) -> torch.nn.Module:
    """Load a params export into ``template`` (``strict=True``): raises if
    the stored tree does not match it (names or shapes)."""
    sd = torch.load(os.path.join(export_dir, PARAMS_FILE),
                    map_location="cpu", weights_only=True)
    template.load_state_dict(sd, strict=True)
    return template
