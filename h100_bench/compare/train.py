"""Training steps of the program against the reference.

A compared step is one ``step_fn`` call of the program at the cell's
batch, recorded whole (:class:`Record`): the state it started from, its
batch and target-sampling uniforms, the proposals it selected, and what
it produced (losses, per-image foreground counts, every trainable
leaf's gradient, the updated weights).  The reference
(``reference/train/step.py``: float32, TF32 off, exact RoIAlign weights,
no remat) repeats the step from the same state, batch and uniforms on
the program's own proposals, so that precision is the only difference
left: with random weights the objectness scores tie, and a step that
selected its own proposals would sample other RoIs than the program's
and differ in every gradient behind them.

The numbers, each the worse of the compared steps:

* ``target_mismatch``: images whose foreground anchor or RoI count
  differs (target assignment and sampling are exact, so 0);
* ``loss_rel``: the worst relative gap over the six losses;
* ``grad_rel_median``, ``grad_rel_p90``: the median and 90th percentile
  over the trainable leaves of ``|g_prog - g_ref| / |g_ref|``, and
  ``grad_rel_max``, the worst leaf's;
* ``update_rel``: ``|dp_prog - dp_ref| / |dp_ref|`` of the whole update
  (every trainable leaf's change, concatenated);
* ``nonfinite_steps`` (``drivers/train_loop.py``): steps of the window
  whose losses or gradient norm are not finite.

Reported beside them: each step's numbers, the worst leaf and its gap,
the gradient norms and the losses of both.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from h100_bench.reference.config import Config
from h100_bench.reference.train.losses import LOSS_NAMES
from h100_bench.reference.train.step import (STEP_FAULTS, Batch,
                                             labels_of, param_label,
                                             reference_step)
from h100_bench.reference.train.targets import Uniforms

#: Faults planted in a step of the reference put in the program's place
#: (``calibrate``): :data:`STEP_FAULTS`, and each step run on the
#: previous step's images (with its own ground truth).
FAULTS = STEP_FAULTS + ("fault_previous_images",)


class Record(NamedTuple):
    """One compared step of the program (tensors on the device)."""

    count: int                          # the step count it started from
    params: Dict[str, torch.Tensor]     # before: state_dict + "uncert"
    trace: Dict[str, torch.Tensor]      # momentum before
    batch: Batch
    uniforms: Uniforms
    proposals: Dict[str, torch.Tensor]  # left, right, valid
    losses: Dict[str, torch.Tensor]     # LOSS_NAMES -> 0-dim
    num_fg_rpn: torch.Tensor            # [B]
    num_fg_rcnn: torch.Tensor           # [B]
    grads: Dict[str, torch.Tensor]
    g_norm: torch.Tensor
    after: Dict[str, torch.Tensor]      # params after the update


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a - b| / |b|`` in float64 (0 where both are 0)."""
    num = float((a.double() - b.double()).norm())
    den = float(b.double().norm())
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def _group(name: str) -> str:
    """A leaf's part of the model: a backbone stage, the FPN, the RPN, a
    head, or the uncertainty weights."""
    segs = name.split(".")
    if segs[0] == "backbone_net":
        return segs[1] if segs[1].startswith("RCNN_layer") else "fpn"
    return segs[0]


def compare_step(cfg: Config, rec: Record, ref) -> Dict[str, object]:
    """One recorded step ``rec`` against the reference's ``ref`` (a
    ``StepResult`` of the same step on the same proposals)."""
    labels = labels_of(cfg)
    mismatch = ((rec.num_fg_rpn.cpu() != ref.num_fg_rpn.cpu()) |
                (rec.num_fg_rcnn.cpu() != ref.num_fg_rcnn.cpu()))
    loss_gap = {}
    for k in LOSS_NAMES:
        p, r = float(rec.losses[k]), float(ref.losses[k])
        loss_gap[k] = (0.0 if p == r else abs(p - r) / abs(r) if r != 0.0
                       else float("inf"))
    leaves = [n for n in rec.params
              if param_label(n, **labels) != "frozen"]
    gaps = {n: _rel(rec.grads.get(n, torch.zeros_like(rec.params[n])),
                    ref.grads[n]) for n in leaves}
    worst = max(gaps, key=gaps.get)
    d_prog = torch.cat([(rec.after[n].double() - rec.params[n].double())
                        .reshape(-1) for n in leaves])
    d_ref = torch.cat([(ref.params[n].double() - rec.params[n].double())
                       .reshape(-1) for n in leaves])
    vals = np.asarray(list(gaps.values()))
    groups: Dict[str, list] = {}
    for n, v in gaps.items():
        groups.setdefault(_group(n), []).append(v)
    return {
        "target_mismatch": float(mismatch.sum()),
        "loss_rel": max(loss_gap.values()),
        "grad_rel_median": float(np.percentile(vals, 50)),
        "grad_rel_p90": float(np.percentile(vals, 90)),
        "update_rel": _rel(d_prog, d_ref),
        "grad_rel_max": gaps[worst], "worst_leaf": worst,
        "leaves": len(leaves),
        "grad_rel_by_group": {g: [float(np.median(v)), float(max(v))]
                              for g, v in groups.items()},
        "loss_gap": loss_gap,
        "losses_prog": {k: float(rec.losses[k]) for k in LOSS_NAMES},
        "losses_ref": {k: float(ref.losses[k]) for k in LOSS_NAMES},
        "g_norm": [float(rec.g_norm), float(ref.g_norm)],
        "num_fg_rpn": rec.num_fg_rpn.cpu().tolist(),
        "num_fg_rcnn": rec.num_fg_rcnn.cpu().tolist(),
    }


#: The compared numbers, each the worse over the compared steps.
CHECKED = ("target_mismatch", "loss_rel", "grad_rel_median", "grad_rel_p90",
           "update_rel")


def _finite(rec: Record) -> bool:
    """Whether the step's proposals and starting weights are finite (the
    reference cannot sample a box that is not)."""
    return all(bool(torch.isfinite(t).all()) for t in
               [rec.proposals["left"], rec.proposals["right"],
                *rec.params.values()])


def check(cfg: Config, records: List[Record], steps_per_epoch: int,
          block: int, flops: Optional[list] = None) -> Dict[str, object]:
    """Every record against the reference's repeat of its step, in
    blocks of ``block`` images; ``flops`` gets the FLOPs of the first
    record's first block (``reference_step``).  A step whose proposals
    or weights are not finite reads inf."""
    steps = []
    for i, rec in enumerate(records):
        if not _finite(rec):
            steps.append({**dict.fromkeys(CHECKED, float("inf")),
                          "grad_rel_max": float("inf"),
                          "worst_leaf": None})
            continue
        ref = reference_step(cfg, rec.params, rec.trace, rec.count,
                             rec.batch, rec.uniforms, steps_per_epoch,
                             proposals=rec.proposals, block=block,
                             flops=flops if i == 0 else None)
        steps.append(compare_step(cfg, rec, ref))
        del ref
    out: Dict[str, object] = {k: max(s[k] for s in steps) for k in CHECKED}
    out["grad_rel_max"] = max(s["grad_rel_max"] for s in steps)
    out["steps"] = steps
    return out
