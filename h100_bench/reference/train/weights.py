"""Weights of a training run, made on the card from the seed.

``reference/weights.py`` draws every kernel with variance ``1 / fan_in``
and the output layers as a trained detector's behave (class and keypoint
kernels at std 3, so that inference decisions rest on clear peaks).  A
training run starts from the recipe's initialisation instead: the output
layers small, as upstream's ``normal_init`` draws them (RPN 0.01, class
0.01, box, dimension and keypoint 0.001) and the program's
``init_params`` does, every output bias zero.  With the inference draw
the class and keypoint losses start in the hundreds and their softmax
saturates, so a rounding in a logit moves the loss's gradient by its
whole size.  Here the same draw is taken and each output kernel rescaled
to its training std.
"""

from __future__ import annotations

from typing import Dict

import torch

from h100_bench.reference.config import Config
from h100_bench.reference.weights import (OUTPUT_BIAS, OUTPUT_STD,
                                          make_state_dict)

#: Standard deviation of the output kernels at the start of training.
TRAIN_OUTPUT_STD = {
    "RCNN_rpn.RPN_Conv.weight": 0.01,
    "RCNN_rpn.RPN_cls_score.weight": 0.01,
    "RCNN_rpn.RPN_bbox_pred.weight": 0.01,
    "rcnn_head.RCNN_cls_score.weight": 0.01,
    "rcnn_head.RCNN_bbox_pred.weight": 0.001,
    "rcnn_head.RCNN_dim_orien_pred.weight": 0.001,
    "kpt_head.RCNN_kpts_score.weight": 0.001,
}


def training_state_dict(cfg: Config, seed: int,
                        device: torch.device | str
                        ) -> Dict[str, torch.Tensor]:
    """``make_state_dict(cfg, seed, device)`` with the output kernels at
    :data:`TRAIN_OUTPUT_STD` and the output biases zero."""
    sd = make_state_dict(cfg, seed, device)
    for key, std in TRAIN_OUTPUT_STD.items():
        sd[key] = sd[key] * (std / OUTPUT_STD[key])
    for key in OUTPUT_BIAS:
        sd[key] = torch.zeros_like(sd[key])
    return sd
