"""Fixed-shape non-maximum suppression by leader election (torch).

Port of ``stereo_rcnn_tpu.ops.nms``, kept as the same fixed point rather
than greedy NMS so both packages keep the same boxes: each round, every
alive box that no alive, higher-ranked, overlapping box precedes is a
leader and is kept; every alive box a leader overlaps is killed.  Rank is
score, ties broken by lower index.  After ``rounds`` rounds the boxes
still undecided are dropped, as in the JAX package.

Functions take a leading batch axis: boxes ``[B, N, 4]``, scores
``[B, N]``.
"""

from __future__ import annotations

import torch

from h100_bench.reference.geometry.boxes import pairwise_iou

_DEFAULT_ROUNDS = 32


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
             valid: torch.Tensor | None = None,
             rounds: int = _DEFAULT_ROUNDS,
             off: float = 0.0) -> torch.Tensor:
    """Keep-mask ``[B, N]`` bool in the original box order."""
    n = boxes.shape[-2]
    overlap = pairwise_iou(boxes, boxes, off) > iou_thresh     # [B, N, N]
    idx = torch.arange(n, device=boxes.device)
    # higher[b, j, i]: box j precedes box i in greedy order.
    s_j, s_i = scores[..., :, None], scores[..., None, :]
    higher = (s_j > s_i) | ((s_j == s_i) & (idx[:, None] < idx[None, :]))
    dominates = overlap & higher
    alive = (torch.ones_like(scores, dtype=torch.bool) if valid is None
             else valid.clone())
    kept = torch.zeros_like(alive)
    for _ in range(rounds):
        blocked = (alive[..., :, None] & dominates).any(dim=-2)
        leader = alive & ~blocked
        kept |= leader
        killed = (leader[..., :, None] & overlap).any(dim=-2)
        alive = alive & ~killed & ~leader
    return kept


def top_k_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` semantics: the k largest along the last axis, ties in
    index order (``torch.topk`` on CUDA gives no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_indices(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
                top_k: int, valid: torch.Tensor | None = None,
                rounds: int = _DEFAULT_ROUNDS, off: float = 0.0):
    """Padded indices ``[B, top_k]`` of the surviving boxes by score, and
    their validity mask.  Invalid slots index 0."""
    keep = nms_mask(boxes, scores, iou_thresh, valid=valid, rounds=rounds,
                    off=off)
    masked = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    k_eff = min(top_k, masked.shape[-1])
    top_scores, top_idx = top_k_stable(masked, k_eff)
    if k_eff < top_k:
        pad = top_k - k_eff
        lead = top_scores.shape[:-1]
        top_scores = torch.cat([top_scores, top_scores.new_full(
            (*lead, pad), -torch.inf)], dim=-1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros((*lead, pad))],
                            dim=-1)
    out_valid = top_scores > -torch.inf
    top_idx = torch.where(out_valid, top_idx, torch.zeros_like(top_idx))
    return top_idx, out_valid
