"""The end-to-end inference pipeline against the reference.

The reference (float32, TF32 off, exact RoIAlign weights) runs the whole
pipeline on every pair of the pool, in blocks, once the window has closed
and the program is freed.  Each call of the window is compared, image by
image, with the reference's answer for that pair.  With random weights
the features barely tell one proposal from another, so the bf16 program
and the float32 reference keep different proposals near the top-k and
NMS boundaries, and about a fifth of their detections differ (on an
H100, 30 seeds); the numbers are chosen to see through that and still
see a precision step down or a broken answer:

* ``count_gap``: how far the number of the program's valid detections
  over the window falls short of the reference's (or exceeds it), as a
  share of the reference's: an answer with too few or too many boxes (a
  broken score threshold, NMS or top-k, an image left out);
* ``head``: over detections paired one to one (same class, greedy by
  the lesser IoU, each at least ``IOU``, so a pair comes from one
  proposal), the 90th percentile of the largest gap of the dimensions
  (m) and the viewpoint angle (rad), taken per batch slot (the images a
  slot answered over the window) and the worst slot's held to the
  limit, so one slot answered wrongly shows as in a batch of one (a slot
  whose detections the program left all unpaired reads inf).

Reported beside them and not compared, because sound runs of some seeds
read as high as the control does (the limits files give the readings):
``miss`` (for each of the reference's detections, one less the IoU of
the program's nearest detection of its class; the worst slot's 60th
percentile) and ``kpt_off`` (the share of pairs whose keypoint choice,
the perspective keypoint's type and bin and the two border bins, is not
among the reference's :data:`TOP_BINS` likeliest, read off the
program's keypoint u over the reference's proposal box).

The 3D stages (solve, dense alignment, z-fixed re-solve) are judged on
the program's own 2D detections, as a served token is judged on its
prompt: with random weights their optimum is flat and a last-bit change
moves a position by tenths of a metre, so positions are not compared.
The reference solves and aligns each distinct answer again and reports
how far the program's answer falls short of its own optimum:

* ``solve_px``: 90th percentile over valid detections of the solver's
  RMS residual at the program's position and yaw above the residual of
  the reference's re-solve at the program's depth (px); a keypoint the
  program reports that is not the one its solve used shows here;
* ``align_rel``: 90th percentile of the photometric error at the
  program's refined depth above the least error the reference's sweep
  finds, as a share of the latter.

Both are taken per batch slot too, the worst slot's held to the limit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from h100_bench.reference import precision
from h100_bench.reference.config import Config
from h100_bench.reference.inference import make_full_pipeline
from h100_bench.reference.models.detector import build_model

IOU = 0.9
#: A keypoint choice within the reference's this many likeliest bins
#: counts as agreeing (``kpt_off``, reported).
TOP_BINS = 3
#: What the reference keeps beside its answers: its keypoint logits and
#: the proposal box each detection's keypoints were decoded over.
EVIDENCE = ("kpt_logits", "rois")
#: Output fields, in the order a call's answer is kept on the host.
FIELDS = ("box_left", "box_right", "score", "cls", "dims", "alpha", "kpt_u",
          "kpt_type", "kpt_prob", "border_u", "valid", "position", "ry",
          "z_refined", "residual")


def answer_fields(out) -> List[torch.Tensor]:
    """A ``Detections3D`` (program's or reference's) as :data:`FIELDS`."""
    return list(out.det) + [out.position, out.ry, out.z_refined,
                            out.residual]


def reference_config(cfg: Config) -> Config:
    import dataclasses
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, remat=False),
        rcnn=dataclasses.replace(cfg.rcnn, roi_align_hat="f32"))


def reference_model(cfg: Config, state_dict):
    """The reference detector of ``cfg`` on ``state_dict``'s tensors."""
    with torch.device("meta"):
        model = build_model(reference_config(cfg))
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.eval()


def reference_answers(cfg: Config, state_dict, left: np.ndarray,
                      right: np.ndarray, calib, device, block: int,
                      lowered: bool = False, flops: Optional[list] = None
                      ) -> Dict[str, np.ndarray]:
    """The reference's answers ``{field: [N, ...]}`` for the N pairs, in
    blocks of ``block`` pairs.  ``lowered``: the control (one precision
    step down).  ``flops``: a list to which the FLOPs of the first block
    are appended (``work.flops``)."""
    from h100_bench.work.flops import count_flops
    rcfg = reference_config(cfg)
    model = reference_model(cfg, state_dict)
    pipe = make_full_pipeline(rcfg, calib)
    parts = []
    for i in range(0, left.shape[0], block):
        seen: dict = {}
        l = torch.from_numpy(left[i:i + block]).to(device)
        r = torch.from_numpy(right[i:i + block]).to(device)
        with precision.float32():
            if lowered:
                with precision.lowered():
                    out = pipe(model, l, r, seen)
            elif flops is not None and i == 0:
                n, out = count_flops(pipe, model, l, r, seen)
                flops.append(n)
            else:
                out = pipe(model, l, r, seen)
        parts.append([t.cpu().numpy() for t in answer_fields(out)] +
                     [seen[k].cpu().numpy() for k in EVIDENCE])
    return {f: np.concatenate([p[j] for p in parts])
            for j, f in enumerate(FIELDS + EVIDENCE)}


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU [n, m] of xyxy boxes (continuous widths)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=-1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=-1)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def pair_image(p: Dict[str, np.ndarray], r: Dict[str, np.ndarray],
               iou: float = IOU):
    """``(pairs, n_p, n_r)``: index pairs of matched valid detections of
    one image, and the valid counts."""
    ip = np.nonzero(p["valid"])[0]
    ir = np.nonzero(r["valid"])[0]
    if len(ip) == 0 or len(ir) == 0:
        return [], len(ip), len(ir)
    sim = np.minimum(_iou(p["box_left"][ip], r["box_left"][ir]),
                     _iou(p["box_right"][ip], r["box_right"][ir]))
    sim = np.where(p["cls"][ip][:, None] == r["cls"][ir][None], sim, -1.0)
    pairs = []
    for flat in np.argsort(-sim, axis=None, kind="stable"):
        a, b = divmod(int(flat), len(ir))
        if sim[a, b] < iou:
            break
        if np.isfinite(sim[a, b]):
            pairs.append((ip[a], ir[b]))
            sim[a, :] = -1.0
            sim[:, b] = -1.0
    return pairs, len(ip), len(ir)


def judge_answers(cfg: Config, distinct, left, right, calib, device,
                  block: int) -> Dict[str, np.ndarray]:
    """The reference's judgement of the program's 3D answers, taken on
    the program's own 2D detections (:func:`reference.inference.judge_3d`)
    for each distinct answer ``(frame, slot, fields)`` of ``distinct``:
    arrays
    ``solve_px``, ``align_rel`` and ``ok``, [len(distinct), D]."""
    from h100_bench.reference.inference import broadcast_calib, judge_3d
    from h100_bench.reference.models.detector import Detections
    rcfg = reference_config(cfg)
    outs = {"solve_px": [], "align_rel": [], "ok": []}
    for i in range(0, len(distinct), block):
        part = distinct[i:i + block]
        idx = [f for f, _, _ in part]

        def stack(name):
            return torch.from_numpy(np.stack([a[name] for _, _, a in part])
                                    ).to(device)
        det = Detections(*[stack(f) for f in FIELDS[:11]])
        l = torch.from_numpy(left[idx]).to(device)
        r = torch.from_numpy(right[idx]).to(device)
        with precision.float32():
            got = judge_3d(det, l, r,
                           broadcast_calib(calib, len(idx), device), rcfg,
                           stack("position"), stack("ry"),
                           stack("z_refined"))
        for k, v in zip(("solve_px", "align_rel", "ok"), got):
            outs[k].append(v.cpu().numpy())
    return {k: np.concatenate(v) for k, v in outs.items()}


def distinct_answers(calls: Dict[int, Dict[str, np.ndarray]],
                     frames_of: Dict[int, List[int]]):
    """Each distinct (frame, batch slot, answer) of the window once: a
    deterministic program answers a frame the same in every call."""
    seen, out = set(), []
    for k, ans in calls.items():
        for j, frame in enumerate(frames_of[k]):
            one = {f: ans[f][j] for f in FIELDS}
            key = (frame, j, b"".join(np.ascontiguousarray(one[f]).tobytes()
                                      for f in FIELDS))
            if key not in seen:
                seen.add(key)
                out.append((frame, j, one))
    return out


def _log_softmax(x):
    m = x.max(axis=-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


def keypoint_off(p: Dict[str, np.ndarray], r: Dict[str, np.ndarray],
                 a: int, b: int, mode: str) -> Tuple[bool, float]:
    """``(off, gap)`` for the program's detection ``a`` paired with the
    reference's ``b``: whether any of the program's keypoint choices
    (the perspective keypoint's type and bin, the two border bins) lies
    outside the reference's :data:`TOP_BINS` likeliest, and the largest
    gap by which the reference's log-probability of a choice lies below
    its best, as a share of the spread of its log-probabilities there (a
    served token's logit gap).  The program's bins are read off its
    keypoint u over the reference's proposal box."""
    kl = r["kpt_logits"][b].astype(np.float64)           # [6, G]
    roi = r["rois"][b]
    g = kl.shape[-1]
    w = max(float(roi[2] - roi[0]), 1e-3)

    def bin_of(u):
        return int(np.clip(np.rint((u - roi[0]) / w * g - 0.5), 0, g - 1))
    persp = (_log_softmax(kl[:4].reshape(-1)) if mode == "joint"
             else _log_softmax(kl[:4]).reshape(-1))
    rows = [(persp, int(p["kpt_type"][a]) * g + bin_of(p["kpt_u"][a]))]
    rows += [(_log_softmax(kl[4 + c]), bin_of(p["border_u"][a][c]))
             for c in range(2)]
    off = any(lp[choice] < np.sort(lp)[-TOP_BINS] for lp, choice in rows)
    gap = max((lp.max() - lp[choice]) / max(np.ptp(lp), 1e-30)
              for lp, choice in rows)
    return bool(off), float(gap)


def nearest_miss(p: Dict[str, np.ndarray],
                 r: Dict[str, np.ndarray]) -> List[float]:
    """For each valid reference detection of one image, one less the IoU
    (the lesser of left and right) of the program's nearest detection of
    its class: 0 for a detection the program reproduced, 1 for one it
    has nothing near."""
    ir = np.nonzero(r["valid"])[0]
    ip = np.nonzero(p["valid"])[0]
    if len(ir) == 0:
        return []
    if len(ip) == 0:
        return [1.0] * len(ir)
    sim = np.minimum(_iou(r["box_left"][ir], p["box_left"][ip]),
                     _iou(r["box_right"][ir], p["box_right"][ip]))
    sim = np.where(r["cls"][ir][:, None] == p["cls"][ip][None], sim, 0.0)
    return list(1.0 - sim.max(axis=1))


def _q(x, pct, empty=float("inf")):
    return float(np.percentile(x, pct)) if len(x) else empty


def _image(p: Dict[str, np.ndarray], r: Dict[str, np.ndarray],
           kpt_mode: str) -> dict:
    """One image's answer ``p`` against the reference's ``r``."""
    pairs, n_p, n_r = pair_image(p, r)
    out = {"miss": nearest_miss(p, r), "n_p": n_p, "n_r": n_r, "head": [],
           "kpt": [], "px": []}
    for a, b in pairs:
        out["px"].append(max(
            np.abs(p["box_left"][a] - r["box_left"][b]).max(),
            np.abs(p["box_right"][a] - r["box_right"][b]).max()))
        out["kpt"].append(keypoint_off(p, r, a, b, kpt_mode))
        dalpha = abs(np.angle(np.exp(1j * (p["alpha"][a] - r["alpha"][b]))))
        out["head"].append(max(np.abs(p["dims"][a] - r["dims"][b]).max(),
                               dalpha))
    return out


def compare(calls: Dict[int, Dict[str, np.ndarray]],
            frames_of: Dict[int, List[int]],
            ref: Dict[str, np.ndarray],
            judged: Dict[str, np.ndarray],
            slots: List[int],
            kpt_mode: str = "joint") -> Dict[str, float]:
    """Every call's answer against the reference's answers for its pool
    frames (``frames_of[call]``), and the judgement of the distinct 3D
    answers (``slots``: the batch slot of each).  Returns the compared
    numbers (see the module's docstring) and others beside them."""
    width = max(len(f) for f in frames_of.values())
    per: Dict[str, Dict[int, list]] = {
        key: {j: [] for j in range(width)}
        for key in ("miss", "head", "n_p", "n_r")}
    kpt, px = [], []
    unmatched = total = 0
    memo: dict = {}
    for k, ans in calls.items():
        for j, frame in enumerate(frames_of[k]):
            p = {f: ans[f][j] for f in FIELDS}
            key = (frame, b"".join(np.ascontiguousarray(p[f]).tobytes()
                                   for f in FIELDS))
            if key not in memo:
                memo[key] = _image(p, {f: ref[f][frame]
                                       for f in FIELDS + EVIDENCE},
                                   kpt_mode)
            one = memo[key]
            per["miss"][j].extend(one["miss"])
            per["head"][j].extend(one["head"])
            per["n_p"][j].append(one["n_p"])
            per["n_r"][j].append(one["n_r"])
            total += one["n_p"] + one["n_r"]
            unmatched += one["n_p"] + one["n_r"] - 2 * len(one["px"])
            kpt.extend(one["kpt"])
            px.extend(one["px"])
    finite = all(np.isfinite(ans["position"][ans["valid"]]).all()
                 for ans in calls.values())
    ok = judged["ok"]
    slots = np.asarray(slots, int)

    def judged_q(name, pct):
        return max(_q(judged[name][ok & (slots[:, None] == j)], pct, 0.0)
                   for j in range(width))
    n_p = sum(sum(v) for v in per["n_p"].values())
    n_r = sum(sum(v) for v in per["n_r"].values())
    kp = np.asarray(kpt, float).reshape(-1, 2)   # off, gap
    # A slot to which the reference gave no detection misses nothing
    # and pairs nothing; one whose detections the program left all
    # unpaired reads ``head`` inf.
    empty = {j: 0.0 if sum(per["n_r"][j]) == 0 else float("inf")
             for j in range(width)}
    all_miss = [m for v in per["miss"].values() for m in v]
    all_head = [h for v in per["head"].values() for h in v]
    return {
        "count_gap": abs(n_p - n_r) / max(n_r, 1),
        "head": max(_q(per["head"][j], 90, empty[j]) for j in range(width)),
        # No detection whose alignment ran: nothing falls short.
        "solve_px": judged_q("solve_px", 90),
        "align_rel": judged_q("align_rel", 90),
        "detections": float(total), "pairs": float(len(px)),
        "miss": max(_q(per["miss"][j], 60, 0.0) for j in range(width))
        if finite else 1.0,
        "judged": float(ok.sum()),
        "unmatched_share": unmatched / max(total, 1),
        "miss_all": _q(all_miss, 60), "head_all": _q(all_head, 90),
        "miss_mean": float(np.mean(all_miss)) if all_miss else 1.0,
        "kpt_off": float(np.mean(kp[:, 0])) if len(kp) else 0.0,
        "kpt_gap_p75": _q(kp[:, 1], 75), "box_px_p90": _q(px, 90),
        "solve_px_max": _q(judged["solve_px"][ok], 100, 0.0),
        "align_rel_max": _q(judged["align_rel"][ok], 100, 0.0),
    }


def check(cfg: Config, state_dict, answers: Dict[int, Dict[str, np.ndarray]],
          frames_of: Dict[int, List[int]], left: np.ndarray,
          right: np.ndarray, calib, device, block: int,
          flops: Optional[list] = None) -> Dict[str, float]:
    """The whole comparison of a window's ``answers`` (call -> fields)
    with the reference, which gets ``state_dict``: its own answers for
    every pair, and its judgement of the program's 3D answers."""
    ref = reference_answers(cfg, state_dict, left, right, calib, device,
                            block, flops=flops)
    distinct = distinct_answers(answers, frames_of)
    judged = judge_answers(cfg, distinct, left, right, calib, device, block)
    return compare(answers, frames_of, ref, judged,
                   [j for _, j, _ in distinct],
                   reference_config(cfg).rcnn.kpt_softmax)
