"""KITTI 3D-object AP evaluator (AP_bev / AP_3d / AP_2d), host-side numpy.

The reference writes KITTI-format result .txt files and relies on the
EXTERNAL C++ devkit for AP (SURVEY.md §3.3); this module vendors the
evaluation so the framework is self-contained.  Devkit semantics
implemented (kitti devkit ``evaluate_object.cpp`` rules):

  * difficulty gating (Easy/Moderate/Hard via min 2D height, max occlusion,
    max truncation) — gts failing the gate are IGNORED, not removed;
  * neighbor-class ignoring: for the Car class, Van gts are ignored at
    match time (a detection matching one is neither TP nor FP);
  * DontCare regions: unmatched detections whose 2D intersection-over-
    detection-area with a DontCare region exceeds the threshold are
    ignored, not FPs;
  * small unmatched detections (2D height below the difficulty's min) are
    ignored, not FPs;
  * 40-point (devkit-2017, skips recall 0) or 11-point (paper-era,
    includes recall 0) interpolated AP.

A copy of ``stereo_rcnn_tpu.evalkit.kitti_eval`` (pinned equal by
``tests/test_torch_evalkit.py``); :func:`frame_objects_from_outputs` reads
the port's ``Detections3D`` tensors from any device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np

from stereo_rcnn_tpu_torch.evalkit.rotate_iou import iou_3d, rotated_iou_bev

DIFFICULTIES = ("easy", "moderate", "hard")
# (min 2D bbox height px, max occlusion, max truncation) — devkit constants.
_DIFF_GATES = {"easy": (40.0, 0, 0.15), "moderate": (25.0, 1, 0.30),
               "hard": (25.0, 2, 0.50)}


@dataclasses.dataclass
class FrameObjects:
    """Ground truth or detections for one frame (Car class).

    For ground truth, ``cls_ignored`` marks neighbor-class objects (Van for
    Car) that are ignored at match time, and ``dontcare`` holds DontCare
    2D regions.  Both default to empty for detections.
    """

    box2d: np.ndarray        # [N, 4] left-image xyxy
    box3d: np.ndarray        # [N, 7] (x, y, z, h, w, l, ry)
    score: np.ndarray        # [N] (ones for gt)
    occlusion: np.ndarray    # [N] int (gt only; zeros for dets)
    truncation: np.ndarray   # [N] (gt only)
    cls_ignored: Optional[np.ndarray] = None   # [N] bool (gt only)
    dontcare: Optional[np.ndarray] = None      # [M, 4] 2D regions (gt only)

    def __post_init__(self):
        n = len(self.score)
        if self.cls_ignored is None:
            self.cls_ignored = np.zeros(n, bool)
        if self.dontcare is None:
            self.dontcare = np.zeros((0, 4))

    @staticmethod
    def empty() -> "FrameObjects":
        return FrameObjects(np.zeros((0, 4)), np.zeros((0, 7)),
                            np.zeros((0,)), np.zeros((0,), int),
                            np.zeros((0,)))


def _gt_classification(gt: FrameObjects, difficulty: str):
    """valid / ignored split per devkit rules: an object harder than the
    current difficulty — or of a neighboring class (Van for Car) — is
    IGNORED (matches count as neither TP nor FP)."""
    min_h, max_occ, max_trunc = _DIFF_GATES[difficulty]
    h = gt.box2d[:, 3] - gt.box2d[:, 1]
    valid = (h >= min_h) & (gt.occlusion <= max_occ) & \
        (gt.truncation <= max_trunc) & ~gt.cls_ignored
    ignored = ~valid
    return valid, ignored


def _box2d_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[Na, 4] x [Nb, 4] -> [Na, Nb] axis-aligned IoU."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def _dontcare_fraction(det_box2d: np.ndarray,
                       dontcare: np.ndarray) -> np.ndarray:
    """Max intersection-over-DETECTION-area vs the DontCare regions."""
    if len(dontcare) == 0 or len(det_box2d) == 0:
        return np.zeros(len(det_box2d))
    lt = np.maximum(det_box2d[:, None, :2], dontcare[None, :, :2])
    rb = np.minimum(det_box2d[:, None, 2:], dontcare[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    area = np.maximum((det_box2d[:, 2] - det_box2d[:, 0]) *
                      (det_box2d[:, 3] - det_box2d[:, 1]), 1e-9)[:, None]
    return (inter / area).max(axis=1)


def _match_frame(gt: FrameObjects, det: FrameObjects, iou, thresh: float,
                 difficulty: str):
    """Returns (det_tp, det_ignored, n_valid_gt) for one frame.

    ``iou``: [Ndet, Ngt] matrix in the metric being evaluated.  Greedy:
    detections in descending score claim their best unmatched VALID gt
    first; failing that, an IGNORED gt; failing that, DontCare regions and
    the small-detection rule decide FP vs ignored.
    """
    valid, ignored = _gt_classification(gt, difficulty)
    n_det = len(det.score)
    det_tp = np.zeros(n_det, bool)
    det_ign = np.zeros(n_det, bool)
    n_valid = int(valid.sum())
    if n_det == 0:
        return det_tp, det_ign, n_valid

    min_h = _DIFF_GATES[difficulty][0]
    det_h = det.box2d[:, 3] - det.box2d[:, 1]
    dc_frac = _dontcare_fraction(det.box2d, gt.dontcare)

    order = np.argsort(-det.score)
    taken = np.zeros(len(gt.score), bool)
    for d in order:
        matched = False
        if len(gt.score):
            cand = (iou[d] >= thresh) & ~taken
            if (cand & valid).any():
                g = int(np.argmax(np.where(cand & valid, iou[d], -1.0)))
                taken[g] = True
                det_tp[d] = True
                matched = True
            elif (cand & ignored).any():
                # Ignored gts are NOT marked taken: the devkit lets an
                # ignored gt absorb any number of detections (each becomes
                # "ignored", never FP), so duplicates over a Van/too-hard
                # gt must keep matching it.
                det_ign[d] = True
                matched = True
        if not matched:
            # Unmatched: DontCare overlap or sub-evaluable size -> ignored.
            if dc_frac[d] >= thresh or det_h[d] < min_h:
                det_ign[d] = True
    return det_tp, det_ign, n_valid


def _average_precision(recalls: np.ndarray, precisions: np.ndarray,
                       n_points: int = 40) -> float:
    """Interpolated AP.  R40 (devkit 2017+) samples 40 points skipping
    recall 0; R11 (paper-era devkit) samples 11 points INCLUDING recall 0
    (where max precision over recall>=0 is the global max)."""
    if n_points == 11:
        samples = np.linspace(0.0, 1.0, 11)
    else:
        samples = np.linspace(0.0, 1.0, n_points + 1)[1:]
    ap = 0.0
    for r in samples:
        mask = recalls >= r - 1e-9
        ap += float(precisions[mask].max()) if mask.any() else 0.0
    return ap / len(samples) * 100.0


def evaluate(gts: Sequence[FrameObjects], dets: Sequence[FrameObjects],
             metric: str = "3d", iou_thresh: float = 0.7,
             n_points: int = 40) -> Dict[str, float]:
    """AP per difficulty over a list of frames.

    metric: "3d" (volume IoU), "bev" (rotated BEV IoU), or "2d" (left-image
    axis-aligned IoU).  ``n_points``: 40 (devkit 2017+) or 11 (paper-era —
    use for comparisons against the paper's published tables).
    """
    if metric not in ("3d", "bev", "2d"):
        raise ValueError(metric)

    def iou_matrix(det: FrameObjects, gt: FrameObjects) -> np.ndarray:
        if len(det.score) == 0 or len(gt.score) == 0:
            return np.zeros((len(det.score), len(gt.score)))
        if metric == "3d":
            return iou_3d(det.box3d, gt.box3d)
        if metric == "bev":
            return rotated_iou_bev(det.box3d[:, [0, 2, 4, 5, 6]],
                                   gt.box3d[:, [0, 2, 4, 5, 6]])
        return _box2d_iou(det.box2d, gt.box2d)

    results = {}
    for diff in DIFFICULTIES:
        rows = []            # (score, is_tp, is_ignored)
        n_gt_total = 0
        for gt, det in zip(gts, dets):
            tp, ign, n_valid = _match_frame(gt, det, iou_matrix(det, gt),
                                            iou_thresh, diff)
            n_gt_total += n_valid
            for s, t, i in zip(det.score, tp, ign):
                rows.append((s, t, i))
        if n_gt_total == 0 or not rows:
            results[diff] = 0.0
            continue
        rows.sort(key=lambda r: -r[0])
        tps = np.cumsum([r[1] for r in rows])
        fps = np.cumsum([(not r[1]) and (not r[2]) for r in rows])
        recalls = tps / n_gt_total
        precisions = tps / np.maximum(tps + fps, 1)
        results[diff] = _average_precision(recalls, precisions, n_points)
    return results


def frame_objects_from_labels(objs, evaluated_class: str = "Car",
                              neighbor_classes: Sequence[str] = ("Van",)
                              ) -> FrameObjects:
    """Build a gt FrameObjects from parsed :class:`KittiObject`s with devkit
    ignore semantics: ``evaluated_class`` objects are scored,
    ``neighbor_classes`` objects are match-time-ignored, DontCare boxes
    become ignore regions, everything else is dropped."""
    main, neigh, dontcare = [], [], []
    for o in objs:
        if o.type == evaluated_class:
            main.append(o)
        elif o.type in neighbor_classes:
            neigh.append(o)
        elif o.type == "DontCare":
            dontcare.append(o.box)
    sel = main + neigh
    n = len(sel)
    return FrameObjects(
        box2d=np.stack([o.box for o in sel]).reshape(n, 4)
        if sel else np.zeros((0, 4)),
        box3d=np.asarray([[*o.location, *o.dims, o.ry]
                          for o in sel]).reshape(n, 7),
        score=np.ones(n),
        occlusion=np.asarray([o.occlusion for o in sel], int),
        truncation=np.asarray([o.truncation for o in sel]),
        cls_ignored=np.asarray([False] * len(main) + [True] * len(neigh),
                               bool),
        dontcare=np.stack(dontcare).reshape(len(dontcare), 4)
        if dontcare else np.zeros((0, 4)),
    )


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def frame_objects_from_outputs(det_out, gt, n_frames: int,
                               cls_id: int | None = None):
    """Unpack the pipeline's padded ``Detections3D`` + packed
    ``GroundTruth`` (tensors or arrays) into per-frame ``(gts, dets)``
    FrameObjects lists.

    Shared by the synthetic-scene evaluation paths (``tools.smoke_e2e``,
    ``tools.eval_synth``): synthetic gts carry no occlusion/truncation
    and no ignore regions, so those fields are zeros/empty.

    ``cls_id`` restricts both detections and ground truth to one
    foreground class (KITTI AP is per-class — upstream ``test_net.py``
    loops classes); ``None`` keeps the historical single-class behavior
    of scoring everything together.
    """
    det = type(det_out.det)(*[_host(x) for x in det_out.det])
    pos = _host(det_out.position)
    rys = _host(det_out.ry)
    gt = type(gt)(*[_host(x) for x in gt])
    gts, dets = [], []
    for b in range(n_frames):
        valid = np.asarray(det.valid[b])
        if cls_id is not None:
            valid = valid & (np.asarray(det.cls[b]) == cls_id)
        sel = np.nonzero(valid)[0]
        dets.append(FrameObjects(
            box2d=np.asarray(det.box_left[b])[sel],
            box3d=np.concatenate(
                [pos[b][sel], np.asarray(det.dims[b])[sel],
                 rys[b][sel][:, None]], -1),
            score=np.asarray(det.score[b])[sel],
            occlusion=np.zeros(len(sel), int),
            truncation=np.zeros(len(sel))))
        gvalid = np.asarray(gt.valid[b])
        if cls_id is not None:
            gvalid = gvalid & (np.asarray(gt.cls[b]) == cls_id)
        gsel = np.nonzero(gvalid)[0]
        gts.append(FrameObjects(
            box2d=np.asarray(gt.left[b])[gsel],
            box3d=np.concatenate(
                [np.asarray(gt.location[b])[gsel],
                 np.asarray(gt.dims[b])[gsel],
                 np.asarray(gt.ry[b])[gsel][:, None]], -1),
            score=np.ones(len(gsel)),
            occlusion=np.zeros(len(gsel), int),
            truncation=np.zeros(len(gsel))))
    return gts, dets


# ---------------------------------------------------------------------------
# KITTI result-file IO (the reference's test_net.py output format).
# ---------------------------------------------------------------------------

def write_result_file(path: str, types: Sequence[str], boxes2d: np.ndarray,
                      dims: np.ndarray, locations: np.ndarray,
                      rys: np.ndarray, alphas: np.ndarray,
                      scores: np.ndarray) -> None:
    """KITTI format: type trunc occ alpha bbox(4) dims(h,w,l) loc(3) ry
    score  (reference: test_net.py result writer, SURVEY.md §3.3)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i, t in enumerate(types):
            b, d, l = boxes2d[i], dims[i], locations[i]
            f.write(f"{t} -1 -1 {alphas[i]:.6f} "
                    f"{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
                    f"{d[0]:.2f} {d[1]:.2f} {d[2]:.2f} "
                    f"{l[0]:.2f} {l[1]:.2f} {l[2]:.2f} "
                    f"{rys[i]:.6f} {scores[i]:.4f}\n")


def read_result_file(path: str,
                     evaluated_class: str = "Car") -> FrameObjects:
    if not os.path.exists(path):
        return FrameObjects.empty()
    box2d, box3d, score = [], [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) < 16 or p[0] != evaluated_class:
                continue
            box2d.append([float(x) for x in p[4:8]])
            h, w, l = (float(x) for x in p[8:11])
            x, y, z = (float(x) for x in p[11:14])
            box3d.append([x, y, z, h, w, l, float(p[14])])
            score.append(float(p[15]))
    n = len(score)
    return FrameObjects(np.asarray(box2d).reshape(n, 4),
                        np.asarray(box3d).reshape(n, 7),
                        np.asarray(score), np.zeros(n, int), np.zeros(n))
