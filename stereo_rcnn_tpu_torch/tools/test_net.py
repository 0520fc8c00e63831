"""Evaluation CLI: run the port over a KITTI split, write KITTI-format
result files and score AP_3d, AP_bev and AP_2d.

    python -m stereo_rcnn_tpu_torch.tools.test_net \
        --kitti-root data/kitti/object --ckpt-dir runs/exp0 --out results/ \
        [--batch 4] [--image-ext .npy] [--config cfg.json]

Port of the JAX package's ``tools/test_net.py`` with its flags.  Each
frame's own calibration, scaled to the working resolution by
``data.pipeline.KittiPipeline``, goes into ``make_full_pipeline(cfg)`` as
a batched argument, with the letterboxed content extent.  The weights are
the params export ``<ckpt-dir>/params_export`` of a ``tools.train`` run
(random weights without ``--ckpt-dir``), and the config defaults to
``<ckpt-dir>/config.json`` when it exists.  Pad frames of a ragged last
batch are neither written nor scored.  AP follows the devkit's rules
(``evalkit``: Van gts ignored when scoring Car, DontCare regions absorb
would-be false positives), R40 and R11, per class when the config has
several.  It runs on the CUDA card (``--platform auto``, which raises
without one) or on the CPU (``--platform cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--kitti-root", required=True)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--out", default="results")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--config", default=None,
                   help="config overlay (.json or YAML; over the tiny base "
                        "with --tiny); defaults to <ckpt-dir>/config.json")
    p.add_argument("--image-ext", default=".png")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto: the CUDA card (raises without one); cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from stereo_rcnn_tpu_torch.config import load_config, tiny_test_config
    from stereo_rcnn_tpu_torch.data.kitti import (KittiDataset,
                                                  parse_label_file)
    from stereo_rcnn_tpu_torch.data.pipeline import KittiPipeline
    from stereo_rcnn_tpu_torch.device import resolve_device
    from stereo_rcnn_tpu_torch.evalkit import (FrameObjects, evaluate,
                                               frame_objects_from_labels,
                                               write_result_file)
    from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
    from stereo_rcnn_tpu_torch.inference import make_full_pipeline
    from stereo_rcnn_tpu_torch.models.detector import (build_model,
                                                       init_params)
    from stereo_rcnn_tpu_torch.train.checkpoint import restore_params

    dev = resolve_device(None if args.platform == "auto" else "cpu")
    cfg_path = args.config
    if cfg_path is None and args.ckpt_dir:
        saved = os.path.join(args.ckpt_dir, "config.json")
        cfg_path = saved if os.path.exists(saved) else None
    cfg = load_config(cfg_path,
                      base=tiny_test_config() if args.tiny else None)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, kitti_root=args.kitti_root))
    ds = KittiDataset(cfg.data)
    if len(ds) == 0:
        raise SystemExit(f"no data under {args.kitti_root}")
    print(f"{len(ds)} frames")

    if args.ckpt_dir:
        model = restore_params(os.path.join(args.ckpt_dir, "params_export"),
                               build_model(cfg).to(dev).eval())
        print(f"loaded checkpoint params export from {args.ckpt_dir}")
    else:
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)
        print("WARNING: random weights (no --ckpt-dir)")

    pipe = KittiPipeline(cfg, ds, args.batch, shuffle=False,
                         image_ext=args.image_ext)
    # Calibration is a batched argument: each frame's own.
    pipeline = make_full_pipeline(cfg)

    os.makedirs(args.out, exist_ok=True)
    # Per-frame material for the per-class AP loop below: detections keep
    # their class ids; gt label objects are re-filtered per class.
    det_frames, gt_objs = [], []
    frame = 0
    t0 = time.time()
    for pb in pipe:
        calib = StereoCalib(*[torch.from_numpy(np.asarray(v, np.float32))
                              .to(dev) for v in pb.calib])
        out = pipeline(model, torch.from_numpy(pb.images_left).to(dev),
                       torch.from_numpy(pb.images_right).to(dev), calib,
                       torch.from_numpy(pb.content_wh).to(dev))
        det = type(out.det)(*[x.cpu().numpy() for x in out.det])
        pos = out.position.cpu().numpy()
        ry = out.ry.cpu().numpy()
        for b in range(pb.n_valid):         # pad replicas are not scored
            fid = ds.ids[frame]
            scale = float(pb.scales[b])
            sel = np.nonzero(det.valid[b])[0]
            n = len(sel)
            boxes2d = det.box_left[b][sel] / scale
            dims = det.dims[b][sel]
            locs = pos[b][sel]
            rys = ry[b][sel]
            alphas = det.alpha[b][sel]
            scores = det.score[b][sel]
            cls_ids = det.cls[b][sel]
            cls_names = [cfg.data.classes[c] for c in cls_ids]
            write_result_file(
                os.path.join(args.out, f"{fid}.txt"), cls_names,
                boxes2d, dims, locs, rys, alphas, scores)
            det_frames.append((FrameObjects(
                box2d=boxes2d,
                box3d=np.concatenate([locs, dims, rys[:, None]], -1),
                score=scores, occlusion=np.zeros(n, int),
                truncation=np.zeros(n)), cls_ids))
            gt_objs.append(parse_label_file(ds.paths(frame)["label"]))
            frame += 1
    dt = time.time() - t0
    print(f"{frame} frames in {dt:.1f}s ({frame / dt:.2f} pairs/s)")

    def _take(fo: FrameObjects, keep: np.ndarray) -> FrameObjects:
        return FrameObjects(fo.box2d[keep], fo.box3d[keep], fo.score[keep],
                            fo.occlusion[keep], fo.truncation[keep])

    # Devkit neighbour-ignore pairs: Van gts are ignored when scoring Car
    # (and vice versa).
    neighbors = {"Car": ("Van",), "Van": ("Car",),
                 "Pedestrian": ("Person_sitting",)}
    fg = [(i + 1, name) for i, name in enumerate(cfg.data.classes[1:])]
    for cls_id, cname in fg:
        prefix = f"[{cname}] " if len(fg) > 1 else ""
        gts = [frame_objects_from_labels(
            objs, evaluated_class=cname,
            neighbor_classes=neighbors.get(cname, ())) for objs in gt_objs]
        dets = [_take(fo, ids == cls_id) for fo, ids in det_frames]
        for metric, thresh in (("3d", 0.7), ("3d", 0.5), ("bev", 0.7),
                               ("bev", 0.5), ("2d", 0.7)):
            for n_points in (40, 11):
                res = evaluate(gts, dets, metric=metric, iou_thresh=thresh,
                               n_points=n_points)
                print(f"{prefix}AP_{metric}@{thresh} (R{n_points}): "
                      + " / ".join(f"{d}={res[d]:.2f}"
                                   for d in ("easy", "moderate", "hard")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
