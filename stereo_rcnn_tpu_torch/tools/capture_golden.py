"""Golden capture: convert a released upstream Stereo R-CNN checkpoint and
dump the port's outputs on one stereo pair as an ``.npz`` golden.

    python -m stereo_rcnn_tpu_torch.tools.capture_golden \\
        --pth stereo_rcnn_epoch_12.pth --left left.npy --right right.npy \\
        --calib calib.txt --out goldens/demo.npz [--platform cpu]

Port of the JAX package's ``tools/capture_golden.py``, without JAX: the
checkpoint goes through ``convert/stereo_import.import_detector`` into
the port's model, loaded strictly, with ``Config()``.  The pair is
letterboxed as the data pipeline does it (``utils/host_preproc``), and
``make_full_pipeline`` runs in both keypoint-softmax modes
(``rcnn.kpt_softmax``: "joint" and "per_channel"), since which one is the
reference's is a parity question the golden answers.  The ``.npz`` holds
the JAX tool's arrays under its keys.

It prints the conversion report: the matched upstream prefixes and the
keys no rule claimed (an unclaimed key means a name table in
``convert/stereo_import.py`` needs the real checkpoint's spelling).
Images are read by ``data/pipeline.load_image`` (``.npy``, or PNG with
cv2 or PIL).  It runs on the CUDA card (``--platform auto``, which raises
without one) or on the CPU (``--platform cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

#: The JAX tool's ``np.savez`` keys, in its order.
GOLDEN_KEYS = ("scale", "box_left", "box_right", "score", "dims", "alpha",
               "kpt_u", "border_u", "kpt_u_joint", "kpt_prob_joint",
               "kpt_u_per_channel", "kpt_prob_per_channel", "valid",
               "position", "ry", "z_refined")


def load_state_dict(path: str):
    """``(model state_dict as numpy, extras)``: a checkpoint's ``model``
    entry (or the whole file, if it is a bare state dict) and its other
    entries."""
    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return ({k: v.numpy() for k, v in sd.items()},
            {k: v for k, v in (ckpt.items() if isinstance(ckpt, dict)
                               else []) if k != "model"})


def capture(cfg, sd, left_img: np.ndarray, right_img: np.ndarray, calib,
            device) -> dict:
    """The golden arrays of one uint8 BGR pair (``calib`` at the images'
    resolution) under the model of upstream state dict ``sd``; prints the
    conversion report and the keypoint-mode comparison."""
    from stereo_rcnn_tpu_torch.convert.stereo_import import import_detector
    from stereo_rcnn_tpu_torch.inference import make_full_pipeline
    from stereo_rcnn_tpu_torch.models.detector import build_model
    from stereo_rcnn_tpu_torch.utils.host_preproc import resize_subtract_pad

    converted, report = import_detector(sd, depth=cfg.backbone.depth,
                                        pool=cfg.rcnn.pooling_size,
                                        fpn_dim=cfg.backbone.fpn_dim)
    print(f"matched: {report['matched']}")
    if report["unclaimed"]:
        print("UNCLAIMED KEYS (fix the name tables in "
              "convert/stereo_import.py):")
        for k in report["unclaimed"]:
            print(f"  {k}")
    model = build_model(cfg)
    model.load_state_dict(converted, strict=True)
    model = model.to(device).eval()

    sh, sw = left_img.shape[:2]
    th, tw = cfg.data.image_h, cfg.data.image_w
    scale = min(th / sh, tw / sw)
    means = cfg.backbone.pixel_means_bgr
    left, right = (torch.from_numpy(resize_subtract_pad(
        img, th, tw, scale, means)[None]).to(device)
        for img in (left_img, right_img))
    calib_s = calib.scale(scale)

    # The same weights decoded under both keypoint semantics.
    outs = {}
    for mode in ("joint", "per_channel"):
        mcfg = dataclasses.replace(cfg, rcnn=dataclasses.replace(
            cfg.rcnn, kpt_softmax=mode))
        model.cfg = mcfg
        outs[mode] = make_full_pipeline(mcfg, calib_s)(model, left, right)
    model.cfg = cfg
    jd = (outs["joint"].det.kpt_u - outs["per_channel"].det.kpt_u).abs()
    td = outs["joint"].det.kpt_type != outs["per_channel"].det.kpt_type
    print(f"kpt semantics A/B: max |kpt_u joint - per_channel| = "
          f"{float(jd.max()):.3f} px, corner-type disagreements = "
          f"{int(td.sum())}/{td.numel()} — match the reference's kpts to "
          f"pick rcnn.kpt_softmax")

    out = outs[cfg.rcnn.kpt_softmax]
    det = out.det

    def first(x):
        return x[0].cpu().numpy()

    arrays = {"scale": np.float64(scale)}
    for name in ("box_left", "box_right", "score", "dims", "alpha",
                 "kpt_u", "border_u"):
        arrays[name] = first(getattr(det, name))
    for mode in ("joint", "per_channel"):
        arrays[f"kpt_u_{mode}"] = first(outs[mode].det.kpt_u)
        arrays[f"kpt_prob_{mode}"] = first(outs[mode].det.kpt_prob)
    arrays["valid"] = first(det.valid)
    for name in ("position", "ry", "z_refined"):
        arrays[name] = first(getattr(out, name))
    return {k: arrays[k] for k in GOLDEN_KEYS}


def main(argv=None) -> dict:
    from stereo_rcnn_tpu_torch.config import Config
    from stereo_rcnn_tpu_torch.data.pipeline import load_image
    from stereo_rcnn_tpu_torch.device import resolve_device
    from stereo_rcnn_tpu_torch.geometry.calib import read_kitti_calib

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pth", required=True)
    ap.add_argument("--left", required=True)
    ap.add_argument("--right", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--out", default="goldens/demo.npz")
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                    help="auto: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.platform == "auto" else "cpu")

    sd, extras = load_state_dict(args.pth)
    arrays = capture(Config(), sd, load_image(args.left),
                     load_image(args.right), read_kitti_calib(args.calib),
                     dev)
    if extras:
        print(f"checkpoint extras: {sorted(extras)}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, **arrays)
    print(f"golden written to {args.out} "
          f"({int(arrays['valid'].sum())} detections)")
    return arrays


if __name__ == "__main__":
    main()
