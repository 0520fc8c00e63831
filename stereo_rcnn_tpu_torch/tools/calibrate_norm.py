"""Fold a GroupNorm-trained checkpoint into the frozen-BN inference model.

    python -m stereo_rcnn_tpu_torch.tools.calibrate_norm --ckpt-dir runs/exp0 \
        [--calib-batches 4] [--eval-batches 2] [--batch 8]

Port of the JAX package's ``tools/calibrate_norm.py`` with its flags,
gates and defaults.  Reads ``<ckpt-dir>/params_export`` and
``<ckpt-dir>/config.json``, captures each GroupNorm site's expected
statistics over freshly rendered calibration scenes (seeds 5000 and up,
disjoint from the training pool and the held-out seeds 1000 and up),
folds them into per-channel affines (``convert.norm_calibrate``), then
validates the calibrated model against the exact GroupNorm one on held-out
scenes before writing

    <ckpt-dir>/calibrated/params_export   (frozen-BN state_dict)
    <ckpt-dir>/calibrated/config.json     (the same config, norm "frozen")
    <ckpt-dir>/calibrated/VALID           (last: consumers key on it)

The gate: on held-out scenes the calibrated model must keep the detection
count within ``--max-count-drift``, and for greedily matched detection
pairs keep the median |dz|/z at most ``--max-z-drift`` and the median box
IoU at least ``--min-iou``.  On failure nothing is written (exit 1).  It
runs on the CUDA card (``--platform auto``, which raises without one) or
on the CPU (``--platform cpu``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _match_stats(out_a, out_b, batch):
    """Greedy IoU matching of detections between two pipeline outputs."""
    from stereo_rcnn_tpu_torch.tools.diag_3d import _iou_matrix
    valid_a, valid_b = out_a.det.valid.cpu().numpy(), \
        out_b.det.valid.cpu().numpy()
    box_a, box_b = out_a.det.box_left.cpu().numpy(), \
        out_b.det.box_left.cpu().numpy()
    pos_a, pos_b = out_a.position.cpu().numpy(), out_b.position.cpu().numpy()
    ious, dzs = [], []
    n_a = n_b = 0
    for b in range(batch):
        sa = np.nonzero(valid_a[b])[0]
        sb = np.nonzero(valid_b[b])[0]
        n_a += len(sa)
        n_b += len(sb)
        if not len(sa) or not len(sb):
            continue
        iou = _iou_matrix(box_a[b][sa], box_b[b][sb])
        for i in range(len(sa)):
            j = int(np.argmax(iou[i]))
            if iou[i, j] <= 0:
                continue
            ious.append(iou[i, j])
            za = float(pos_a[b, sa[i], 2])
            zb = float(pos_b[b, sb[j], 2])
            dzs.append(abs(za - zb) / max(abs(za), 1e-6))
            iou[:, j] = -1
    return n_a, n_b, np.asarray(ious), np.asarray(dzs)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt-dir", default="runs/bench_ckpt")
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--eval-batches", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--min-iou", type=float, default=0.9)
    ap.add_argument("--max-z-drift", type=float, default=0.02)
    ap.add_argument("--max-count-drift", type=float, default=0.1)
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                    help="auto: the CUDA card (raises without one); cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from stereo_rcnn_tpu_torch.config import load_config, save_config
    from stereo_rcnn_tpu_torch.convert.norm_calibrate import calibrate
    from stereo_rcnn_tpu_torch.data.synthetic import (synthetic_batch,
                                                      synthetic_images)
    from stereo_rcnn_tpu_torch.device import resolve_device
    from stereo_rcnn_tpu_torch.inference import make_full_pipeline
    from stereo_rcnn_tpu_torch.models.detector import build_model
    from stereo_rcnn_tpu_torch.train.checkpoint import (export_params,
                                                        restore_params)

    dev = resolve_device(None if args.platform == "auto" else "cpu")
    cfg = load_config(os.path.join(args.ckpt_dir, "config.json"),
                      overrides={"backbone": {"remat": False}})
    if cfg.backbone.norm != "group":
        print(f"checkpoint norm is '{cfg.backbone.norm}', nothing to "
              "calibrate")
        return 0
    model = restore_params(os.path.join(args.ckpt_dir, "params_export"),
                           build_model(cfg).to(dev).eval())

    def tensors(il, ir):
        return torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev)

    # Calibration scenes: seeds 5000+, disjoint from the training pool
    # (0..steps_per_epoch-1) and the held-out eval seeds (1000+).
    calib_sets = [synthetic_batch(cfg, batch=args.batch, seed=5000 + i)
                  for i in range(args.calib_batches)]
    print(f"calibrating over {2 * args.calib_batches * args.batch} views...",
          flush=True)
    cfg_aff, model_aff = calibrate(
        cfg, model, [tensors(il, ir) for il, ir, _, _ in calib_sets])

    # Validate end to end on held-out scenes against the exact GN model.
    calib0 = calib_sets[0][3]
    pipe_gn = make_full_pipeline(cfg, calib0)
    pipe_aff = make_full_pipeline(cfg_aff, calib0)
    ious, dzs = [], []
    n_gn = n_aff = 0
    for i in range(args.eval_batches):
        il, ir = tensors(*synthetic_images(cfg, args.batch,
                                           seed=1000 + i)[:2])
        a, b2, iou_m, dz_m = _match_stats(pipe_gn(model, il, ir),
                                          pipe_aff(model_aff, il, ir),
                                          args.batch)
        n_gn += a
        n_aff += b2
        ious.append(iou_m)
        dzs.append(dz_m)
    ious = np.concatenate(ious) if ious else np.zeros((0,))
    dzs = np.concatenate(dzs) if dzs else np.zeros((0,))
    med_iou = float(np.median(ious)) if ious.size else 0.0
    med_dz = float(np.median(dzs)) if dzs.size else 1.0
    drift = abs(n_aff - n_gn) / max(n_gn, 1)
    print(f"held-out: {n_gn} GN dets vs {n_aff} calibrated "
          f"(count drift {100 * drift:.1f}%), matched {ious.size}, "
          f"median IoU {med_iou:.4f}, median |dz|/z {100 * med_dz:.3f}%")

    ok = (ious.size > 0 and med_iou >= args.min_iou
          and med_dz <= args.max_z_drift
          and drift <= args.max_count_drift)
    if not ok:
        print("validation FAILED — not writing calibrated export")
        return 1

    out_dir = os.path.join(args.ckpt_dir, "calibrated")
    os.makedirs(out_dir, exist_ok=True)
    # Drop any stale VALID marker first, so that a crash mid-export never
    # leaves a marker beside a half-written tree; consumers key their
    # preference on the marker, not on the directory.
    marker = os.path.join(out_dir, "VALID")
    if os.path.exists(marker):
        os.remove(marker)
    export_params(os.path.join(out_dir, "params_export"), model_aff)
    save_config(cfg_aff, os.path.join(out_dir, "config.json"))
    with open(marker, "w") as f:
        f.write(f"median IoU {med_iou:.4f}, median |dz|/z "
                f"{100 * med_dz:.3f}%, count drift {100 * drift:.1f}%\n")
    print(f"wrote {out_dir} (norm: {cfg_aff.backbone.norm})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
