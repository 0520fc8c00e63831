"""Score a training checkpoint on held-out synthetic scenes.

    python -m stereo_rcnn_tpu_torch.tools.eval_synth --ckpt-dir runs/exp0 \
        [--config cfg.json] [--batches 4] [--batch 8] [--domain all] \
        [--step N] [--set rcnn.roi_align_hat=kron_bf16]

Port of the JAX package's ``tools/eval_synth.py`` with its flags.  A
``tools.train --synthetic`` run trains on scene seeds 0 to
steps_per_epoch - 1; this tool renders seeds 1000 and up, which no
training run renders, in each appearance domain asked for
(``data.synthetic.EVAL_DOMAINS``), runs ``inference.make_full_pipeline``
on the restored model and prints AP_2d, AP_bev and AP_3d at IoU 0.7 and
0.5 (R40, easy / moderate / hard) from the vendored evaluator
(``evalkit``), per class when the config has several.  The config
defaults to ``<ckpt-dir>/config.json``, the training run's own.  It runs
on the CUDA card (``--platform auto``, which raises without one) or on the
CPU (``--platform cpu``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--config", default=None,
                    help="config (.json or YAML); defaults to "
                         "<ckpt-dir>/config.json (the training run's "
                         "effective config)")
    ap.add_argument("--batches", type=int, default=4,
                    help="held-out batches (AP quantisation shrinks with "
                         "more gts)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-objects", type=int, default=4)
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                    help="auto: the CUDA card (raises without one); cpu")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step to restore (default: latest)")
    ap.add_argument("--domain", default="none",
                    help="held-out appearance domain(s), comma-separated "
                         "or 'all' (none/untinted/shaded/tinted/illum/"
                         "noise): same scenes, perturbed appearance")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="dotted config override, e.g. "
                         "rcnn.roi_align_hat=kron_bf16 (repeatable), "
                         "applied after the config file")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from stereo_rcnn_tpu_torch.config import load_config, parse_set_overrides
    from stereo_rcnn_tpu_torch.data.synthetic import (EVAL_DOMAINS,
                                                      synthetic_batch)
    from stereo_rcnn_tpu_torch.device import resolve_device
    from stereo_rcnn_tpu_torch.evalkit import (evaluate,
                                               frame_objects_from_outputs)
    from stereo_rcnn_tpu_torch.inference import make_full_pipeline
    from stereo_rcnn_tpu_torch.train.checkpoint import (latest_step,
                                                        restore_train_state)

    dev = resolve_device(None if args.platform == "auto" else "cpu")
    cfg_path = args.config or os.path.join(args.ckpt_dir, "config.json")
    cfg = load_config(cfg_path if os.path.exists(cfg_path) else None,
                      overrides=parse_set_overrides(args.set) or None)
    print(f"config: {cfg_path}, resolution "
          f"{cfg.data.image_h}x{cfg.data.image_w}"
          + (f", overrides {args.set}" if args.set else ""))

    state = restore_train_state(args.ckpt_dir, cfg, dev, step=args.step)
    print(f"restored step {state.step} "
          f"(latest: {latest_step(args.ckpt_dir)})")
    model = state.model.eval()

    domains = (list(EVAL_DOMAINS) if args.domain == "all"
               else args.domain.split(","))
    # Per evaluated class (KITTI AP is per class); a single-class config
    # is one unprefixed pass.
    fg = [(i + 1, name) for i, name in enumerate(cfg.data.classes[1:])]
    pipeline = None
    for domain in domains:
        per_cls = {c: ([], []) for c, _ in fg}
        t0 = time.time()
        n_det = n_gt = 0
        for i in range(args.batches):
            il, ir, gt, calib = synthetic_batch(cfg, batch=args.batch,
                                                seed=1000 + i,
                                                n_objects=args.n_objects,
                                                domain=domain)
            if pipeline is None:
                pipeline = make_full_pipeline(cfg, calib)
            out = pipeline(model, torch.from_numpy(il).to(dev),
                           torch.from_numpy(ir).to(dev))
            for c, _ in fg:
                g, d = frame_objects_from_outputs(
                    out, gt, args.batch, cls_id=c if len(fg) > 1 else None)
                per_cls[c][0].extend(g)
                per_cls[c][1].extend(d)
                n_det += sum(len(x.score) for x in d)
                n_gt += sum(len(x.score) for x in g)
                if len(fg) == 1:
                    break
        dtag = f"[domain={domain}] " if len(domains) > 1 else ""
        print(f"{dtag}{args.batches * args.batch} held-out frames in "
              f"{time.time() - t0:.0f}s — {n_det} detections / {n_gt} gts")

        for c, cname in fg:
            prefix = dtag + (f"[{cname}] " if len(fg) > 1 else "")
            gts, dets = per_cls[c]
            for metric, thresh in (("2d", 0.7), ("2d", 0.5), ("bev", 0.7),
                                   ("bev", 0.5), ("3d", 0.7), ("3d", 0.5)):
                r = evaluate(gts, dets, metric=metric, iou_thresh=thresh)
                print(f"{prefix}AP_{metric}@{thresh} (R40): " + " / ".join(
                    f"{d}={r[d]:.2f}" for d in ("easy", "moderate", "hard")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
