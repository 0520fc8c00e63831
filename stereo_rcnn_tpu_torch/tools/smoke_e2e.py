"""End-to-end learning smoke of the port: train a tiny model from scratch
on rendered stereo scenes, then detect, solve and align, and score 2D,
BEV and 3D AP on the training scenes and on held-out ones.

    python -m stereo_rcnn_tpu_torch.tools.smoke_e2e [--steps 800]
        [--scenes 8] [--pool 40] [--lr 2e-3] [--size HxW] [--platform cpu]

Port of the JAX package's ``tools/smoke_e2e.py`` with its flags and its
criterion: ``SMOKE PASS`` when the 2D AP@0.5 on the training scenes
reaches 60 in some difficulty and the 3D AP@0.5 on held-out scenes
reaches 20, else ``SMOKE FAIL`` (exit 1).  The config is
``tiny_test_config()`` in float32 with ``--lr``; the training pool is
``--pool`` batches of ``--scenes`` scenes (seeds 2 and up, 3 objects
each), cycled; the learning rate decays at 10/12 of the steps, as the
reference's 12-epoch schedule.  Evaluation: seed 2 (the first training
batch) and seeds 1000-1003 (never trained on).  It runs on the CUDA card
by default (``--platform auto``, which raises without one); the JAX tool
defaults to the CPU to keep its accelerator free.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--scenes", type=int, default=8,
                    help="scenes per training batch")
    ap.add_argument("--pool", type=int, default=40,
                    help="pre-rendered training batches cycled during "
                         "training")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--size", default=None,
                    help="working resolution HxW (multiples of 64), e.g. "
                         "256x512")
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                    help="auto: the CUDA card (raises without one); cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from stereo_rcnn_tpu_torch.config import tiny_test_config
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
    from stereo_rcnn_tpu_torch.device import resolve_device
    from stereo_rcnn_tpu_torch.evalkit import (evaluate,
                                               frame_objects_from_outputs)
    from stereo_rcnn_tpu_torch.inference import make_full_pipeline
    from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                             make_train_step, step_generator)
    from stereo_rcnn_tpu_torch.train.targets import ground_truth_to_torch

    dev = resolve_device(None if args.platform == "auto" else "cpu")
    cfg = tiny_test_config().replace(compute_dtype="float32")
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, learning_rate=args.lr))
    if args.size:
        h_, w_ = (int(t) for t in args.size.split("x"))
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, image_h=h_, image_w=w_))
    print(f"device: {dev} "
          f"({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'host'})",
          flush=True)

    # A pool of distinct scene batches, cycled: the smoke must show
    # generalisation, which one repeated batch cannot.
    print(f"rendering {args.pool} x {args.scenes} training scenes...",
          flush=True)
    pool = []
    calib = None
    for p in range(args.pool):
        il, ir, gt, calib = synthetic_batch(cfg, batch=args.scenes,
                                            seed=2 + p, n_objects=3)
        pool.append(Batch(torch.from_numpy(il).to(dev),
                          torch.from_numpy(ir).to(dev),
                          ground_truth_to_torch(gt, dev)))

    # The reference's 12-epoch schedule compressed into the step budget.
    spe = max(args.steps // 12, 1)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    step_fn = make_train_step(cfg, steps_per_epoch=spe, device=dev)
    t0 = time.time()
    for i in range(args.steps):
        metrics = step_fn(state, pool[i % args.pool],
                          step_generator(1, i, dev))
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i}: total={float(metrics['total']):.2f} "
                  f"rpn_cls={float(metrics['rpn_cls']):.3f} "
                  f"rcnn_cls={float(metrics['rcnn_cls']):.3f} "
                  f"rcnn_box={float(metrics['rcnn_box']):.3f}", flush=True)
    print(f"trained {args.steps} steps in {time.time() - t0:.0f}s")

    # Inference and the 3D solve on training and held-out scenes; the
    # held-out AP aggregates several batches (one 8-scene batch quantises
    # AP into ~25-point steps).
    model = state.model.eval()
    pipeline = make_full_pipeline(cfg, calib)
    results = {}
    for name, seeds in (("train", [2]),
                        ("heldout", [1000 + i for i in range(4)])):
        gts, dets = [], []
        for seed in seeds:
            il_e, ir_e, gt_e, _ = synthetic_batch(cfg, batch=args.scenes,
                                                  seed=seed, n_objects=3)
            out = pipeline(model, torch.from_numpy(il_e).to(dev),
                           torch.from_numpy(ir_e).to(dev))
            g, d = frame_objects_from_outputs(out, gt_e, args.scenes)
            gts += g
            dets += d
        n_det = sum(len(d.score) for d in dets)
        n_gt = sum(len(g.score) for g in gts)
        r2d = evaluate(gts, dets, metric="2d", iou_thresh=0.5)
        rbev = evaluate(gts, dets, metric="bev", iou_thresh=0.5)
        r3d = evaluate(gts, dets, metric="3d", iou_thresh=0.5)
        results[name] = (r2d, rbev, r3d)
        print(f"[{name}] detections: {n_det} (gt: {n_gt})")
        for metric, r in (("2d", r2d), ("bev", rbev), ("3d", r3d)):
            print(f"[{name}] AP_{metric}@0.5:",
                  {k: round(v, 2) for k, v in r.items()})

    # PASS: the model learned (2D on the training scenes) and the
    # geometric pipeline gives 3D boxes that score on unseen scenes.
    ok = (max(results["train"][0].values()) >= 60.0 and
          max(results["heldout"][2].values()) >= 20.0)
    print("SMOKE", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
