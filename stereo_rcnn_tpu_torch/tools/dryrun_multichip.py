"""Data-parallel dry run: one training step and one sharded inference over
every rank, at a small config that still runs every production path.

    python -m stereo_rcnn_tpu_torch.tools.dryrun_multichip [--platform cpu] [-n N]

The port of the JAX package's ``__graft_entry__.dryrun_multichip(n)``:
:func:`dryrun_config` is its ``_dryrun_config()`` (backbone and FPN,
stereo RPN, the fused RoIAlign, all heads, target assignment, losses with
uncertainty, the Gauss-Newton solve, dense alignment), and each rank
prints the same tick lines.  ``--platform auto`` (the default) runs one
NCCL rank per visible card (``-n``: the first N), ``--platform cpu`` N
gloo ranks on the CPU (default 2).  With one rank it runs in this
process, else it starts the ranks (``parallel.launch.spawn``).  Rank 0
prints; the tool exits non-zero if any rank fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch


def dryrun_config():
    """``__graft_entry__._dryrun_config()``: the tiny config, float32,
    depth 10 with affine norms, 64x128 images, few rois and solver
    iterations."""
    from stereo_rcnn_tpu_torch.config import tiny_test_config
    cfg = tiny_test_config()
    return dataclasses.replace(
        cfg,
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depth=10, norm="affine",
                                     fpn_dim=64),
        data=dataclasses.replace(cfg.data, image_h=64, image_w=128),
        rpn=dataclasses.replace(
            cfg.rpn, conv_dim=64, train_pre_nms_top_n=32,
            train_post_nms_top_n=16, test_pre_nms_top_n=32,
            test_post_nms_top_n=8, batch_size=32),
        rcnn=dataclasses.replace(cfg.rcnn, fc_dim=128, rois_per_image=8,
                                 max_detections=4),
        train=dataclasses.replace(cfg.train, max_gt_boxes=4),
        solver=dataclasses.replace(
            cfg.solver, gn_iters=1, align_coarse_candidates=2,
            align_fine_candidates=2, align_grid_h=2, align_grid_w=4),
    )


def dryrun(n: int, platform: str) -> int:
    """One rank of the dry run over ``n`` ranks."""
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
    from stereo_rcnn_tpu_torch.inference import (broadcast_calib,
                                                 make_full_pipeline)
    from stereo_rcnn_tpu_torch.parallel import (data_parallel_inference,
                                                data_parallel_train_step,
                                                make_mesh, replicate,
                                                shard_batch)
    from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                             make_train_step)
    from stereo_rcnn_tpu_torch.train.targets import ground_truth_to_torch

    cfg = dryrun_config()
    with make_mesh(n, device="cpu" if platform == "cpu" else None) as mesh:
        dev = mesh.device
        lead = mesh.rank == 0
        last = [time.time()]

        def tick(msg):
            now = time.time()
            if lead:
                print(f"dryrun[{now - last[0]:7.1f}s] {msg}", flush=True)
            last[0] = now

        if lead:
            print(f"dryrun_multichip({n}): {mesh.backend} ranks on "
                  f"{dev.type}", flush=True)
        state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
        replicate(mesh, [state.model, state.uncert])
        tick("init")

        # One data-parallel training step (forward, backward, gradient
        # all-reduce, update) on the global batch of n images.
        il, ir, gt, _ = synthetic_batch(cfg, n, seed=0, n_objects=2)
        il, ir, gt = shard_batch(mesh, (il, ir, gt))
        batch = Batch(torch.from_numpy(il).to(dev),
                      torch.from_numpy(ir).to(dev),
                      ground_truth_to_torch(gt, dev))
        tick("synthetic batch (train)")
        step = data_parallel_train_step(
            make_train_step(cfg, steps_per_epoch=10, device=dev), mesh)
        metrics = step(state, batch,
                       torch.Generator(device=dev).manual_seed(1))
        total = float(metrics["total"])
        tick("train step")
        if not total == total or abs(total) == float("inf"):
            raise RuntimeError(f"non-finite loss: {total}")
        if lead:
            print(f"dryrun_multichip({n}): train OK, loss={total:.4f}, "
                  f"step={state.step}", flush=True)

        # The sharded inference pipeline (network, NMS, 3D solve, dense
        # alignment) with per-image calibration, batch split over ranks.
        il2, ir2, _, calib = synthetic_batch(cfg, n, seed=1, n_objects=2)
        calib_b = broadcast_calib(calib, n, dev)
        tick("synthetic batch (inference)")
        infer = data_parallel_inference(make_full_pipeline(cfg), mesh)
        out = infer(state.model.eval(), torch.from_numpy(il2).to(dev),
                    torch.from_numpy(ir2).to(dev), calib_b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        tick("inference")
        if out.position.shape[0] != n or not bool(
                torch.isfinite(out.position).all()):
            raise RuntimeError(f"inference: positions "
                               f"{tuple(out.position.shape)}, finite "
                               f"{bool(torch.isfinite(out.position).all())}")
        if lead:
            print(f"dryrun_multichip({n}): inference OK", flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto: one NCCL rank per visible card; cpu: gloo "
                        "ranks on the CPU")
    p.add_argument("-n", "--n-devices", type=int, default=None,
                   help="ranks (default: every visible card; 2 on the CPU)")
    args = p.parse_args(argv)
    n = args.n_devices
    if n is None:
        n = 2 if args.platform == "cpu" else torch.cuda.device_count()
    if args.platform == "auto" and not 1 <= n <= torch.cuda.device_count():
        raise SystemExit(f"dryrun_multichip: {n} ranks need as many CUDA "
                         f"devices ({torch.cuda.device_count()} visible)")
    if n == 1:
        return dryrun(1, args.platform)
    from stereo_rcnn_tpu_torch.parallel.launch import spawn
    codes = spawn(dryrun, n, n, args.platform)
    bad = [c for c in codes if c]
    if bad:
        print(f"dryrun_multichip({n}): ranks exited {codes}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
