"""Training CLI of the port.

    python -m stereo_rcnn_tpu_torch.tools.train --kitti-root data/kitti/object \
        --epochs 12 --batch-per-device 1 --ckpt-dir runs/exp0 [--resume] \
        [--synthetic N] [--config cfg.json] [--image-ext .npy]

Port of the JAX package's ``tools/train.py`` with its flags: a KITTI tree
(``data.pipeline.KittiPipeline``) or a pool of ``--synthetic N`` rendered
scenes, SGD with momentum and a stepped learning rate, learned
uncertainty weights, checkpoints every ``--ckpt-every`` epochs (and after
the last), ``--resume`` from the latest one, skipping the batches of a
partly trained epoch.  On SIGTERM the run finishes its step, saves a
checkpoint and the params export at the current step and exits
:data:`PREEMPTED_RC` (75), which ``tools.supervise_train`` resumes.

It runs on the CUDA card (``--platform auto``, which raises without one)
or on the CPU (``--platform cpu``).  On one card the global batch is
``--batch-per-device``.  The effective config is written to
``<ckpt-dir>/config.json``, which the evaluation tools read;
``--config`` takes a ``.json`` file (no PyYAML needed) or a YAML one.
Each step's target sampling draws from a generator seeded by the config
seed and the step (``train.step.step_generator``), so a resumed run draws
what an uninterrupted one would.  Rendered pools are cached under
``runs/synth_pool_torch/`` (keyed like the JAX package's
``runs/synth_pool/``, never shared with it); the first ``STAGE_GB``
gigabytes of the pool (default 6) stay on the device, the rest is
uploaded per step.  The card reads ``.png`` trees only with cv2 or PIL
installed; ``--image-ext .npy`` trees need neither.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys

import numpy as np
import torch

# Exit code for "preempted after a successful checkpoint" (EX_TEMPFAIL):
# distinct from 0 so the supervisor resumes instead of declaring the run
# complete, distinct from a crash so it skips the backoff.
PREEMPTED_RC = 75
POOL_DIR = os.path.join("runs", "synth_pool_torch")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--kitti-root", default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic scenes instead of KITTI")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-per-device", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--ckpt-dir", default="runs/default")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--config", default=None,
                   help="config overlay: .json, or YAML (needs PyYAML)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny config (CI/smoke)")
    p.add_argument("--disp-interval", type=int, default=20)
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="save a checkpoint every N epochs (the final epoch "
                        "always saves)")
    p.add_argument("--image-ext", default=".png",
                   help="image file extension in the KITTI tree (.npy needs "
                        "no image codec)")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto: the CUDA card (raises without one); cpu")
    p.add_argument("--tfboard", action="store_true",
                   help="also write TensorBoard event files to "
                        "<ckpt-dir>/tb (CSV only where the writer is "
                        "missing)")
    return p.parse_args(argv)


def build_config(args):
    """The effective config: ``--config`` over the defaults (or over the
    tiny config with ``--tiny``), then the flags."""
    from stereo_rcnn_tpu_torch.config import load_config, tiny_test_config
    cfg = load_config(args.config,
                      base=tiny_test_config() if args.tiny else None)
    overrides = {}
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    if args.batch_per_device is not None:
        overrides["batch_per_device"] = args.batch_per_device
    if args.lr is not None:
        overrides["learning_rate"] = args.lr
    if overrides:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **overrides))
    if args.kitti_root:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data,
                                          kitti_root=args.kitti_root))
    return cfg


def synthetic_pool(cfg, global_batch: int, steps_per_epoch: int):
    """``steps_per_epoch`` rendered batches ``(left, right, gt)``; batch
    ``s`` is ``synthetic_batch(cfg, global_batch, seed=s)``, cached in
    :data:`POOL_DIR` under a key of every input that changes it."""
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
    from stereo_rcnn_tpu_torch.train.targets import GroundTruth
    os.makedirs(POOL_DIR, exist_ok=True)
    cls_tag = ("" if tuple(cfg.data.classes[1:]) == ("Car",)
               else "_" + "-".join(cfg.data.classes[1:]))
    app_tag = ("" if cfg.data.synthetic_appearance == "tints"
               else f"_{cfg.data.synthetic_appearance}")
    pool = []
    for s in range(steps_per_epoch):
        path = os.path.join(
            POOL_DIR, f"v3{cls_tag}{app_tag}_{cfg.data.image_h}x"
            f"{cfg.data.image_w}_b{global_batch}_g{cfg.train.max_gt_boxes}"
            f"_s{s}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                pool.append((z["il"], z["ir"], GroundTruth(
                    **{k: z[k] for k in GroundTruth._fields})))
            continue
        il, ir, gt, _ = synthetic_batch(cfg, global_batch, seed=s)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, il=il, ir=ir, **gt._asdict())
        os.replace(tmp, path)
        pool.append((il, ir, gt))
    return pool


def run(args, on_start=None):
    """Train as ``args`` say; returns the final
    :class:`~stereo_rcnn_tpu_torch.train.step.TrainState`.  Raises
    ``SystemExit(PREEMPTED_RC)`` after a SIGTERM's checkpoint.
    ``on_start(state)``, if given, sees the state (fresh or restored)
    before the first step."""
    from stereo_rcnn_tpu_torch.config import save_config
    from stereo_rcnn_tpu_torch.data.kitti import KittiDataset
    from stereo_rcnn_tpu_torch.data.pipeline import KittiPipeline
    from stereo_rcnn_tpu_torch.device import resolve_device
    from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                             make_train_step, step_generator)
    from stereo_rcnn_tpu_torch.train.checkpoint import (export_params,
                                                        latest_step,
                                                        restore_train_state,
                                                        save_checkpoint)
    from stereo_rcnn_tpu_torch.train.targets import ground_truth_to_torch
    from stereo_rcnn_tpu_torch.utils.metrics import MetricsLogger, StepTimer

    dev = resolve_device(None if args.platform == "auto" else "cpu")
    cfg = build_config(args)
    global_batch = cfg.train.batch_per_device
    print(f"device: {dev} "
          f"({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'host'}"
          f"), global batch: {global_batch}", flush=True)

    if args.synthetic:
        steps_per_epoch = max(args.synthetic // global_batch, 1)
        print(f"rendering {steps_per_epoch} x {global_batch} synthetic "
              f"scenes...", flush=True)
        pool = synthetic_pool(cfg, global_batch, steps_per_epoch)
    else:
        ds = KittiDataset(cfg.data)
        if len(ds) == 0:
            raise SystemExit(f"no KITTI data under {cfg.data.kitti_root}; "
                             f"use --synthetic N for smoke training")
        pipe = KittiPipeline(cfg, ds, global_batch, image_ext=args.image_ext)
        steps_per_epoch = pipe.steps_per_epoch()

    # The effective config beside the checkpoints, so that consumers
    # (eval_synth, test_net) rebuild the same parameter tree.
    os.makedirs(args.ckpt_dir, exist_ok=True)
    save_config(cfg, os.path.join(args.ckpt_dir, "config.json"))

    if args.resume and latest_step(args.ckpt_dir) is not None:
        state = restore_train_state(args.ckpt_dir, cfg, dev)
        print(f"resumed from step {state.step}", flush=True)
    else:
        state = init_train_state(cfg, torch.Generator().manual_seed(
            cfg.train.seed), device=dev)
    if on_start is not None:
        on_start(state)
    step_fn = make_train_step(cfg, steps_per_epoch, device=dev)
    logger = MetricsLogger(os.path.join(args.ckpt_dir, "metrics.csv"),
                           print_every=args.disp_interval,
                           tb_dir=(os.path.join(args.ckpt_dir, "tb")
                                   if args.tfboard else None))
    timer = StepTimer()

    def to_device(il, ir, gt):
        return Batch(torch.as_tensor(il, device=dev),
                     torch.as_tensor(ir, device=dev),
                     ground_truth_to_torch(gt, dev))

    # The synthetic pool stays on the device up to a byte cap; batches
    # past it are uploaded per step.
    staged = []
    if args.synthetic:
        il0, ir0, gt0 = pool[0]
        batch_nbytes = (il0.nbytes + ir0.nbytes +
                        sum(np.asarray(x).nbytes for x in gt0))
        cap = float(os.environ.get("STAGE_GB", "6")) * 1e9
        n_stage = min(len(pool), max(1, int(cap // max(batch_nbytes, 1))))
        staged = [to_device(*pool[i]) for i in range(n_stage)]
        if n_stage < len(pool):
            print(f"staged {n_stage}/{len(pool)} batches "
                  f"({batch_nbytes * n_stage / 1e9:.1f} GB) on device; "
                  f"remainder streams per step", flush=True)

    def device_batches():
        if args.synthetic:
            yield from staged
            for i in range(len(staged), len(pool)):
                yield to_device(*pool[i])
            return
        for pb in pipe:
            yield to_device(pb.images_left, pb.images_right, pb.gt)

    def save(tag):
        save_checkpoint(args.ckpt_dir, state)
        export_params(os.path.join(args.ckpt_dir, "params_export"),
                      state.model)
        print(f"{tag}, checkpoint saved to {args.ckpt_dir}", flush=True)

    def preempted_exit():
        logger.close()
        raise SystemExit(PREEMPTED_RC)

    # Graceful preemption: the handler only sets a flag; the loop saves at
    # the current step once the in-flight step is done.
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True
        print("SIGTERM: will checkpoint at the current step and exit",
              flush=True)

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        start_epoch = state.step // steps_per_epoch
        # A mid-epoch checkpoint lands at step % steps_per_epoch != 0: skip
        # the batches that epoch already consumed.
        resume_skip = state.step % steps_per_epoch
        if resume_skip:
            print(f"mid-epoch resume: skipping the first {resume_skip} "
                  f"batches of epoch {start_epoch + 1}", flush=True)
        for epoch in range(start_epoch, cfg.train.epochs):
            for i, batch in enumerate(device_batches()):
                if epoch == start_epoch and i < resume_skip:
                    continue
                metrics = step_fn(state, batch, step_generator(
                    cfg.train.seed + 1, state.step, dev))
                timer.tick()
                step = state.step
                # Metrics are read (one sync) on logging steps only.
                if (step % args.disp_interval == 0 or
                        step % steps_per_epoch == 0):
                    logger.log(step, {**{k: float(v)
                                         for k, v in metrics.items()},
                                      "pairs_per_sec":
                                          timer.throughput(global_batch)})
                if preempted["flag"]:
                    save(f"preempted at step {step} "
                         f"(epoch {epoch + 1}/{cfg.train.epochs})")
                    preempted_exit()
            if ((epoch + 1) % args.ckpt_every == 0
                    or epoch + 1 == cfg.train.epochs):
                save(f"epoch {epoch + 1}/{cfg.train.epochs} done")
                # A SIGTERM during that save is covered by it.
                if preempted["flag"] and epoch + 1 < cfg.train.epochs:
                    print(f"preempted at epoch boundary "
                          f"{epoch + 1}/{cfg.train.epochs}; checkpoint "
                          f"already saved", flush=True)
                    preempted_exit()
            else:
                print(f"epoch {epoch + 1}/{cfg.train.epochs} done",
                      flush=True)
                if preempted["flag"]:
                    save(f"preempted at epoch boundary "
                         f"{epoch + 1}/{cfg.train.epochs}")
                    preempted_exit()
    finally:
        signal.signal(signal.SIGTERM, previous)
    logger.close()
    return state


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
