"""Per-component 3D error diagnosis on held-out synthetic scenes.

    python -m stereo_rcnn_tpu_torch.tools.diag_3d --ckpt-dir runs/exp0 \
        [--batches 4] [--batch 8] [--seed-base 1000] [--step N]

Port of the JAX package's ``tools/diag_3d.py`` with its flags and rows.
AP_3d summarises everything at once; this tool says which stage limits
it.  Detections are matched to ground truth by 2D IoU (>= ``--iou``,
greedy in score order) and each matched pair is split into the error
each 3D input contributes: depth (final, in m and %, and the raw
dense-alignment depth), lateral and vertical position, dimensions,
viewpoint and yaw, the perspective keypoint's column and corner type, and
the box pair's disparity.  The checkpoint is a ``tools.train`` run's
(``train.checkpoint.restore_train_state``), its config
``<ckpt-dir>/config.json`` unless ``--config`` is given.  It runs on the
CUDA card (``--platform auto``, which raises without one) or on the CPU
(``--platform cpu``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] corner-box IoU."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def _stats(name, v, unit=""):
    v = np.asarray(v, np.float64)
    if v.size == 0:
        print(f"{name:24s} (no matches)")
        return
    q = np.percentile(np.abs(v), [50, 90])
    print(f"{name:24s} median={np.median(v):+8.3f}{unit}  "
          f"|p50|={q[0]:7.3f}  |p90|={q[1]:7.3f}  n={v.size}")


def _wrap(angle):
    return np.arctan2(np.sin(angle), np.cos(angle))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-objects", type=int, default=4)
    ap.add_argument("--seed-base", type=int, default=1000,
                    help="first scene seed; 1000+ = held-out, 0 = the "
                         "training pool's seeds (train.py renders seeds "
                         "0..steps_per_epoch-1)")
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                    help="auto: the CUDA card (raises without one); cpu")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step to restore (default: latest)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from stereo_rcnn_tpu_torch.config import load_config
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
    from stereo_rcnn_tpu_torch.device import resolve_device
    from stereo_rcnn_tpu_torch.inference import make_full_pipeline
    from stereo_rcnn_tpu_torch.train.checkpoint import restore_train_state

    dev = resolve_device(None if args.platform == "auto" else "cpu")
    cfg_path = args.config or os.path.join(args.ckpt_dir, "config.json")
    cfg = load_config(cfg_path if os.path.exists(cfg_path) else None)
    state = restore_train_state(args.ckpt_dir, cfg, dev, step=args.step)
    print(f"step {state.step}, matching at 2D IoU >= {args.iou}")
    model = state.model.eval()

    acc = {k: [] for k in ("dz", "dz_pct", "dz_solver_pct", "dx", "dy",
                           "dh", "dw", "dl", "dalpha", "dry", "dkpt_u",
                           "kpt_type_ok", "ddisp")}
    n_det = n_gt = n_match = 0
    pipeline = None
    for i in range(args.batches):
        il, ir, gt, calib = synthetic_batch(cfg, batch=args.batch,
                                            seed=args.seed_base + i,
                                            n_objects=args.n_objects)
        if pipeline is None:
            pipeline = make_full_pipeline(cfg, calib)
        out = pipeline(model, torch.from_numpy(il).to(dev),
                       torch.from_numpy(ir).to(dev))
        det = type(out.det)(*[x.cpu().numpy() for x in out.det])
        pos, ry = out.position.cpu().numpy(), out.ry.cpu().numpy()
        z_refined = out.z_refined.cpu().numpy()
        for b in range(args.batch):
            dsel = np.nonzero(det.valid[b])[0]
            gsel = np.nonzero(gt.valid[b])[0]
            n_det += len(dsel)
            n_gt += len(gsel)
            if not len(dsel) or not len(gsel):
                continue
            iou = _iou_matrix(det.box_left[b][dsel], gt.left[b][gsel])
            # Greedy best-match per gt, score order.
            order = np.argsort(-det.score[b][dsel])
            taken = set()
            for d in order:
                g = int(np.argmax(iou[d]))
                if iou[d, g] < args.iou or g in taken:
                    continue
                taken.add(g)
                n_match += 1
                di, gi = dsel[d], gsel[g]
                gloc = gt.location[b][gi]
                acc["dz"].append(pos[b, di, 2] - gloc[2])
                acc["dz_pct"].append(100 * (pos[b, di, 2] - gloc[2])
                                     / gloc[2])
                # position[2] is the re-solved z downstream of the dense
                # alignment; z_refined is the raw aligned depth.
                acc["dz_solver_pct"].append(
                    100 * (z_refined[b, di] - gloc[2]) / gloc[2])
                acc["dx"].append(pos[b, di, 0] - gloc[0])
                acc["dy"].append(pos[b, di, 1] - gloc[1])
                ddims = det.dims[b][di] - gt.dims[b][gi]
                acc["dh"].append(ddims[0])
                acc["dw"].append(ddims[1])
                acc["dl"].append(ddims[2])
                acc["dalpha"].append(_wrap(det.alpha[b][di]
                                           - gt.alpha[b][gi]))
                acc["dry"].append(_wrap(ry[b, di] - gt.ry[b][gi]))
                if bool(gt.kpt_visible[b][gi]):
                    acc["dkpt_u"].append(det.kpt_u[b][di] - gt.kpt_u[b][gi])
                    acc["kpt_type_ok"].append(
                        float(int(det.kpt_type[b][di])
                              == int(gt.kpt_type[b][gi])))
                # Implied disparity of the box pair vs the gt box pair.
                dcx = (det.box_left[b][di][[0, 2]].mean()
                       - det.box_right[b][di][[0, 2]].mean())
                gcx = (gt.left[b][gi][[0, 2]].mean()
                       - gt.right[b][gi][[0, 2]].mean())
                acc["ddisp"].append(dcx - gcx)

    print(f"{n_det} detections / {n_gt} gts / {n_match} matched")
    _stats("depth dz", acc["dz"], " m")
    _stats("depth dz", acc["dz_pct"], " %")
    _stats("aligned-z dz (raw)", acc["dz_solver_pct"], " %")
    _stats("lateral dx", acc["dx"], " m")
    _stats("vertical dy", acc["dy"], " m")
    _stats("dims dh", acc["dh"], " m")
    _stats("dims dw", acc["dw"], " m")
    _stats("dims dl", acc["dl"], " m")
    _stats("viewpoint dalpha", acc["dalpha"], " rad")
    _stats("yaw dry", acc["dry"], " rad")
    _stats("keypoint du", acc["dkpt_u"], " px")
    if acc["kpt_type_ok"]:
        print(f"{'kpt corner-type acc':24s} "
              f"{np.mean(acc['kpt_type_ok']) * 100:.1f}%  "
              f"n={len(acc['kpt_type_ok'])}")
    _stats("box disparity err", acc["ddisp"], " px")
    return 0


if __name__ == "__main__":
    sys.exit(main())
