"""Serve an exported artifact: run stereo pairs through it and write
KITTI-format result files.

    python -m stereo_rcnn_tpu_torch.tools.serve --artifact model.pt2 \
        --left-dir image_2 --right-dir image_3 --calib-dir calib \
        --out results/ [--ckpt-dir runs/exp0] [--image-ext .npy]

Port of the JAX package's ``tools/serve.py``.  The inference side loads
one artifact of ``tools.export_model`` (network, NMS, 3D solve and dense
alignment inside); no model-building code runs here, only preprocessing,
``serving.load_pipeline`` and result IO.  Weights are a run-time input:
``<ckpt-dir>/params_export`` is loaded over the artifact's own weights
(strictly), so a new checkpoint serves without re-exporting; without
``--ckpt-dir`` the artifact's weights serve.  The config (pixel means,
class names) is ``--config``, else ``<ckpt-dir>/config.json``, else the
tiny config (``--tiny``) or ``Config()``.  Images are read by
``data.pipeline.load_image`` (``.npy`` needs no image codec), letterboxed
into the artifact's resolution by ``utils.host_preproc`` and batched at
the artifact's fixed batch, the tail padded with its last frame (pads are
never written).  Inputs go to the artifact's device.  Besides the overall
rate it prints the rate after the first batch, which pays one-off set-up,
with each batch's median read, call and write times.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", required=True)
    p.add_argument("--left-dir", required=True)
    p.add_argument("--right-dir", required=True)
    p.add_argument("--calib-dir", required=True)
    p.add_argument("--out", default="results")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--config", default=None,
                   help="config (.json or YAML; defaults to "
                        "<ckpt-dir>/config.json when present)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--image-ext", default=".png")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto: the CUDA card (raises without one); cpu")
    return p.parse_args(argv)


def read_batch(left_dir: str, right_dir: str, calib_dir: str,
               image_ext: str, ids, batch: int, h: int, w: int, means, dev):
    """Frames ``ids`` (``<id><image_ext>`` under the image directories,
    ``<id>.txt`` under ``calib_dir``) as one batch on ``dev``:
    ``(left, right, calib_batch, content_wh, scales)``, each image
    letterboxed into ``h`` x ``w``, the batch padded to ``batch`` with the
    last frame."""
    import torch

    from stereo_rcnn_tpu_torch.data.pipeline import load_image
    from stereo_rcnn_tpu_torch.geometry.calib import (StereoCalib,
                                                      read_kitti_calib)
    from stereo_rcnn_tpu_torch.utils.host_preproc import resize_subtract_pad
    frames = []
    for fid in ids:
        img_l = load_image(os.path.join(left_dir, fid + image_ext))
        img_r = load_image(os.path.join(right_dir, fid + image_ext))
        calib = read_kitti_calib(os.path.join(calib_dir, fid + ".txt"))
        sh, sw = img_l.shape[:2]
        scale = min(h / sh, w / sw)
        frames.append((resize_subtract_pad(img_l, h, w, scale, means),
                       resize_subtract_pad(img_r, h, w, scale, means),
                       calib.scale(scale),
                       np.asarray([sw * scale, sh * scale], np.float32),
                       scale))
    frames += [frames[-1]] * (batch - len(frames))  # fixed-shape tail

    def stack(xs):
        return torch.from_numpy(np.stack(xs).astype(np.float32)).to(dev)
    left, right, calibs, cwh, scales = zip(*frames)
    return (stack(left), stack(right),
            StereoCalib(*[stack(xs) for xs in zip(*calibs)]), stack(cwh),
            scales)


def run(args):
    """Serve the frames of ``args``; returns the loaded pipeline (with
    the weights it served)."""
    import torch

    from stereo_rcnn_tpu_torch.config import (Config, load_config,
                                              tiny_test_config)
    from stereo_rcnn_tpu_torch.device import resolve_device
    from stereo_rcnn_tpu_torch.evalkit import write_result_file
    from stereo_rcnn_tpu_torch.serving import load_pipeline
    from stereo_rcnn_tpu_torch.train.checkpoint import PARAMS_FILE

    dev = resolve_device(None if args.platform == "auto" else "cpu")
    t0 = time.time()
    with open(args.artifact, "rb") as f:
        pipe = load_pipeline(f.read())
    batch = pipe.manifest["batch"]
    h, w = pipe.manifest["image_hw"]
    print(f"artifact: batch={batch} image_hw=[{h}, {w}] "
          f"device={pipe.manifest['device']}, loaded in "
          f"{time.time() - t0:.1f}s")

    cfg_path = args.config
    if cfg_path is None and args.ckpt_dir:
        cand = os.path.join(args.ckpt_dir, "config.json")
        cfg_path = cand if os.path.exists(cand) else None
    cfg = (load_config(cfg_path) if cfg_path
           else tiny_test_config() if args.tiny else Config())
    if args.ckpt_dir:
        pipe.load_state_dict(torch.load(
            os.path.join(args.ckpt_dir, "params_export", PARAMS_FILE),
            map_location=dev, weights_only=True))
        print(f"weights: {args.ckpt_dir}/params_export")
    else:
        print("WARNING: the artifact's own weights (no --ckpt-dir)")

    ids = sorted(os.path.splitext(os.path.basename(p))[0] for p in
                 glob.glob(os.path.join(args.left_dir,
                                        f"*{args.image_ext}")))
    if not ids:
        raise SystemExit(f"no *{args.image_ext} under {args.left_dir}")
    print(f"{len(ids)} frames")
    means = cfg.backbone.pixel_means_bgr
    os.makedirs(args.out, exist_ok=True)

    t0 = time.perf_counter()
    done = 0
    stages = []             # per batch: (frames, read s, call s, write s)
    for start in range(0, len(ids), batch):
        chunk = ids[start:start + batch]
        t_read = time.perf_counter()
        il, ir, calib_b, cwh, scales = read_batch(
            args.left_dir, args.right_dir, args.calib_dir, args.image_ext,
            chunk, batch, h, w, means, dev)
        t_call = time.perf_counter()
        out = pipe(il, ir, calib_b, cwh)
        det = type(out.det)(*[x.cpu().numpy() for x in out.det])
        pos, ry = out.position.cpu().numpy(), out.ry.cpu().numpy()
        t_write = time.perf_counter()
        for b, fid in enumerate(chunk):         # pads are never written
            sel = np.nonzero(det.valid[b])[0]
            write_result_file(
                os.path.join(args.out, f"{fid}.txt"),
                [cfg.data.classes[c] for c in det.cls[b][sel]],
                det.box_left[b][sel] / scales[b], det.dims[b][sel],
                pos[b][sel], ry[b][sel], det.alpha[b][sel],
                det.score[b][sel])
            done += 1
        stages.append((len(chunk), t_call - t_read, t_write - t_call,
                       time.perf_counter() - t_write))
    dt = time.perf_counter() - t0
    print(f"served {done} frames in {dt:.1f}s ({done / dt:.2f} pairs/s) "
          f"-> {args.out}")
    print(f"first batch {sum(stages[0][1:]):.3f}s")
    if len(stages) > 1:
        # The first call pays one-off set-up (cuDNN plans, allocator), so
        # the rate a deployment sees is that of the batches after it.
        rest = stages[1:]
        n, sec = sum(s[0] for s in rest), [sum(s[1:]) for s in rest]
        print(f"after the first batch: {n} frames in {sum(sec):.3f}s "
              f"({n / sum(sec):.2f} pairs/s); per batch median "
              f"{np.median(sec) * 1e3:.1f} ms (min {min(sec) * 1e3:.1f}, "
              f"max {max(sec) * 1e3:.1f}): read "
              f"{np.median([s[1] for s in rest]) * 1e3:.1f}, call "
              f"{np.median([s[2] for s in rest]) * 1e3:.1f}, write "
              f"{np.median([s[3] for s in rest]) * 1e3:.1f} ms")
    return pipe


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
