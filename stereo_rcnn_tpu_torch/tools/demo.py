"""Demo: run the full pipeline on one stereo pair and draw its 2D box
pairs, keypoints, projected 3D boxes and a bird's-eye view into a PNG.

    python -m stereo_rcnn_tpu_torch.tools.demo --left l.npy --right r.npy \
        --calib calib.txt [--ckpt-dir runs/exp0] [--out demo_out.png]
    python -m stereo_rcnn_tpu_torch.tools.demo --synthetic [--tiny]

Port of the JAX package's ``tools/demo.py`` with its flags and its three
panels, stacked top to bottom: the left image with the 2D boxes (lime),
each detection's keypoint column (red) and its projected 3D wireframe
(yellow); the right image with the paired boxes (cyan); the bird's-eye
view, x in [-30, 30] m across and z in [0, 60] m up, with each box's
footprint (green).  The panels are drawn with numpy and the PNG written
with ``zlib`` and ``struct`` (the card's machine has no matplotlib, PIL or
cv2).  ``--synthetic`` renders a scene (seed 42) for ``Config()`` (its
atlas-gather RoIAlign) or, with ``--tiny``, the tiny config; without a
checkpoint the weights are random (seed 0).  ``--ckpt-dir`` restores a
``tools.train`` checkpoint, with its ``config.json`` when present.  It
runs on the CUDA card (``--platform auto``, which raises without one) or
on the CPU (``--platform cpu``).
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import zlib

import numpy as np

LIME, CYAN, RED, YELLOW, GREEN = ((0, 255, 0), (0, 255, 255), (255, 0, 0),
                                  (255, 255, 0), (0, 128, 0))
# Wireframe edges over box3d_corners' order (bottom face 0..3, top k + 4).
EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7))
BEV_X, BEV_Z = (-30.0, 30.0), (0.0, 60.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--left")
    p.add_argument("--right")
    p.add_argument("--calib")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--out", default="demo_out.png")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto: the CUDA card (raises without one); cpu")
    return p.parse_args(argv)


def _pixel(v) -> int:
    return int(np.floor(v + 0.5))


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """A one-pixel line from ``p0`` to ``p1`` ((x, y) pixels), clipped to
    the image; a non-finite end draws nothing."""
    (x0, y0), (x1, y1) = p0, p1
    if not np.isfinite([x0, y0, x1, y1]).all():
        return
    h, w = img.shape[:2]
    n = int(min(max(abs(x1 - x0), abs(y1 - y0)), 4 * (h + w))) + 1
    t = np.linspace(0.0, 1.0, n + 1)
    xs = np.floor(x0 + t * (x1 - x0) + 0.5).astype(np.int64)
    ys = np.floor(y0 + t * (y1 - y0) + 0.5).astype(np.int64)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def draw_box(img: np.ndarray, box, color) -> None:
    """The outline of an xyxy box, its corners at the rounded corners."""
    x1, y1, x2, y2 = (_pixel(v) for v in box)
    for a, b in (((x1, y1), (x2, y1)), ((x2, y1), (x2, y2)),
                 ((x2, y2), (x1, y2)), ((x1, y2), (x1, y1))):
        draw_line(img, a, b, color)


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG, every row unfiltered."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                         axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" +
                chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) +
                chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def bev_side(h: int, w: int) -> int:
    """The bird's-eye panel's side (a square centred in a w-wide band)."""
    return min(w, 2 * h)


def render(images_left, images_right, means, det, position, ry, calib):
    """The three panels stacked: uint8 RGB ``[2 H + S, W, 3]``.  ``det`` and
    the solved boxes are numpy arrays of one image; ``calib`` its
    working-resolution ``StereoCalib``."""
    import torch

    from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
    from stereo_rcnn_tpu_torch.geometry.projection import (box3d_corners,
                                                           project)
    h, w = images_left.shape[:2]
    means = np.asarray(means, np.float32)
    left = np.clip(images_left + means, 0, 255).astype(np.uint8)[..., ::-1]
    right = np.clip(images_right + means, 0, 255).astype(np.uint8)[..., ::-1]
    left, right = left.copy(), right.copy()
    s = bev_side(h, w)
    bev = np.full((s, w, 3), 255, np.uint8)
    x0 = (w - s) // 2
    cal = StereoCalib(*[float(v) if np.ndim(v) == 0 else v for v in calib])
    valid = np.nonzero(det.valid)[0]
    corners = box3d_corners(torch.from_numpy(position[valid]),
                            torch.from_numpy(det.dims[valid]),
                            torch.from_numpy(ry[valid]))        # [n, 8, 3]
    uv = project(corners, cal).numpy()
    corners = corners.numpy()
    for k, i in enumerate(valid):
        for a, b in EDGES:
            draw_line(left, uv[k, a], uv[k, b], YELLOW)
        bl = det.box_left[i]
        draw_line(left, (det.kpt_u[i], bl[1]), (det.kpt_u[i], bl[3]), RED)
        foot = corners[k, :4][:, [0, 2]]
        px = x0 + (foot[:, 0] - BEV_X[0]) / (BEV_X[1] - BEV_X[0]) * (s - 1)
        pz = (BEV_Z[1] - foot[:, 1]) / (BEV_Z[1] - BEV_Z[0]) * (s - 1)
        for j in range(4):
            draw_line(bev, (px[j], pz[j]), (px[(j + 1) % 4], pz[(j + 1) % 4]),
                      GREEN)
    for i in valid:                      # the 2D boxes on top
        draw_box(left, det.box_left[i], LIME)
        draw_box(right, det.box_right[i], CYAN)
    return np.concatenate([left, right, bev], axis=0)


def run(args):
    """Detect, draw and write ``args.out``; returns ``(det, panels)``, the
    detections of the pair as numpy arrays and the image written."""
    if not args.synthetic and not (args.left and args.right and args.calib):
        raise SystemExit("error: provide --left/--right/--calib, or "
                         "--synthetic")
    import torch

    from stereo_rcnn_tpu_torch.config import (Config, load_config,
                                              tiny_test_config)
    from stereo_rcnn_tpu_torch.device import resolve_device
    from stereo_rcnn_tpu_torch.inference import make_full_pipeline

    dev = resolve_device(None if args.platform == "auto" else "cpu")
    cfg = tiny_test_config() if args.tiny else Config()
    if args.ckpt_dir and os.path.exists(os.path.join(args.ckpt_dir,
                                                     "config.json")):
        cfg = load_config(os.path.join(args.ckpt_dir, "config.json"))
    h, w = cfg.data.image_h, cfg.data.image_w
    means = cfg.backbone.pixel_means_bgr

    if args.synthetic:
        from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
        il, ir, calib = synthetic_images(cfg, 1, seed=42)
    else:
        from stereo_rcnn_tpu_torch.data.pipeline import load_image
        from stereo_rcnn_tpu_torch.geometry.calib import read_kitti_calib
        from stereo_rcnn_tpu_torch.utils.host_preproc import \
            resize_subtract_pad
        img_l, img_r = load_image(args.left), load_image(args.right)
        sh, sw = img_l.shape[:2]
        scale = min(h / sh, w / sw)
        calib = read_kitti_calib(args.calib).scale(scale)
        il = resize_subtract_pad(img_l, h, w, scale, means)[None]
        ir = resize_subtract_pad(img_r, h, w, scale, means)[None]

    if args.ckpt_dir:
        from stereo_rcnn_tpu_torch.train.checkpoint import \
            restore_train_state
        model = restore_train_state(args.ckpt_dir, cfg, dev).model.eval()
    else:
        from stereo_rcnn_tpu_torch.models.detector import init_params
        print("WARNING: random weights (no --ckpt-dir)")
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)

    out = make_full_pipeline(cfg, calib)(model, torch.from_numpy(il).to(dev),
                                         torch.from_numpy(ir).to(dev))
    det = type(out.det)(*[x[0].cpu().numpy() for x in out.det])
    print(f"{int(det.valid.sum())} detections")
    panels = render(il[0], ir[0], means, det, out.position[0].cpu().numpy(),
                    out.ry[0].cpu().numpy(), calib)
    write_png(args.out, panels)
    print(f"wrote {args.out} ({panels.shape[1]}x{panels.shape[0]})")
    return det, panels


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
