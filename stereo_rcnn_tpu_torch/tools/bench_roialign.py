"""Microbenchmark of the port's stereo RoIAlign paths on one CUDA card.

    python -m stereo_rcnn_tpu_torch.tools.bench_roialign [--batch 16]
        [--rois 300] [--iters 20]

Port of the JAX package's ``tools/bench_roialign.py``: the same inputs
(``realistic_rois`` from ``np.random.RandomState(0)`` after the same
feature draw, a 4-level bf16 pyramid of 384x1280 with C=256 used for both
sides, and the right rois ``rois - [30, 0, 30, 0]``), timed with CUDA
events after a warm-up call.  For each line it prints ms per batch and
us per roi:

- K1 (``csrc/stereo_roi_align.cu``), packed output, in each sampling-weight
  mode: ``f32``, ``kron_bf16``, ``kron_hilo``;
- K4 (``csrc/stereo_roi_align_atlas.cu``) on packed atlases, the atlas
  packing of both sides alone (a torch copy), and the two together;
- the atlas gather (``ops/roi_align.py::multilevel_roi_align``, the
  ``roi_align_impl="xla"`` path): left and right 7x7 at sampling ratio 2
  and left 14x14 at ratio 1.

Left out of the JAX tool: ``bench_skip`` and ``group``, which ablate the
TPU kernel's DMA/compute pipeline and its grid steps (a CUDA kernel has
neither); the unpacked three-output K1 layout, which the port does not
have; and the two-matmul ``hat=bf16`` and ``hat=hilo`` modes, reachable
only through that tool and not ported yet.  It needs a CUDA card and
raises without one.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

STRIDES = (4, 8, 16, 32)


def realistic_rois(rng, n, im_h, im_w):
    """Car-like boxes across the level-assignment range."""
    out = []
    for _ in range(n):
        size = float(np.exp(rng.uniform(np.log(24), np.log(500))))
        ar = rng.uniform(0.8, 3.0)                    # w/h, car-like
        w = size * np.sqrt(ar)
        h = size / np.sqrt(ar)
        x1 = rng.uniform(0, max(im_w - w, 1))
        y1 = rng.uniform(0, max(im_h - h, 1))
        out.append([x1, y1, min(x1 + w, im_w - 1), min(y1 + h, im_h - 1)])
    return np.asarray(out, np.float32)


def events_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current CUDA stream
    (CUDA events around ``iters`` calls), after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None) -> dict:
    """Run the benchmark; returns ``{line: ms per batch}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--rois", type=int, default=300)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_roialign needs a CUDA device")
    from stereo_rcnn_tpu_torch.ops import stereo_roi_align as sra
    from stereo_rcnn_tpu_torch.ops.roi_align import multilevel_roi_align

    dev = torch.device("cuda", torch.cuda.current_device())
    im_h, im_w, c = 384, 1280, 256
    rng = np.random.RandomState(0)
    feats = [torch.from_numpy(rng.rand(args.batch, im_h // s, im_w // s, c))
             .to(dev).to(torch.bfloat16) for s in STRIDES]
    rois = torch.from_numpy(np.stack([
        realistic_rois(rng, args.rois, im_h, im_w)
        for _ in range(args.batch)])).to(dev)
    rois_r = rois - torch.tensor([30.0, 0.0, 30.0, 0.0], device=dev)
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    n_total = args.batch * args.rois
    name = torch.cuda.get_device_name(dev)
    print(f"batch={args.batch} rois={args.rois} ({n_total} rois per call), "
          f"C={c}, bf16 pyramid of {im_h}x{im_w}, {name}", flush=True)

    results = {}

    def timeit(line, fn):
        with torch.no_grad():
            ms = events_ms(fn, args.iters)
        results[line] = ms
        print(f"{line:30s} {ms:8.3f} ms/batch   "
              f"{ms * 1e3 / n_total:7.3f} us/roi", flush=True)

    for hat in sra.HAT_MODES:
        timeit(f"K1 packed {hat}", lambda hat=hat: sra.stereo_roi_align_packed(
            feats, feats, rois, rois_r, STRIDES, hat))
    atlas, _ = sra.pack_atlas(feats)
    timeit("K4 atlas packing (2 sides)",
           lambda: (sra.pack_atlas(feats), sra.pack_atlas(feats)))
    timeit("K4 atlas kernel", lambda: sra.stereo_roi_align_atlas_kernel(
        atlas, atlas, shapes, rois, rois_r, STRIDES))
    timeit("K4 atlas packing + kernel", lambda: sra.stereo_roi_align_atlas(
        feats, feats, rois, rois_r, STRIDES))

    def gather():
        return (multilevel_roi_align(feats, rois, STRIDES, 7, 2),
                multilevel_roi_align(feats, rois_r, STRIDES, 7, 2),
                multilevel_roi_align(feats, rois, STRIDES, 14, 1))
    timeit("xla atlas gather (3 aligns)", gather)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
