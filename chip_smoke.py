"""Build the port's CUDA kernel and drive its inference path once on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit (``nvcc``).  Phases, each raising on failure:

1. environment: torch / CUDA versions, the card's name and power limit,
   TF32 off for matmuls and convolutions;
2. build the fused stereo RoIAlign kernel (csrc/stereo_roi_align.cu);
3. the kernel against its plain PyTorch version at the main path's level
   shapes (1280x384, C=256, 300 rois) with edge-case rois, in bfloat16
   and float32, and both timed with CUDA events at batch 16;
4. the main path: ``make_full_pipeline`` on ``Config()`` (ResNet-101,
   FPN 256, fc 2048, 1280x384, bf16) with random weights from seed 0 and
   rendered scenes (seed 7, 5 objects), at batch 16 and batch 1, with
   launch counts, shape and finiteness checks, and timings;
5. ``roi_features`` at batch 1 on the real backbone output, through the
   kernel and through the plain version.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

STRIDES = (4, 8, 16, 32)
# Kernel vs plain version: both read the same features and accumulate in
# float32; they differ in where the compiler fuses multiply-adds, so a
# sample position can differ by an ulp.  Bound: 1e-4 absolute on
# unit-scale features, 1e-4 relative to the largest value on real ones.
TOL = 1e-4


def _events_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the device, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _edge_case_rois(gen, b, r, dev):
    """Random rois of realistic sizes plus: a 300x40 px roi (P2, 75 cells,
    wider than its 64-cell window), a 1200x100 px roi (P4, 75 cells), a
    zero-area roi and a roi fully outside the image."""
    xy = torch.rand(b, r, 2, generator=gen, device=dev) * \
        torch.tensor([1300.0, 400.0], device=dev) - 20.0
    wh = torch.rand(b, r, 2, generator=gen, device=dev) * \
        torch.tensor([500.0, 250.0], device=dev) + 2.0
    rois = torch.cat([xy, xy + wh], dim=-1)
    rois[:, :4] = torch.tensor([[100.0, 100.0, 400.0, 140.0],
                                [50.0, 100.0, 1250.0, 200.0],
                                [10.0, 10.0, 10.0, 10.0],
                                [1400.0, 500.0, 1500.0, 600.0]], device=dev)
    return rois


def main() -> int:
    # -- 1. environment --------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs a CUDA device")
    from stereo_rcnn_tpu_torch import (Config, init_params,
                                       make_full_pipeline, synthetic_images)
    from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
    from stereo_rcnn_tpu_torch.models.detector import roi_features
    from stereo_rcnn_tpu_torch.models.stereo_rpn import select_proposals
    from stereo_rcnn_tpu_torch.ops.stereo_roi_align import (
        stereo_roi_align_kernel as kernel, stereo_roi_align_packed_ref)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}")
    print(f"card: {card}")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}  "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernel.load()
    print(f"build: {kernel.build_info.seconds:.1f} s nvcc, "
          f"{time.perf_counter() - t0:.1f} s to load "
          f"({kernel.build_info.path})")
    for line in kernel.build_info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. kernel vs plain version --------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    c, r = 256, 300
    max_err = 0.0
    for b, dtype in ((2, torch.bfloat16), (2, torch.float32),
                     (16, torch.bfloat16)):
        fl = [torch.randn(b, 384 // s, 1280 // s, c, generator=gen,
                          device=dev).to(dtype) for s in STRIDES]
        fr = [torch.randn(b, 384 // s, 1280 // s, c, generator=gen,
                          device=dev).to(dtype) for s in STRIDES]
        rl = _edge_case_rois(gen, b, r, dev)
        rr = rl - torch.tensor([17.0, 0.0, 14.0, 0.0], device=dev)
        args = (fl, fr, rl, rr, STRIDES)
        before = kernel.launches
        out = kernel(*args)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise RuntimeError("kernel launch was not counted")
        ref = stereo_roi_align_packed_ref(*args)
        err = (out - ref).abs().max().item()
        if not err <= TOL:
            raise RuntimeError(f"K1 {dtype} B={b}: max abs err {err:.3e} > "
                               f"{TOL:.0e}")
        if out[:, 2].abs().max().item() != 0.0:
            raise RuntimeError("zero-area roi did not give zeros")
        max_err = max(max_err, err)
        print(f"K1 {str(dtype):15s} B={b:2d} R={r} C={c}: max abs err "
              f"{err:.3e} (tol {TOL:.0e}), launches {kernel.launches}",
              flush=True)
        if b == 16:
            k_ms = _events_ms(lambda: kernel(*args), 20)
            plain_ms = _events_ms(
                lambda: stereo_roi_align_packed_ref(*args), 5)
            print(f"K1 time at batch 16, bf16: kernel {k_ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms  [{card}]", flush=True)
        del fl, fr, out, ref
    torch.cuda.empty_cache()

    # -- 4. main path ----------------------------------------------------
    base = Config()
    cfg = dataclasses.replace(base, rcnn=dataclasses.replace(
        base.rcnn, roi_align_impl="pallas", roi_align_hat="f32"))
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    il, ir, calib = synthetic_images(cfg, 16, seed=7, n_objects=5)
    left = torch.from_numpy(il).to(dev)
    right = torch.from_numpy(ir).to(dev)
    fn = make_full_pipeline(cfg, calib)
    print(f"main path: init + render {time.perf_counter() - t0:.1f} s; "
          f"depth {cfg.backbone.depth}, fpn {cfg.backbone.fpn_dim}, fc "
          f"{cfg.rcnn.fc_dim}, {cfg.data.image_w}x{cfg.data.image_h}, "
          f"{cfg.compute_dtype}", flush=True)

    d = cfg.rcnn.max_detections
    kernel.launches = 0
    outs = {}
    for b in (16, 1):
        before = kernel.launches
        out = fn(model, left[:b], right[:b])
        torch.cuda.synchronize()
        if kernel.launches <= before:
            raise RuntimeError(f"batch {b}: the kernel was not launched")
        outs[b] = out
    main_launches = kernel.launches
    for b, out in outs.items():
        shapes = {"position": (b, d, 3), "ry": (b, d),
                  "z_refined": (b, d), "box_left": (b, d, 4)}
        got = {"position": out.position.shape, "ry": out.ry.shape,
               "z_refined": out.z_refined.shape,
               "box_left": out.det.box_left.shape}
        if {k: tuple(v) for k, v in got.items()} != shapes:
            raise RuntimeError(f"batch {b}: shapes {got} != {shapes}")
        valid = out.det.valid
        for name in ("position", "ry", "z_refined", "residual"):
            if not torch.isfinite(getattr(out, name)[valid]).all():
                raise RuntimeError(f"batch {b}: non-finite {name}")
        for name in ("box_left", "box_right", "score", "dims", "kpt_u"):
            if not torch.isfinite(getattr(out.det, name)[valid]).all():
                raise RuntimeError(f"batch {b}: non-finite det.{name}")
        print(f"batch {b:2d}: n_det {int(valid.sum())} of {b * d}, "
              f"finite", flush=True)
    if outs[16].det.valid.sum() == 0:
        raise RuntimeError("no detections at batch 16")
    print(f"main path: {main_launches} kernel launches in the batch-16 and "
          f"batch-1 calls")

    step16 = _events_ms(lambda: fn(model, left, right), 5)
    lat = []
    for _ in range(11):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(model, left[:1], right[:1])
        stop.record()
        torch.cuda.synchronize()
        lat.append(start.elapsed_time(stop))
    p50 = sorted(lat)[len(lat) // 2]
    print(f"main path: {16 * 1000.0 / step16:.2f} pairs/s at batch 16 "
          f"({step16:.1f} ms/step), p50 {p50:.1f} ms at batch 1  [{card}]",
          flush=True)

    # -- 5. roi_features on the real backbone output ---------------------
    with torch.no_grad():
        b = 1
        feats = model.backbone(torch.cat([left[:b], right[:b]]))
        fl, fr = [f[:b] for f in feats], [f[b:] for f in feats]
        logits, deltas = model.rpn(fl, fr)
        props = select_proposals(
            logits, deltas,
            generate_anchors(cfg.anchors, 384, 1280, cfg.box_off, dev),
            384, 1280, cfg.rpn, False, cfg.box_off)
        ours = roi_features(model, fl, fr, props.left, props.right)
        plain = stereo_roi_align_packed_ref(fl[:4], fr[:4], props.left,
                                            props.right, STRIDES)
    rows = ours["left_kpt_rows"].reshape(plain.shape)
    diff = (rows - plain).abs().max().item()
    scale = max(plain.abs().max().item(), 1.0)
    if not diff <= TOL * scale:
        raise RuntimeError(f"roi_features: kernel vs plain {diff:.3e} > "
                           f"{TOL:.0e} x {scale:.3e}")
    print(f"roi_features batch 1 ({int(props.valid.sum())} valid rois): "
          f"kernel vs plain max abs diff {diff:.3e} (tol {TOL:.0e} x max "
          f"{scale:.3e})")

    print(json.dumps({"kernels": [{
        "name": "stereo_roi_align_fwd", "route": "cuda",
        "source": "stereo_rcnn_tpu_torch/csrc/stereo_roi_align.cu",
        "replaces": "stereo_rcnn_tpu/ops/roi_align_pallas.py:359",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
