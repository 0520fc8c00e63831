"""Build the port's CUDA kernels and drive its inference and training paths
once on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit (``nvcc``).  Phases, each raising on failure:

1. environment: torch / CUDA versions, the card's name and power limit,
   TF32 off for matmuls and convolutions;
2. build both kernels, one ``nvcc`` per source, started together:
   K1 the fused stereo RoIAlign (csrc/stereo_roi_align.cu) and K2 its
   backward (csrc/stereo_roi_align_bwd.cu);
3. K1 against its plain PyTorch version at the level shapes of both
   paths (1280x384, C=256; 300 rois for inference, 128 at batch 8 for
   training) with edge-case rois, in bfloat16 and float32, both timed
   with CUDA events at batch 16;
4. K2 against its plain backward at the training shapes (batch 8, 128
   rois, C=256, bfloat16 levels) with edge-case rois, both timed, beside
   one ``index_add_`` of the same scatter;
5. the inference path: ``make_full_pipeline`` on ``Config()`` (ResNet-101,
   FPN 256, fc 2048, 1280x384, bf16) with random weights from seed 0 and
   rendered scenes (seed 7, 5 objects), at batch 16 and batch 1, with
   launch counts, shape and finiteness checks, and timings;
6. ``roi_features`` at batch 1 on the real backbone output, through the
   kernel and through the plain version;
7. the training path: ``make_train_step`` on ``synthetic_fullres_config()``
   (ResNet-101, GroupNorm, remat, 1280x384, bf16, 128 rois per image) at
   batch 8 on rendered scenes (seed 7, 5 objects), one warm-up step and
   three timed steps, each launching K1 and K2, with finite losses and
   the head, trunk and stem updated; the plain RoIAlign versions must not
   run;
8. one more training step under ``torch.profiler``: wall and device-busy
   time, the step's ranges (losses, backward, optimizer) and the ops with
   the most device time.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import concurrent.futures
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
# K2 vs plain backward: the same float32 terms summed in another order
# (atomics in K2, index_add_ in the plain version), relative to each
# level's largest |gradient|.
TOL_BWD = 1e-5
# H100 SXM device-memory rate (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12


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
    zero-area roi, a roi fully outside the image and a P5 roi beyond the
    image on every side."""
    xy = torch.rand(b, r, 2, generator=gen, device=dev) * \
        torch.tensor([1300.0, 400.0], device=dev) - 20.0
    wh = torch.rand(b, r, 2, generator=gen, device=dev) * \
        torch.tensor([500.0, 250.0], device=dev) + 2.0
    rois = torch.cat([xy, xy + wh], dim=-1)
    rois[:, :5] = torch.tensor([[100.0, 100.0, 400.0, 140.0],
                                [50.0, 100.0, 1250.0, 200.0],
                                [10.0, 10.0, 10.0, 10.0],
                                [1400.0, 500.0, 1500.0, 600.0],
                                [-100.0, -80.0, 1400.0, 500.0]], device=dev)
    return rois


def _level_bytes(b, c, itemsize):
    """Bytes of one side's P2..P5 at 1280x384."""
    return sum(b * (384 // s) * (1280 // s) * c * itemsize for s in STRIDES)


def _counting(module, name, counts):
    """Replace ``module.name`` with a wrapper that counts its calls."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)
    setattr(module, name, wrapper)
    return fn


def main() -> int:
    # -- 1. environment --------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs a CUDA device")
    from stereo_rcnn_tpu_torch import (Config, init_params,
                                       make_full_pipeline, synthetic_images)
    from stereo_rcnn_tpu_torch.config import synthetic_fullres_config
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
    from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
    from stereo_rcnn_tpu_torch.models.detector import roi_features
    from stereo_rcnn_tpu_torch.models.stereo_rpn import select_proposals
    from stereo_rcnn_tpu_torch.ops import stereo_roi_align as sra
    from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                             make_train_step)
    from stereo_rcnn_tpu_torch.train.losses import LOSS_NAMES
    from stereo_rcnn_tpu_torch.train.targets import ground_truth_to_torch

    k1, k2 = sra.stereo_roi_align_kernel, sra.stereo_roi_align_bwd_kernel
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
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(k.load) for k in (k1, k2)]:
            fut.result()
    print(f"build: {time.perf_counter() - t0:.1f} s for both kernels")
    for k in (k1, k2):
        print(f"  {k.source}: {k.build_info.seconds:.1f} s nvcc "
              f"({k.build_info.path})")
        for line in k.build_info.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    # -- 3. K1 vs plain version ------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    c = 256
    k1_err = 0.0
    # The inference path's shapes (300 rois, batch 16) and the training
    # path's (128 rois, batch 8).
    for b, r, dtype in ((2, 300, torch.bfloat16), (2, 300, torch.float32),
                        (16, 300, torch.bfloat16), (8, 128, torch.bfloat16)):
        fl = [torch.randn(b, 384 // s, 1280 // s, c, generator=gen,
                          device=dev).to(dtype) for s in STRIDES]
        fr = [torch.randn(b, 384 // s, 1280 // s, c, generator=gen,
                          device=dev).to(dtype) for s in STRIDES]
        rl = _edge_case_rois(gen, b, r, dev)
        rr = rl - torch.tensor([17.0, 0.0, 14.0, 0.0], device=dev)
        args = (fl, fr, rl, rr, STRIDES)
        before = k1.launches
        out = k1(*args)
        torch.cuda.synchronize()
        if k1.launches != before + 1:
            raise RuntimeError("K1 launch was not counted")
        ref = sra.stereo_roi_align_packed_ref(*args)
        err = (out - ref).abs().max().item()
        if not err <= TOL:
            raise RuntimeError(f"K1 {dtype} B={b}: max abs err {err:.3e} > "
                               f"{TOL:.0e}")
        if out[:, 2].abs().max().item() != 0.0:
            raise RuntimeError("zero-area roi did not give zeros")
        k1_err = max(k1_err, err)
        print(f"K1 {str(dtype):15s} B={b:2d} R={r} C={c}: max abs err "
              f"{err:.3e} (tol {TOL:.0e})", flush=True)
        if b == 16:
            k1_ms = _events_ms(lambda: k1(*args), 20)
            k1_plain_ms = _events_ms(
                lambda: sra.stereo_roi_align_packed_ref(*args), 5)
            # Each output written once, each level of both sides read once.
            k1_bound_ms = 1e3 * (out.numel() * 4 + 2 * _level_bytes(
                b, c, 2)) / HBM_BYTES_PER_S
            print(f"K1 time at batch 16, bf16: kernel {k1_ms:.3f} ms, "
                  f"plain {k1_plain_ms:.3f} ms, bound {k1_bound_ms:.3f} ms "
                  f"(bytes)  [{card}]", flush=True)
        del fl, fr, out, ref
    torch.cuda.empty_cache()

    # -- 4. K2 vs plain backward ------------------------------------------
    b, r = 8, 128
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    rl = _edge_case_rois(gen, b, r, dev)
    rr = rl - torch.tensor([17.0, 0.0, 14.0, 0.0], device=dev)
    g = torch.randn(b, r, sra.ROWS, c, generator=gen, device=dev)
    bargs = (g, rl, rr, shapes, STRIDES)
    before = k2.launches
    d_l, d_r = k2(*bargs)
    torch.cuda.synchronize()
    if k2.launches != before + 1:
        raise RuntimeError("K2 launch was not counted")
    r_l, r_r = sra.stereo_roi_align_packed_bwd_ref(*bargs)
    k2_err = 0.0
    for lvl, (ours, ref) in enumerate(zip(d_l + d_r, r_l + r_r)):
        scale = ref.abs().max().item()
        err = (ours - ref).abs().max().item()
        if not err <= TOL_BWD * scale:
            raise RuntimeError(f"K2 level {lvl}: max abs err {err:.3e} > "
                               f"{TOL_BWD:.0e} x {scale:.3e}")
        k2_err = max(k2_err, err)
    # A cotangent on the zero-area rois only gives an exactly zero gradient.
    g0 = torch.zeros_like(g)
    g0[:, 2] = g[:, 2]
    d0_l, d0_r = k2(g0, rl, rr, shapes, STRIDES)
    if any(d.any() for d in d0_l + d0_r):
        raise RuntimeError("K2: a zero-area roi changed the gradient")
    print(f"K2 B={b} R={r} C={c}: max abs err {k2_err:.3e} (tol "
          f"{TOL_BWD:.0e} x level max |grad|), zero-area rois inert",
          flush=True)
    k2_ms = _events_ms(lambda: k2(*bargs), 20)
    k2_plain_ms = _events_ms(
        lambda: sra.stereo_roi_align_packed_bwd_ref(*bargs), 5)
    # Library yardstick: one index_add_ of the same scatter into both
    # sides' gradients, its operands (the four weighted taps of every
    # sample) already formed: the part K2 spends its atomics on.
    total = b * sum(h * w for h, w in shapes)
    ops = sra.packed_bwd_contributions(*bargs)
    idx = torch.cat([i + side * total for side, taps in enumerate(ops)
                     for i, _ in taps])
    src = torch.cat([v for taps in ops for _, v in taps])
    acc = torch.zeros(2 * total, c, device=dev)
    lib_ms = _events_ms(lambda: acc.index_add_(0, idx, src), 20)
    del ops
    meta_l, _ = sra.roi_window_meta(shapes, rl, STRIDES)
    meta_r, _ = sra.roi_window_meta(shapes, rr, STRIDES)
    n_l = int((meta_l[..., 3] > 0).sum())
    n_r = int((meta_r[..., 3] > 0).sum())
    # Cotangent rows the valid rois need (left 196 + 49, right 49), each
    # gradient cell written once.
    k2_bytes = ((n_l * (sra.PK * sra.PK + sra.P * sra.P) +
                 n_r * sra.P * sra.P) * c * 4 +
                sum(d.numel() * 4 for d in d_l + d_r))
    k2_bound_ms = 1e3 * k2_bytes / HBM_BYTES_PER_S
    print(f"K2 time at batch 8, R=128: kernel {k2_ms:.3f} ms, plain "
          f"{k2_plain_ms:.3f} ms, index_add_ {lib_ms:.3f} ms, bound "
          f"{k2_bound_ms:.3f} ms (bytes, {k2_bytes / 1e6:.0f} MB); "
          f"{(n_l + n_r) * sra.PK * sra.PK * 4 * c / 1e6:.0f} M atomic "
          f"adds  [{card}]", flush=True)
    del g, g0, d_l, d_r, r_l, r_r, d0_l, d0_r, idx, src, acc
    torch.cuda.empty_cache()

    # -- 5. inference path -----------------------------------------------
    base = Config()
    cfg = dataclasses.replace(base, rcnn=dataclasses.replace(
        base.rcnn, roi_align_impl="pallas", roi_align_hat="f32"))
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    il, ir, calib = synthetic_images(cfg, 16, seed=7, n_objects=5)
    left = torch.from_numpy(il).to(dev)
    right = torch.from_numpy(ir).to(dev)
    fn = make_full_pipeline(cfg, calib)
    print(f"inference path: init + render {time.perf_counter() - t0:.1f} s;"
          f" depth {cfg.backbone.depth}, fpn {cfg.backbone.fpn_dim}, fc "
          f"{cfg.rcnn.fc_dim}, {cfg.data.image_w}x{cfg.data.image_h}, "
          f"{cfg.compute_dtype}", flush=True)

    d = cfg.rcnn.max_detections
    k1.launches = k2.launches = 0
    outs = {}
    for b in (16, 1):
        before = k1.launches
        out = fn(model, left[:b], right[:b])
        torch.cuda.synchronize()
        if k1.launches <= before:
            raise RuntimeError(f"batch {b}: K1 was not launched")
        outs[b] = out
    infer_launches = {"K1": k1.launches, "K2": k2.launches}
    for b, out in outs.items():
        shapes_out = {"position": (b, d, 3), "ry": (b, d),
                      "z_refined": (b, d), "box_left": (b, d, 4)}
        got = {"position": out.position.shape, "ry": out.ry.shape,
               "z_refined": out.z_refined.shape,
               "box_left": out.det.box_left.shape}
        if {k: tuple(v) for k, v in got.items()} != shapes_out:
            raise RuntimeError(f"batch {b}: shapes {got} != {shapes_out}")
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
    print(f"inference path: launches {infer_launches} in the batch-16 and "
          f"batch-1 calls")

    step16 = _events_ms(lambda: fn(model, left, right), 3)
    lat = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(model, left[:1], right[:1])
        stop.record()
        torch.cuda.synchronize()
        lat.append(start.elapsed_time(stop))
    p50 = sorted(lat)[len(lat) // 2]
    print(f"inference path: {16 * 1000.0 / step16:.2f} pairs/s at batch 16 "
          f"({step16:.1f} ms/step), p50 {p50:.1f} ms at batch 1  [{card}]",
          flush=True)

    # -- 6. roi_features on the real backbone output ---------------------
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
        plain = sra.stereo_roi_align_packed_ref(fl[:4], fr[:4], props.left,
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
    del model, fn, outs, feats, fl, fr, ours, plain, rows, left, right
    torch.cuda.empty_cache()

    # -- 7. training path -------------------------------------------------
    cfg = synthetic_fullres_config()
    b = cfg.train.batch_per_device
    t0 = time.perf_counter()
    il, ir, gt, _ = synthetic_batch(cfg, b, seed=7, n_objects=5)
    batch = Batch(torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev),
                  ground_truth_to_torch(gt, dev))
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    step = make_train_step(cfg, device=dev)
    tgen = torch.Generator(device=dev).manual_seed(0)
    print(f"training path: init + render {time.perf_counter() - t0:.1f} s;"
          f" depth {cfg.backbone.depth}, norm {cfg.backbone.norm}, remat "
          f"{cfg.backbone.remat}, fpn {cfg.backbone.fpn_dim}, fc "
          f"{cfg.rcnn.fc_dim}, {cfg.data.image_w}x{cfg.data.image_h}, "
          f"{cfg.compute_dtype}, batch {b}, {cfg.rcnn.rois_per_image} rois "
          f"per image", flush=True)
    watched = ("rcnn_head.RCNN_fc6.weight",
               "backbone_net.RCNN_layer4.0.conv2.weight",
               "backbone_net.RCNN_layer0.0.weight")
    params = dict(state.model.named_parameters())
    plain_calls = {}
    originals = {name: _counting(sra, name, plain_calls)
                 for name in ("stereo_roi_align_packed_ref",
                              "stereo_roi_align_packed_bwd_ref")}
    try:
        metrics = step(state, batch, tgen)                # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = k2.launches = 0
        step_ms = []
        for i in range(3):
            snap = {n: params[n].detach().clone() for n in watched}
            l1, l2 = k1.launches, k2.launches
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(state, batch, tgen)
            stop.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(stop))
            if k1.launches <= l1 or k2.launches <= l2:
                raise RuntimeError(f"training step {i}: K1 launches "
                                   f"{k1.launches - l1}, K2 "
                                   f"{k2.launches - l2}")
            vals = {k: float(metrics[k]) for k in (*LOSS_NAMES, "total",
                                                   "grad_norm")}
            if not all(map(lambda v: v == v and abs(v) < float("inf"),
                           vals.values())):
                raise RuntimeError(f"training step {i}: non-finite {vals}")
            moved = {n: (params[n].detach() - snap[n]).abs().max().item()
                     for n in watched}
            if not all(v > 0 for v in moved.values()):
                raise RuntimeError(f"training step {i}: not updated {moved}")
            print(f"train step {i}: {step_ms[-1]:.1f} ms, "
                  + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
                  + f", fg rpn {float(metrics['num_fg_rpn']):.1f} rcnn "
                  f"{float(metrics['num_fg_rcnn']):.1f}", flush=True)
    finally:
        for name, fn_ in originals.items():
            setattr(sra, name, fn_)
    train_launches = {"K1": k1.launches, "K2": k2.launches}
    if plain_calls:
        raise RuntimeError(f"plain RoIAlign versions ran in training: "
                           f"{plain_calls}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = sorted(step_ms)[1]
    print(f"training path: launches {train_launches} in 3 steps, plain "
          f"versions 0 calls")
    print(f"training path: {ms:.1f} ms/step (median of {len(step_ms)}: "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}), {b * 1000.0 / ms:.2f}"
          f" pairs/s at batch {b}, peak memory {peak:.2f} GiB  [{card}]",
          flush=True)

    # -- 8. where one training step's time goes ---------------------------
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, tgen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ranges = ("train/losses", "train/backward", "train/optimizer")
    # Device events are kernels, copies and fills, plus the device-side
    # annotation of each range, which spans other events: leave those out.
    on_dev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in ranges
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in on_dev) / 1e3
    ours = sum(e.time_range.elapsed_us() for e in on_dev
               if "stereo_roi_align" in e.name) / 1e3
    print(f"training profile (one step under the profiler): wall {wall:.1f}"
          f" ms, device busy {busy:.1f} ms (sum of {len(on_dev)} device "
          f"events), idle share {1.0 - busy / wall:.2f} of the profiled "
          f"step, {1.0 - busy / ms:.2f} of the {ms:.1f} ms step timed above;"
          f" K1 + K2 kernels {ours:.2f} ms  [{card}]")

    def dev_ms(a):
        return getattr(a, "device_time_total",
                       getattr(a, "cuda_time_total", 0.0)) / 1e3

    def self_dev_ms(a):
        return getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0.0)) / 1e3
    averages = prof.key_averages()
    # A range shows up twice, as a host range and as its device
    # annotation; kernels the autograd engine's thread launches (the
    # backward's) are not attributed to the caller's range.
    for name in ranges:
        rows = [a for a in averages if a.key == name]
        host = max((a.cpu_time_total for a in rows), default=0.0) / 1e3
        device = max((dev_ms(a) for a in rows), default=0.0)
        print(f"  range {name:16s} host {host:8.1f} ms, device "
              f"{device:8.1f} ms")
    ops = [a for a in averages if a.key.startswith("aten::")]
    for a in sorted(ops, key=self_dev_ms, reverse=True)[:12]:
        print(f"  op {a.key[:40]:40s} {self_dev_ms(a):8.2f} ms device, "
              f"{a.count} calls")

    launches = {k: infer_launches[k] + train_launches[k] for k in ("K1", "K2")}
    print(json.dumps({"kernels": [{
        "name": "stereo_roi_align_fwd", "route": "cuda",
        "source": "stereo_rcnn_tpu_torch/csrc/stereo_roi_align.cu",
        "replaces": "stereo_rcnn_tpu/ops/roi_align_pallas.py:359",
        "launches": launches["K1"],
        "launches_by_path": {"inference": infer_launches["K1"],
                             "training": train_launches["K1"]},
        "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound_ms, "bound_by": "bytes", "library_ms": None,
    }, {
        "name": "stereo_roi_align_bwd", "route": "cuda",
        "source": "stereo_rcnn_tpu_torch/csrc/stereo_roi_align_bwd.cu",
        "replaces": "stereo_rcnn_tpu/ops/roi_align_pallas.py:874",
        "launches": launches["K2"],
        "launches_by_path": {"inference": infer_launches["K2"],
                             "training": train_launches["K2"]},
        "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
