"""Build the port's CUDA kernels and drive its inference, training and
RoIAlign-benchmark paths once on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit (``nvcc``).  Phases, each raising on failure:

1. environment: torch / CUDA versions, the card's name and power limit,
   TF32 off for matmuls and convolutions;
2. build the four kernels, one ``nvcc`` per source, started together: K1
   the fused stereo RoIAlign in its five sampling-weight modes
   (csrc/stereo_roi_align.cu), K2 its backward
   (csrc/stereo_roi_align_bwd.cu), K3 the windowed one-sided RoIAlign
   (csrc/roi_align_window.cu) and K4 the atlas variant
   (csrc/stereo_roi_align_atlas.cu);
3. K1 in each mode (f32, kron_bf16, kron_hilo, and the tool-only
   two-matmul modes bf16 and hilo) against its plain PyTorch version at
   the level shapes of both paths (1280x384, C=256; 300 rois for
   inference, 128 at batch 8 for training) with edge-case rois, in
   bfloat16 and float32, all timed at batch 16 (kernel device time and
   wrapper call);
4. K2 against its plain backward at the training shapes (batch 8, 128
   rois, C=256, bfloat16 levels) with edge-case rois; two launches must
   give the same bits; timed beside the plain version and one
   ``index_add_`` of the same scatter;
5. K3 through its entry point ``multilevel_roi_align_window`` (batched and
   unbatched) against its plain version at 1280x384, C=256, batch 16, 300
   rois, (P, s) = (7, 2) and (14, 1), bfloat16 and float32, timed;
6. K4 against its plain version and against K1 f32 at batch 16, 300 rois,
   timed beside a store-only floor (the three outputs zeroed), its atlas
   packing timed apart;
7. the inference path, ``make_full_pipeline`` at full width (ResNet-101,
   FPN 256, fc 2048, 1280x384, bf16; one random model from seed 0 and
   rendered scenes, seed 7, 5 objects, reused) in three configurations,
   each at batch 16 and batch 1 with launch counts, shape and finiteness
   checks: ``bench.py``'s program (``roi_align_impl="pallas"``,
   ``kron_bf16``), ``Config()`` itself (``"xla"``, the atlas gather: no
   kernel launch) and the fused kernel with f32 weights; the plain
   RoIAlign versions must not run; then pairs/s at batch 16 and p50 at
   batch 1 of each, timed in two turns (in order, then reversed), the
   time of each stage, and the RoIAlign stage alone at batch 16 on the
   real backbone output (gather, K1 f32, K1 kron_bf16); K1 against its
   plain version there at batch 1;
8. the training path: ``make_train_step`` on ``synthetic_fullres_config()``
   (ResNet-101, GroupNorm, remat, 1280x384, bf16, 128 rois per image) at
   batch 8 on rendered scenes (seed 7, 5 objects), one warm-up step and
   three timed steps (each with the host's time to enqueue it), each
   launching K1 and K2, with finite losses and the head, trunk and stem
   updated; the plain RoIAlign versions must not run; then one warm-up and
   one timed step of the same config with ``roi_align_impl="xla"`` (the
   gather's own gradient; K1 and K2 launch 0 times);
9. one more fused-path training step under ``torch.profiler``: wall and
   device-busy time, the step's ranges and the ops with the most device
   time;
10. the RoIAlign microbenchmark tool,
    ``stereo_rcnn_tpu_torch.tools.bench_roialign`` with ``--iters 5``: K1
    in each of its five modes, K4 (and its packing) and the gather; every
    K1 mode and K4 must launch.

Times of the kernels' previous versions (the atomic K2, the two-channel
K4 and the wrappers that copied their tables to the card on every call;
"NVIDIA H100 80GB HBM3, 700.00 W", PERF.md) are printed beside the new
ones for comparison; they are constants, not measured here.

Every phase's wall seconds are printed.  The line before the last is the
kernels' JSON record; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero and prints no result.

    python3 chip_smoke.py --training-only [--train-steps N]

runs phases 1, 2, 8 and 9 alone, with N timed steps on the fused path
(default 3), and prints no result line: the step time varies with the
host, so comparing two commits takes several such runs in turns.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import re
import subprocess
import sys
import time

import torch

from stereo_rcnn_tpu_torch.tools.bench_roialign import events_ms as _events_ms

STRIDES = (4, 8, 16, 32)
# Kernel vs plain version, f32 sampling weights (K1, K3, K4): both read the
# same features and accumulate in float32; they differ in where the
# compiler fuses multiply-adds, so a sample can differ in its last bits.
# Bound: 1e-4 absolute on unit-scale features, 1e-4 relative to the
# largest value on real ones.
TOL = 1e-4
# K1's kron modes vs their plain version: the same rounded weights (both
# round the position once and the hats as the JAX kernel does), summed in
# another order: 1e-5 absolute on unit-scale features.
TOL_KRON = 1e-5
# K1's two-matmul modes vs their plain version: the same rounded hats, but
# the plain y-pass is a cuBLAS product whose float32 sums may run in
# another order, and a bf16 intermediate one rounding from a bf16 boundary
# then moves by a bf16 step: at most 2^-7 of the largest |feature| (the
# x-hats sum to 1).  Every value within 2^-6 of it, and all but
# TOL_2MM_ROWS of the rows within TOL_KRON (0.011 % measured on an H100:
# a tenth of the bound, so that a fault on one level's few rois shows).
TOL_2MM = 2.0 ** -6
TOL_2MM_ROWS = 0.001
# K2 vs plain backward: the same float32 terms, K2 fusing each term's
# multiply into its add and summing per cell in roi, sample and tap order
# (index_add_ in the plain version), relative to each level's largest
# |gradient|.
TOL_BWD = 1e-5
# The previous versions' times (on "NVIDIA H100 80GB HBM3, 700.00 W",
# PERF.md): kernel device ms and wrapper call ms.
PREVIOUS_MS = {"K1": (1.106, 2.234), "K2": (0.947, 2.225),
               "K4": (1.409, 2.777)}
# H100 SXM device-memory rate (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12


def _device_ms(fn, iters: int, kernel: str) -> float:
    """Mean device time (ms) per call of the CUDA kernel function named
    ``kernel``, from ``torch.profiler``'s device events over ``iters``
    calls of ``fn`` after one warm-up: the wrapper's host work (its
    metadata tables, whose host-to-device copies wait for the stream) and
    the gaps it leaves between launches do not count."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    named = re.compile(rf"\b{kernel}[<(]")
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and named.search(e.name)]
    # The profiler can drop an event now and then (its buffers are cleared
    # per cycle): average what it saw, but more than one launch per call
    # means the name matches another kernel.
    if not 0 < len(times) <= iters:
        raise RuntimeError(f"profiler saw {len(times)} launches of {kernel} "
                           f"in {iters} calls")
    return sum(times) / len(times) / 1e3


def _clocks() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi):
    a latency-bound kernel's time follows the SM clock."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _bound_ms(n_bytes: float) -> float:
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def _edge_case_rois(gen, b, r, dev):
    """Random rois of realistic sizes (many under 56 px, whose samples at
    P2 are under one cell apart) plus: a 300x40 px roi (P2, 75 cells,
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


def _levels(gen, b, c, dtype, dev):
    return [torch.randn(b, 384 // s, 1280 // s, c, generator=gen,
                        device=dev).to(dtype) for s in STRIDES]


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


class _PlainCalls:
    """Counts the calls of the plain RoIAlign versions while active."""

    NAMES = ("stereo_roi_align_packed_ref", "stereo_roi_align_packed_bwd_ref")

    def __init__(self, module):
        self.module = module
        self.calls = {}

    def __enter__(self):
        self.originals = {n: _counting(self.module, n, self.calls)
                          for n in self.NAMES}
        return self.calls

    def __exit__(self, *exc):
        for name, fn in self.originals.items():
            setattr(self.module, name, fn)


def _k1_error(out, ref, hat, feats):
    """K1's max abs error against its plain version, raising beyond the
    mode's tolerance (the two-matmul modes: :data:`TOL_2MM`)."""
    diff = (out - ref).abs()
    e = diff.max().item()
    if hat in ("bf16", "hilo"):
        scale = max(f.abs().max().item() for f in feats)
        off = (diff.amax(-1) > TOL_KRON).float().mean().item()
        if not (e <= TOL_2MM * scale and off <= TOL_2MM_ROWS):
            raise RuntimeError(f"K1 {hat}: max abs err {e:.3e} > {TOL_2MM} x "
                               f"{scale:.3e}, or {off:.2%} of the rows beyond"
                               f" {TOL_KRON:.0e}")
        return e, f"tol {TOL_2MM} x max|feature|, {off:.3%} of rows > " \
                  f"{TOL_KRON:.0e}"
    tol = TOL if hat == "f32" else TOL_KRON
    if not e <= tol:
        raise RuntimeError(f"K1 {hat}: max abs err {e:.3e} > {tol:.0e}")
    return e, f"tol {tol:.0e}"


def check_k1(sra, dev, gen, card):
    """Phase 3: K1 in every mode against its plain version."""
    k1 = sra.stereo_roi_align_kernel
    c = 256
    err = dict.fromkeys(sra.TOOL_HAT_MODES, 0.0)
    ms, call_ms, plain_ms = {}, {}, {}
    bound = None
    # The inference path's shapes (300 rois, batch 16) and the training
    # path's (128 rois, batch 8).
    for b, r, dtype in ((2, 300, torch.bfloat16), (2, 300, torch.float32),
                        (16, 300, torch.bfloat16), (8, 128, torch.bfloat16)):
        fl, fr = _levels(gen, b, c, dtype, dev), _levels(gen, b, c, dtype, dev)
        rl = _edge_case_rois(gen, b, r, dev)
        rr = rl - torch.tensor([17.0, 0.0, 14.0, 0.0], device=dev)
        for hat in sra.TOOL_HAT_MODES:
            args = (fl, fr, rl, rr, STRIDES, hat)
            before = k1.launches
            out = k1(*args)
            torch.cuda.synchronize()
            if k1.launches != before + 1:
                raise RuntimeError("K1 launch was not counted")
            ref = sra.stereo_roi_align_packed_ref(*args)
            e, how = _k1_error(out, ref, hat, fl + fr)
            if out[:, 2].abs().max().item() != 0.0:
                raise RuntimeError("zero-area roi did not give zeros")
            err[hat] = max(err[hat], e)
            print(f"K1 {hat:9s} {str(dtype):14s} B={b:2d} R={r} C={c}: max "
                  f"abs err {e:.3e} ({how})", flush=True)
            if b == 16:
                ms[hat] = _device_ms(lambda: k1(*args), 20,
                                     "stereo_roi_align_kernel")
                call_ms[hat] = _events_ms(lambda: k1(*args), 20)
                plain_ms[hat] = _events_ms(
                    lambda: sra.stereo_roi_align_packed_ref(*args),
                    5 if hat == "f32" else 2)
                # Each output written once, each level of both sides read
                # once.
                bound = _bound_ms(out.numel() * 4 + 2 * _level_bytes(b, c, 2))
            del out, ref
        del fl, fr
    torch.cuda.empty_cache()
    for hat in sra.TOOL_HAT_MODES:
        print(f"K1 {hat} time at batch 16, bf16: kernel {ms[hat]:.3f} ms "
              f"(device; {call_ms[hat]:.3f} ms per wrapper call), plain "
              f"{plain_ms[hat]:.3f} ms, bound {bound:.3f} ms (bytes)  "
              f"[{card}]", flush=True)
    print(f"K1 f32 wrapper call {call_ms['f32']:.3f} ms, the previous "
          f"{PREVIOUS_MS['K1'][1]:.3f} ms (the per-level tables now stay on "
          f"the device)", flush=True)
    return {hat: {"max_abs_err": err[hat], "ms": ms[hat],
                  "call_ms": call_ms[hat], "plain_ms": plain_ms[hat],
                  "bound_ms": bound}
            for hat in sra.TOOL_HAT_MODES}


def check_k2(sra, dev, gen, card):
    """Phase 4: K2 against its plain backward, deterministic, timed beside
    ``index_add_``."""
    k2 = sra.stereo_roi_align_bwd_kernel
    b, r, c = 8, 128, 256
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    rl = _edge_case_rois(gen, b, r, dev)
    rr = rl - torch.tensor([17.0, 0.0, 14.0, 0.0], device=dev)
    g = torch.randn(b, r, sra.ROWS, c, generator=gen, device=dev)
    bargs = (g, rl, rr, shapes, STRIDES)
    r_l, r_r = sra.stereo_roi_align_packed_bwd_ref(*bargs)
    err = 0.0
    before = k2.launches
    d_l, d_r = k2(*bargs)
    again_l, again_r = k2(*bargs)
    torch.cuda.synchronize()
    if k2.launches != before + 2:
        raise RuntimeError("K2 launch was not counted")
    if not all(torch.equal(x, y)
               for x, y in zip(d_l + d_r, again_l + again_r)):
        raise RuntimeError("K2: two launches differ")
    for lvl, (ours, ref) in enumerate(zip(d_l + d_r, r_l + r_r)):
        scale = ref.abs().max().item()
        e = (ours - ref).abs().max().item()
        if not e <= TOL_BWD * scale:
            raise RuntimeError(f"K2 level {lvl}: max abs err {e:.3e} > "
                               f"{TOL_BWD:.0e} x {scale:.3e}")
        err = max(err, e)
    del again_l, again_r
    # A cotangent on the zero-area rois only gives an exactly zero gradient.
    g0 = torch.zeros_like(g)
    g0[:, 2] = g[:, 2]
    d0_l, d0_r = k2(g0, rl, rr, shapes, STRIDES)
    if any(d.any() for d in d0_l + d0_r):
        raise RuntimeError("K2: a zero-area roi changed the gradient")
    print(f"K2 B={b} R={r} C={c}: max abs err {err:.3e} (tol "
          f"{TOL_BWD:.0e} x level max |grad|), two launches bit-identical, "
          f"zero-area rois inert", flush=True)
    clocks = _clocks()
    ms = _device_ms(lambda: k2(*bargs), 20, "stereo_roi_align_bwd_kernel")
    call_ms = _events_ms(lambda: k2(*bargs), 20)
    # Two yardsticks of the same launch: every roi zero-area (the kernel
    # only scans the rois and writes the zero gradients: a floor for the
    # store side, not a library call), and all 128 rois of every image one
    # box (every tap of an image lands on the same few hundred cells).
    empty = rl.clone()
    empty[..., 2] = empty[..., 0]
    floor_ms = _device_ms(lambda: k2(g, empty, empty, shapes, STRIDES), 20,
                          "stereo_roi_align_bwd_kernel")
    box = torch.tensor([300.0, 100.0, 420.0, 190.0], device=dev).expand(
        b, r, 4).contiguous()
    box_ms = _device_ms(lambda: k2(g, box, box - torch.tensor(
        [17.0, 0.0, 14.0, 0.0], device=dev), shapes, STRIDES), 20,
        "stereo_roi_align_bwd_kernel")
    plain_ms = _events_ms(
        lambda: sra.stereo_roi_align_packed_bwd_ref(*bargs), 5)
    # Library yardstick: one index_add_ of the same scatter into both
    # sides' gradients, its operands (the four weighted taps of every
    # sample) already formed.
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
    n_bytes = ((n_l * (sra.PK * sra.PK + sra.P * sra.P) +
                n_r * sra.P * sra.P) * c * 4 +
               sum(d.numel() * 4 for d in d_l + d_r))
    bound = _bound_ms(n_bytes)
    print(f"K2 time at batch 8, R=128: kernel {ms:.3f} ms (device; the "
          f"previous atomic kernel {PREVIOUS_MS['K2'][0]:.3f} ms; "
          f"{call_ms:.3f} ms per wrapper call, the previous "
          f"{PREVIOUS_MS['K2'][1]:.3f}), plain "
          f"{plain_ms:.3f} ms, index_add_ {lib_ms:.3f} ms, bound "
          f"{bound:.3f} ms (bytes, {n_bytes / 1e6:.0f} MB); 0 global "
          f"atomics, no zero-fill; every roi zero-area (scan and store "
          f"only, a floor for the store side) {floor_ms:.3f} ms, all rois "
          f"one 120x90 px box {box_ms:.3f} ms; SM clock, power, "
          f"temperature before the timing: {clocks}  [{card}]", flush=True)
    del g, g0, d_l, d_r, r_l, r_r, d0_l, d0_r, idx, src, acc
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "library_ms": lib_ms,
            "store_floor_ms": floor_ms, "one_box_ms": box_ms}


def check_k3(dev, gen, card):
    """Phase 5: K3 through its entry point, against its plain version."""
    from stereo_rcnn_tpu_torch.ops import roi_align_window as win
    k3 = win.roi_align_window_kernel
    b, r, c = 16, 300, 256
    rois = _edge_case_rois(gen, b, r, dev)
    cases = [(dtype, p, s) for dtype in (torch.bfloat16, torch.float32)
             for p, s in ((7, 2), (14, 1))]
    feats = {dtype: _levels(gen, b, c, dtype, dev)
             for dtype in (torch.bfloat16, torch.float32)}
    # The path: the entry point on the batched and the unbatched form.
    k3.reset_counts()
    outs = {}
    for dtype, p, s in cases:
        f = feats[dtype]
        outs[dtype, p, s] = (
            win.multilevel_roi_align_window(f, rois, STRIDES, p, s),
            win.multilevel_roi_align_window([x[3] for x in f], rois[3],
                                            STRIDES, p, s))
    torch.cuda.synchronize()
    launches = k3.launches
    if launches != 2 * len(cases):
        raise RuntimeError(f"K3: {launches} launches for {2 * len(cases)} "
                           "entry-point calls")
    err, res = 0.0, {}
    for dtype, p, s in cases:
        f = feats[dtype]
        out, out1 = outs.pop((dtype, p, s))
        ref = win.multilevel_roi_align_window_ref(f, rois, STRIDES, p, s)
        e = max((out - ref).abs().max().item(),
                (out1 - ref[3]).abs().max().item())
        if not e <= TOL:
            raise RuntimeError(f"K3 {dtype} ({p}, {s}): max abs err "
                               f"{e:.3e} > {TOL:.0e}")
        if out[:, 2].abs().max().item() == 0.0:
            raise RuntimeError("K3: the zero-area roi was zeroed; the TPU "
                               "kernel samples it as a 1-cell roi")
        err = max(err, e)
        ms = _device_ms(lambda: win.multilevel_roi_align_window(
            f, rois, STRIDES, p, s), 20, "roi_align_window_kernel")
        call_ms = _events_ms(lambda: win.multilevel_roi_align_window(
            f, rois, STRIDES, p, s), 20)
        plain_ms = _events_ms(lambda: win.multilevel_roi_align_window_ref(
            f, rois, STRIDES, p, s), 3)
        # Its float32 output written once, one side's levels read once.
        bound = _bound_ms(out.numel() * 4 +
                          _level_bytes(b, c, f[0].element_size()))
        res[dtype, p, s] = {"ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound}
        print(f"K3 {str(dtype):14s} (P, s) = ({p:2d}, {s}) B={b} R={r} "
              f"C={c}: max abs err {e:.3e} (tol {TOL:.0e}); kernel "
              f"{ms:.3f} ms (device; {call_ms:.3f} ms per call), plain "
              f"{plain_ms:.3f} ms, bound {bound:.3f} ms (bytes)  [{card}]",
              flush=True)
        del out, out1, ref
    del feats
    torch.cuda.empty_cache()
    head = res[torch.bfloat16, 7, 2]
    return {"max_abs_err": err, **head, "launches": launches,
            "by_case": {f"{str(d).split('.')[-1]} P={p} s={s}": v
                        for (d, p, s), v in res.items()}}


def check_k4(sra, dev, gen, card):
    """Phase 6: K4 against its plain version and against K1 f32."""
    k1, k4 = sra.stereo_roi_align_kernel, sra.stereo_roi_align_atlas_kernel
    c = 256
    err = 0.0
    for b, r, dtype in ((2, 300, torch.float32), (16, 300, torch.bfloat16)):
        fl, fr = _levels(gen, b, c, dtype, dev), _levels(gen, b, c, dtype, dev)
        rl = _edge_case_rois(gen, b, r, dev)
        rr = rl - torch.tensor([17.0, 0.0, 14.0, 0.0], device=dev)
        shapes = [(f.shape[1], f.shape[2]) for f in fl]
        atlas_l, atlas_r = sra.pack_atlas(fl)[0], sra.pack_atlas(fr)[0]
        before = k4.launches
        out = k4(atlas_l, atlas_r, shapes, rl, rr, STRIDES)
        torch.cuda.synchronize()
        if k4.launches != before + 1:
            raise RuntimeError("K4 launch was not counted")
        ref = sra.stereo_roi_align_atlas_ref(fl, fr, rl, rr, STRIDES)
        e = max((o - x).abs().max().item() for o, x in zip(out, ref))
        packed = k1(fl, fr, rl, rr, STRIDES)
        rows = (slice(196, 245), slice(245, 294), slice(0, 196))
        e_k1 = max((o.reshape(b, r, -1, c) - packed[:, :, sl]).abs().max()
                   .item() for o, sl in zip(out, rows))
        if not (e <= TOL and e_k1 <= TOL):
            raise RuntimeError(f"K4 {dtype} B={b}: max abs err {e:.3e} vs "
                               f"plain, {e_k1:.3e} vs K1 f32 > {TOL:.0e}")
        if any(o[:, 2].abs().max().item() != 0.0 for o in out):
            raise RuntimeError("K4: zero-area roi did not give zeros")
        err = max(err, e)
        print(f"K4 {str(dtype):14s} B={b:2d} R={r} C={c}: max abs err "
              f"{e:.3e} vs plain, {e_k1:.3e} vs K1 f32 (tol {TOL:.0e})",
              flush=True)
        if b == 16:
            ms = _device_ms(lambda: k4(atlas_l, atlas_r, shapes, rl, rr,
                                       STRIDES), 20,
                            "stereo_roi_align_atlas_kernel")
            # A floor for the store side, not a library call: the three
            # outputs written alone.
            store_ms = _events_ms(lambda: [o.zero_() for o in out], 20)
            call_ms = _events_ms(lambda: k4(atlas_l, atlas_r, shapes, rl,
                                            rr, STRIDES), 20)
            pack_ms = _events_ms(lambda: (sra.pack_atlas(fl),
                                          sra.pack_atlas(fr)), 20)
            plain_ms = _events_ms(lambda: sra.stereo_roi_align_atlas_ref(
                fl, fr, rl, rr, STRIDES), 3)
            # The three outputs written once, each level of both sides
            # read once: the function needs no byte of the atlases' padding
            # (their zero widths and runway), which its taps never read.
            bound = _bound_ms(sum(o.numel() * 4 for o in out) +
                              2 * _level_bytes(b, c, 2))
            # The packing: each level read once, both atlases written once.
            atlas_bytes = atlas_l.numel() * atlas_l.element_size()
            pack_bound = _bound_ms(2 * _level_bytes(b, c, 2) +
                                   2 * atlas_bytes)
            print(f"K4 time at batch 16, bf16: kernel {ms:.3f} ms (device; "
                  f"the previous {PREVIOUS_MS['K4'][0]:.3f} ms; "
                  f"{call_ms:.3f} ms per wrapper call, the previous "
                  f"{PREVIOUS_MS['K4'][1]:.3f}), plain "
                  f"{plain_ms:.3f} ms, bound {bound:.3f} ms (bytes); "
                  f"store-only floor (the three outputs zeroed, not a "
                  f"library call) {store_ms:.3f} ms; atlas packing (2 sides)"
                  f" {pack_ms:.3f} ms, its bound {pack_bound:.3f} ms (bytes)"
                  f"  [{card}]", flush=True)
        del fl, fr, out, ref, packed, atlas_l, atlas_r
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "store_floor_ms": store_ms, "pack_ms": pack_ms,
            "pack_bound_ms": pack_bound}


def _check_detections(out, b, d):
    shapes_out = {"position": (b, d, 3), "ry": (b, d), "z_refined": (b, d),
                  "box_left": (b, d, 4)}
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
    return int(valid.sum())


STAGES = ("backbone", "RPN head", "proposals", "RoIAlign", "RCNN head",
          "post-processing", "keypoints", "3D solve + align")


def stage_times(model, cfg, calib, left, right):
    """Milliseconds per stage of one ``make_full_pipeline`` call, the
    stages run one by one as the pipeline composes them, each between two
    ``torch.cuda.synchronize()`` (so host launch time counts)."""
    from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
    from stereo_rcnn_tpu_torch.inference import (broadcast_calib,
                                                 solve_and_align)
    from stereo_rcnn_tpu_torch.models.detector import (postprocess_boxes,
                                                       roi_features,
                                                       run_keypoints)
    from stereo_rcnn_tpu_torch.models.heads import RCNNOutputs
    from stereo_rcnn_tpu_torch.models.stereo_rpn import select_proposals

    b, im_h, im_w = left.shape[:3]
    times = []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    with torch.no_grad():
        feats = timed(lambda: model.backbone(torch.cat([left, right])))
        fl, fr = [f[:b] for f in feats], [f[b:] for f in feats]
        logits, deltas = timed(lambda: model.rpn(fl, fr))
        props = timed(lambda: select_proposals(
            logits, deltas, generate_anchors(
                cfg.anchors, im_h, im_w, cfg.box_off, left.device),
            im_h, im_w, cfg.rpn, False, cfg.box_off))
        pooled = timed(lambda: roi_features(model, fl, fr, props.left,
                                            props.right))
        heads = timed(lambda: model.heads(pooled["concat"]))
        n = props.left.shape[1]
        rows = pooled["left_kpt_rows"]
        raw = {"proposals": props,
               "rcnn": RCNNOutputs(*[x.reshape(b, n, *x.shape[1:])
                                     for x in heads]),
               "kpt_feats": rows.reshape(b, n, *rows.shape[1:])}
        det, idx, rois = timed(lambda: postprocess_boxes(raw, cfg, im_h,
                                                         im_w))
        det = timed(lambda: run_keypoints(model, raw, det, idx, rois))
        timed(lambda: solve_and_align(
            det, left, right, broadcast_calib(calib, b, left.device), cfg))
    return times


def inference(sra, dev, card):
    """Phase 7: three RoIAlign configurations of the inference path."""
    from stereo_rcnn_tpu_torch import (Config, init_params,
                                       make_full_pipeline, synthetic_images)
    from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
    from stereo_rcnn_tpu_torch.models.detector import roi_features
    from stereo_rcnn_tpu_torch.models.stereo_rpn import select_proposals

    k1, k2 = sra.stereo_roi_align_kernel, sra.stereo_roi_align_bwd_kernel
    base = Config()

    def rcnn(impl, hat):
        return dataclasses.replace(base, rcnn=dataclasses.replace(
            base.rcnn, roi_align_impl=impl, roi_align_hat=hat))
    configs = {"bench.py (pallas, kron_bf16)": rcnn("pallas", "kron_bf16"),
               "Config() (xla)": base,
               "pallas, f32": rcnn("pallas", "f32")}
    t0 = time.perf_counter()
    # The weights do not depend on the RoIAlign settings: one model, its
    # config switched per run.
    model = init_params(base, torch.Generator().manual_seed(0), dev)
    il, ir, calib = synthetic_images(base, 16, seed=7, n_objects=5)
    left = torch.from_numpy(il).to(dev)
    right = torch.from_numpy(ir).to(dev)
    print(f"inference path: init + render {time.perf_counter() - t0:.1f} s;"
          f" depth {base.backbone.depth}, fpn {base.backbone.fpn_dim}, fc "
          f"{base.rcnn.fc_dim}, {base.data.image_w}x{base.data.image_h}, "
          f"{base.compute_dtype}", flush=True)
    d = base.rcnn.max_detections
    launches = {}
    for name, cfg in configs.items():
        model.cfg = cfg
        fn = make_full_pipeline(cfg, calib)
        fused = cfg.rcnn.roi_align_impl == "pallas"
        k1.reset_counts()
        k2.reset_counts()
        with _PlainCalls(sra) as plain:
            n_det = {}
            for b in (16, 1):
                before = k1.launches
                out = fn(model, left[:b], right[:b])
                torch.cuda.synchronize()
                if (k1.launches > before) != fused:
                    raise RuntimeError(f"{name}, batch {b}: K1 launches "
                                       f"{k1.launches - before}")
                n_det[b] = _check_detections(out, b, d)
        if n_det[16] == 0:
            raise RuntimeError(f"{name}: no detections at batch 16")
        launches[name] = (dict(k1.launches_by_hat), k2.launches)
        if k2.launches or plain:
            raise RuntimeError(f"{name}: K2 launches {k2.launches}, plain "
                               f"versions {plain}")
        print(f"inference {name}: n_det {n_det[16]} of {16 * d} at batch 16,"
              f" {n_det[1]} of {d} at batch 1, finite; K1 launches "
              f"{launches[name][0]}, K2 0, plain versions 0 calls",
              flush=True)

    # Timed in turns, the configurations in order and then reversed: the
    # host-bound stages vary from call to call.
    results = {name: [] for name in configs}
    with _PlainCalls(sra) as plain:
        for name in list(configs) + list(reversed(configs)):
            cfg = configs[name]
            model.cfg = cfg
            fn = make_full_pipeline(cfg, calib)
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
            results[name].append((16 * 1000.0 / step16,
                                  sorted(lat)[len(lat) // 2]))
    if plain:
        raise RuntimeError(f"inference timing: plain versions ran {plain}")
    for name, runs in results.items():
        print(f"inference {name}: "
              f"{', '.join(f'{r[0]:.2f}' for r in runs)} pairs/s at batch "
              f"16, p50 {', '.join(f'{r[1]:.1f}' for r in runs)} ms at "
              f"batch 1 (two turns, 3 and 7 calls each)  [{card}]",
              flush=True)
    # Stage times, the configurations in turns, three rounds.
    runs = {(name, b): [] for name in configs for b in (16, 1)}
    for _ in range(3):
        for name, cfg in configs.items():
            model.cfg = cfg
            for b in (16, 1):
                runs[name, b].append(stage_times(model, cfg, calib,
                                                 left[:b], right[:b]))
    for name in configs:
        cols = {b: [sorted(x)[1] for x in zip(*runs[name, b])]
                for b in (16, 1)}
        print(f"stages of {name}, ms per call at batch 16 / batch 1 "
              f"(synchronize around each, median of 3 rounds)  [{card}]")
        for i, stage in enumerate(STAGES):
            print(f"  {stage:18s} {cols[16][i]:8.1f} {cols[1][i]:8.1f}")
        print(f"  {'total':18s} {sum(cols[16]):8.1f} {sum(cols[1]):8.1f}",
              flush=True)

    # The RoIAlign stage alone on the real backbone output.
    with torch.no_grad():
        feats = model.backbone(torch.cat([left, right]))
        fl, fr = [f[:16] for f in feats], [f[16:] for f in feats]
        logits, deltas = model.rpn(fl, fr)
        props = select_proposals(
            logits, deltas,
            generate_anchors(base.anchors, 384, 1280, base.box_off, dev),
            384, 1280, base.rpn, False, base.box_off)
        stage = {}
        for name, cfg in configs.items():
            model.cfg = cfg
            stage[name] = _events_ms(lambda: roi_features(
                model, fl, fr, props.left, props.right), 10)
        print("RoIAlign stage at batch 16 on the backbone output ("
              f"{int(props.valid.sum())} valid of {props.valid.numel()} "
              "rois), roi_features: " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in stage.items()) +
              f"  [{card}]", flush=True)
        # K1 against its plain version at batch 1 on real features.
        model.cfg = configs["pallas, f32"]
        fl1, fr1 = [f[:1] for f in fl], [f[:1] for f in fr]
        ours = roi_features(model, fl1, fr1, props.left[:1],
                            props.right[:1])
        plain = sra.stereo_roi_align_packed_ref(fl1[:4], fr1[:4],
                                                props.left[:1],
                                                props.right[:1], STRIDES)
    rows = ours["left_kpt_rows"].reshape(plain.shape)
    diff = (rows - plain).abs().max().item()
    scale = max(plain.abs().max().item(), 1.0)
    if not diff <= TOL * scale:
        raise RuntimeError(f"roi_features: kernel vs plain {diff:.3e} > "
                           f"{TOL:.0e} x {scale:.3e}")
    print(f"roi_features batch 1 ({int(props.valid[:1].sum())} valid rois): "
          f"kernel vs plain max abs diff {diff:.3e} (tol {TOL:.0e} x max "
          f"{scale:.3e})", flush=True)
    del model, feats, fl, fr, ours, plain, rows, left, right
    torch.cuda.empty_cache()
    return results, launches, stage


def _train_steps(step, state, batch, tgen, params, watched, n, card, what):
    """``n`` timed steps after one warm-up; each must give finite losses
    and move every watched parameter.  Returns the step times (ms, CUDA
    events) and the host's time to enqueue each step (ms, until the step
    function returns): a step whose host time is its whole time is
    host-bound."""
    from stereo_rcnn_tpu_torch.train.losses import LOSS_NAMES
    step(state, batch, tgen)                              # warm-up
    torch.cuda.synchronize()
    times, host = [], []
    for i in range(n):
        snap = {k: params[k].detach().clone() for k in watched}
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = step(state, batch, tgen)
        host.append((time.perf_counter() - t0) * 1e3)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        vals = {k: float(metrics[k]) for k in (*LOSS_NAMES, "total",
                                               "grad_norm")}
        if not all(v == v and abs(v) < float("inf") for v in vals.values()):
            raise RuntimeError(f"{what} step {i}: non-finite {vals}")
        moved = {k: (params[k].detach() - snap[k]).abs().max().item()
                 for k in watched}
        if not all(v > 0 for v in moved.values()):
            raise RuntimeError(f"{what} step {i}: not updated {moved}")
        print(f"{what} step {i}: {times[-1]:.1f} ms (host {host[-1]:.1f} ms "
              f"to enqueue), "
              + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
              + f", fg rpn {float(metrics['num_fg_rpn']):.1f} rcnn "
              f"{float(metrics['num_fg_rcnn']):.1f}  [{card}]", flush=True)
    return times, host


def training(sra, dev, card, steps: int = 3):
    """Phases 8 and 9: the fused-RoIAlign training path (``steps`` timed
    steps), the gather's, and a profiled step."""
    from stereo_rcnn_tpu_torch.config import synthetic_fullres_config
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
    from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                             make_train_step)
    from stereo_rcnn_tpu_torch.train.targets import ground_truth_to_torch

    k1, k2 = sra.stereo_roi_align_kernel, sra.stereo_roi_align_bwd_kernel
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
    out = {}
    for impl, n in (("pallas", steps), ("xla", 1)):
        cfg_i = dataclasses.replace(cfg, rcnn=dataclasses.replace(
            cfg.rcnn, roi_align_impl=impl))
        state.model.cfg = cfg_i
        step_i = make_train_step(cfg_i, device=dev)
        torch.cuda.reset_peak_memory_stats()
        k1.reset_counts()
        k2.reset_counts()
        with _PlainCalls(sra) as plain:
            times, host = _train_steps(step_i, state, batch, tgen, params,
                                       watched, n, card, f"train {impl}")
        launched = {"K1": k1.launches, "K2": k2.launches}
        # The warm-up step launches too: n + 1 of each on the fused path.
        expect = n + 1 if impl == "pallas" else 0
        if plain or launched != {"K1": expect, "K2": expect}:
            raise RuntimeError(f"training {impl}: launches {launched} "
                               f"(expected {expect} each), plain "
                               f"versions {plain}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = sorted(times)[len(times) // 2]
        out[impl] = {"ms": ms, "times": times, "peak_gib": peak,
                     "launches": launched}
        print(f"training path, roi_align_impl={impl}: launches {launched} in"
              f" {n + 1} steps, plain versions 0 calls; {ms:.1f} ms/step "
              f"(median of {len(times)}: "
              f"{', '.join(f'{t:.1f}' for t in times)}; host "
              f"{', '.join(f'{t:.1f}' for t in host)}), "
              f"{b * 1000.0 / ms:.2f} pairs/s at batch {b}, peak memory "
              f"{peak:.2f} GiB  [{card}]", flush=True)
    state.model.cfg = cfg
    profile_step(step, state, batch, tgen, out["pallas"]["ms"], card)
    return out


def profile_step(step, state, batch, tgen, ms, card):
    """Phase 9: where one fused-path training step's time goes."""
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
              f"{a.count} calls", flush=True)


def bench_tool(sra):
    """Phase 10: the RoIAlign microbenchmark tool as a user runs it."""
    from stereo_rcnn_tpu_torch.tools import bench_roialign
    k1, k4 = sra.stereo_roi_align_kernel, sra.stereo_roi_align_atlas_kernel
    k1.reset_counts()
    k4.reset_counts()
    lines = bench_roialign.main(["--iters", "5"])
    torch.cuda.synchronize()
    by_hat = dict(k1.launches_by_hat)
    if not (k4.launches and all(by_hat.values())):
        raise RuntimeError(f"bench_roialign: K1 launches {by_hat}, K4 "
                           f"{k4.launches}")
    print(f"bench_roialign: K1 launches {by_hat}, K4 {k4.launches}",
          flush=True)
    torch.cuda.empty_cache()
    return lines, by_hat, k4.launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--training-only", action="store_true",
                        help="run only the build and the training phases; "
                             "prints no result line")
    parser.add_argument("--train-steps", type=int, default=3,
                        help="timed steps on the fused training path")
    args = parser.parse_args(argv)
    # -- 1. environment --------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs a CUDA device")
    from stereo_rcnn_tpu_torch.ops import roi_align_window as win
    from stereo_rcnn_tpu_torch.ops import stereo_roi_align as sra

    t_start = time.perf_counter()
    phase_s = {}
    kernels = (sra.stereo_roi_align_kernel, sra.stereo_roi_align_bwd_kernel,
               win.roi_align_window_kernel, sra.stereo_roi_align_atlas_kernel)
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

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"[phase {name}: {phase_s[name]:.1f} s]", flush=True)
        return res

    # -- 2. build ---------------------------------------------------------
    def build():
        with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
            for fut in [pool.submit(k.load) for k in kernels]:
                fut.result()
        for k in kernels:
            print(f"  {k.source}: {k.build_info.seconds:.1f} s nvcc "
                  f"({k.build_info.path})")
            for line in k.build_info.log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    ptxas: {line.strip()}")
    phase("build", build)

    if args.training_only:
        phase("training", training, sra, dev, card, args.train_steps)
        return 0
    gen = torch.Generator(device=dev).manual_seed(0)
    k1 = phase("K1", check_k1, sra, dev, gen, card)
    k2 = phase("K2", check_k2, sra, dev, gen, card)
    k3 = phase("K3", check_k3, dev, gen, card)
    k4 = phase("K4", check_k4, sra, dev, gen, card)
    _, infer_launches, _ = phase("inference", inference, sra, dev, card)
    train = phase("training", training, sra, dev, card, args.train_steps)
    _, tool_k1, tool_k4 = phase("bench_roialign", bench_tool, sra)

    total = time.perf_counter() - t_start
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in phase_s.items()) +
          f"; total {total:.1f}", flush=True)

    def k1_paths(hat):
        paths = {f"inference {name}": by_hat[hat]
                 for name, (by_hat, _) in infer_launches.items()
                 if by_hat[hat]}
        if hat == "f32":
            paths["training"] = train["pallas"]["launches"]["K1"]
        paths["bench_roialign"] = tool_k1[hat]
        return paths

    entries = []
    for hat in sra.TOOL_HAT_MODES:
        paths = k1_paths(hat)
        entries.append({
            "name": "stereo_roi_align_fwd", "mode": hat, "route": "cuda",
            "source": "stereo_rcnn_tpu_torch/csrc/stereo_roi_align.cu",
            "replaces": "stereo_rcnn_tpu/ops/roi_align_pallas.py:359",
            "launches": sum(paths.values()), "launches_by_path": paths,
            **k1[hat], "bound_by": "bytes", "library_ms": None})
    k2_paths = {f"inference {name}": n
                for name, (_, n) in infer_launches.items()}
    k2_paths.update({f"training {impl}": t["launches"]["K2"]
                     for impl, t in train.items()})
    entries.append({
        "name": "stereo_roi_align_bwd", "route": "cuda",
        "source": "stereo_rcnn_tpu_torch/csrc/stereo_roi_align_bwd.cu",
        "replaces": "stereo_rcnn_tpu/ops/roi_align_pallas.py:874",
        "launches": sum(k2_paths.values()), "launches_by_path": k2_paths,
        **k2, "bound_by": "bytes"})
    entries.append({
        "name": "roi_align_window", "route": "cuda",
        "source": "stereo_rcnn_tpu_torch/csrc/roi_align_window.cu",
        "replaces": "stereo_rcnn_tpu/ops/roi_align_pallas.py:47",
        "launches": k3["launches"],
        "launches_by_path": {"multilevel_roi_align_window": k3["launches"]},
        "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "by_case": k3["by_case"]})
    entries.append({
        "name": "stereo_roi_align_atlas", "route": "cuda",
        "source": "stereo_rcnn_tpu_torch/csrc/stereo_roi_align_atlas.cu",
        "replaces": "stereo_rcnn_tpu/ops/roi_align_pallas.py:618",
        "launches": tool_k4, "launches_by_path": {"bench_roialign": tool_k4},
        **k4, "bound_by": "bytes", "library_ms": None})
    for entry in entries:
        if not entry["launches"]:
            raise RuntimeError(f"{entry['name']} was launched on no path")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
