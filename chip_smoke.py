"""Build the port's CUDA kernels and drive its inference, training,
RoIAlign-benchmark, tools, data-parallel, serving, multi-class,
perf-tool and golden-capture paths once on one GPU (or, for the
data-parallel phase, on every visible card).

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit (``nvcc``).  Phases, each raising on failure:

1. environment: torch / CUDA versions, the card's name and power limit,
   TF32 off for matmuls and convolutions;
2. build the six kernels, one ``nvcc`` per source, started together: K1
   the fused stereo RoIAlign in its five sampling-weight modes
   (csrc/stereo_roi_align.cu), K2 its backward
   (csrc/stereo_roi_align_bwd.cu), K3 the windowed one-sided RoIAlign
   (csrc/roi_align_window.cu), K4 the atlas variant
   (csrc/stereo_roi_align_atlas.cu), K5 the Gauss-Newton 3D solve
   (csrc/box_solve.cu) and K6 the backbone's convolution epilogue
   (csrc/conv_epilogue.cu);
3. K1 in each mode (f32, kron_bf16, kron_hilo, and the tool-only
   two-matmul modes bf16 and hilo) against its plain PyTorch version at
   the level shapes of both paths (1280x384, C=256; 300 rois for
   inference, 128 at batch 8 for training) with edge-case rois, in
   bfloat16 and float32, all timed at batch 16 (kernel device time and
   wrapper call) beside a store-only floor (the output zeroed alone);
   then every mode at an odd C = 255 (1-channel lanes), checked at batch 2
   and timed at batch 16;
4. K2 against its plain backward at the training shapes (batch 8, 128
   rois, C=256, bfloat16 levels) with edge-case rois; two launches must
   give the same bits; the same at C=34 (its 2-channel lanes) and C=255
   (1-channel lanes, timed); timed at C=256 beside the plain version and
   one ``index_add_`` of the same scatter;
5. K3 through its entry point ``multilevel_roi_align_window`` (batched and
   unbatched) against its plain version at 1280x384, C=256, batch 16, 300
   rois, (P, s) = (7, 2) and (14, 1), bfloat16 and float32, timed beside
   a store-only floor; the same at C=255 (1-channel lanes) at batch 2,
   timed at batch 16;
6. K4 against its plain version and against K1 f32 at batch 16, 300 rois,
   timed beside a store-only floor (the three outputs zeroed), its atlas
   packing timed apart; at C=255 (1-channel lanes, timed at batch 16) and
   C=2056 (beyond one pass of its 256 lanes x 8 channels, timed at batch
   2) against its plain version at batch 2; then K5 against the plain
   loop it fuses on well-posed detections at the pipeline's N = 512
   (batch 16) and N = 32 (batch 1), z free and fixed, timed beside it,
   flagged (without raising) where its outputs lose the loop's bits; then
   K6 against its plain version, bit for bit, at the ResNet-101 sites' C
   and at C = 255 (1-channel lanes), with and without a residual and a
   ReLU, and at the offline call's site shapes (the stem's 32 x 64 x 192
   x 640, C2 to C5), timed at the offline shape (32 x 256 x 96 x 320 with
   a residual) beside its bound, the plain version and the unfolded
   passes it replaces (frozen BN's multiply and add, the residual add,
   the ReLU), its timed output checked too; and that site whole (1x1
   convolution and epilogue) folded + K6, folded + torch's in-place
   epilogue, and cuDNN's fused convolution + bias + add + ReLU;
7. the inference path, ``make_full_pipeline`` at full width (ResNet-101,
   FPN 256, fc 2048, 1280x384, bf16; one random model from seed 0 and
   rendered scenes, seed 7, 5 objects, reused) in three configurations,
   each at batch 16 and batch 1 with launch counts, shape and finiteness
   checks: ``bench.py``'s program (``roi_align_impl="pallas"``,
   ``kron_bf16``), ``Config()`` itself (``"xla"``, the atlas gather: no
   kernel launch) and the fused kernel with f32 weights; each call must
   launch K5 twice (the solve and the z-fixed re-solve) and K6 107 times
   (the stem, 33 bottlenecks x 3, the FPN's 7), and the plain RoIAlign
   versions, the plain solve loop and the plain epilogue must not run;
   then pairs/s
   at batch 16 and p50 at
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
    K1 mode and K4 must launch;
11. the training and evaluation CLIs as a user runs them, at full width
    (``synthetic_fullres_config()`` written as JSON, batch 8), with the
    native host preprocessing built: a KITTI tree of 8 rendered frames at
    1242x375 written as ``.npy`` (``data.synthetic.write_kitti_frame``);
    ``tools.train`` for 2 epochs of 1 step (K1 and K2 launched twice,
    finite losses, a checkpoint, the params export and ``config.json``),
    then ``--resume --epochs 3`` (the restored state equal to the saved
    one, tensor for tensor; one more step, K1 and K2 once); ``tools.test_net``
    on the tree with the params export and ``tools.eval_synth --batches 1
    --batch 4``, each printing its AP lines and launching K1; no plain
    RoIAlign version runs.  Each CLI's wall seconds are printed;
12. serving, on phase 11's checkpoint and tree: ``convert.norm_calibrate``
    from one image in float32, the calibrated backbone held to the
    GroupNorm one within 5e-5 of each level's largest value, written as a
    params export with its ``config.json`` (norm "frozen");
    ``tools.calibrate_norm`` (batch 8, one calibration and one held-out
    batch), which a 3-step model may fail: rc 0 with all three files, or
    rc 1 with "validation FAILED" and no ``VALID``; ``tools.export_model``
    of ``bench.py``'s program (``Config()``, ``"pallas"``, ``kron_bf16``)
    at batch 8 with the calibrated weights (the trace launches nothing),
    and ``--verify``; ``tools.serve`` on the tree, grown to 64 rendered
    frames, with the weights loaded over the artifact's (64 result files,
    K1 ``kron_bf16`` launched once a batch; the first batch's seconds and
    the pairs/s of the batches after it are printed apart); the loaded
    artifact against the eager pipeline on one batch of the tree (equal
    ``valid``, boxes and scores within 1e-3, finite positions; ms per call
    in 6 alternating turns of 3 calls);
    ``tools.diag_3d`` on the checkpoint (its match line, K1 launched) and
    ``tools.demo --synthetic`` (``Config()``'s gather: no K1; its PNG must
    decode to 1280x1536).  No plain RoIAlign version and no K2 runs.  The
    trace, save and load seconds, the artifact's MB, ``serve``'s first
    batch and steady pairs/s and each tool's wall seconds are printed.
13. data parallelism (run after phase 11, before phase 12), in spawned
    rank processes (``parallel.launch.spawn``): ``synthetic_fullres_config()``
    at batch 8 per rank over NCCL on every visible card (one rank: its
    first step the same bits as one process, cuDNN deterministic), three
    timed steps (ms/step, global pairs/s, peak memory per rank) and the
    gradient all-reduce alone; two ranks (two gloo ranks on one card, CUDA
    tensors; with several cards also two NCCL ranks) against one process
    at batch 16 on the same rows, generator and weights, in float32 with
    the RPN's objectness scaled 300x (loss within 1e-3, every top-level
    module's update within 5e-3 in norm); sharded inference of ``bench.py``'s
    program at global batch 16 over two ranks (NCCL on two cards, else
    gloo on one): each rank's rows of the gathered detections the same
    bits as its pipeline alone on them, ms per call; then, as
    subprocesses on phase 11's tree, ``tools.train`` over the visible
    cards (2 steps), a run stopped by SIGTERM after its first step (rc 75,
    one checkpoint) and its ``--resume``, and ``tools.dryrun_multichip``;
    each one's wall seconds are printed.
14. the multi-class configuration, ``synthetic_multiclass_config()``
    (background / Car / Van, per-class mean dims; ResNet-101, GroupNorm,
    remat, the fused RoIAlign with f32 weights, 1280x384, bf16, 128 rois
    per image): ``make_train_step`` at batch 8 on rendered two-class
    scenes (seed 7), one warm-up and two timed steps (K1 and K2 launched
    each step, finite losses, all three rows of ``cls_score`` updated);
    ``make_full_pipeline`` at batch 16 (K1 once, detections of shape
    [16, max_detections], finite); ``tools.train`` for 2 steps on an
    8-frame two-class ``.npy`` tree and ``tools.test_net`` on it (both
    ``[Car]`` and ``[Van]`` AP lines).  No plain RoIAlign version runs.
    ms/step, peak memory and pairs/s are printed;
15. the stage-breakdown and roofline tools (``tools.perf_breakdown``,
    ``tools.roofline``) at batch 16 with 3 timed calls per prefix, with
    ``--impl pallas`` (K1 launches) and ``--impl xla`` (none); no util or
    MFU above 1.05;
16. ``tools.capture_golden`` on a ``.pth`` in the upstream names written
    from a random ``Config()`` model (``upstream_state_dict``), a rendered
    ``.npy`` pair and its KITTI calib file: the ``.npz`` holds the JAX
    tool's keys (read from its ``np.savez`` call), finite.

Times of the kernels' previous versions (the two-channel K1 and K3, the
atomic K2, the two-channel K4 and the wrappers that copied their tables
to the card on every call; "NVIDIA H100 80GB HBM3, 700.00 W", PERF.md)
are printed beside the new ones for comparison; they are constants, not
measured here.

Every phase's wall seconds are printed.  The line before the last is the
kernels' JSON record; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero and prints no result.

    python3 chip_smoke.py --digests PATH

also writes to PATH a JSON object of the sha256 of every output of K1,
K2, K3, K4, K5 and K6 that phases 3 to 6 check, keyed by kernel, mode and
shape: two builds that give the same file give the same bits on these inputs
(the inputs come from a seeded generator).  The file is written before
phase 7.

    python3 chip_smoke.py --training-only [--train-steps N]

runs phases 1, 2, 8 and 9 alone, with N timed steps on the fused path
(default 3), and prints no result line: the step time varies with the
host, so comparing two commits takes several such runs in turns.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import hashlib
import io
import json
import re
import subprocess
import sys
import time

import numpy as np
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
# The one-image norm calibration, float32: the calibrated backbone against
# the GroupNorm one on that image, relative to each level's largest value
# (tests/test_norm_calibrate.py's bound: the two differ in how the moments
# are summed).
TOL_CALIB = 5e-5
# The served artifact against the eager pipeline on the same batch: boxes
# (px) and scores; the same ops, but cuDNN may pick other algorithms.
TOL_SERVE = 1e-3
# The serving phase serves this many rendered frames (batches of 8; the
# first batch, which pays one-off set-up, is reported apart) and times the
# artifact against the eager pipeline in this many alternating turns of
# this many calls.
SERVE_FRAMES = 64
RATIO_TURNS, RATIO_CALLS = 6, 3
# K2 vs plain backward: the same float32 terms, K2 fusing each term's
# multiply into its add and summing per cell in roi, sample and tap order
# (index_add_ in the plain version), relative to each level's largest
# |gradient|.
TOL_BWD = 1e-5
# The previous versions' times (on "NVIDIA H100 80GB HBM3, 700.00 W",
# PERF.md): K1 and K3 the device ms of their two-channel kernels at batch
# 16 x 300, bf16, per mode and per (P, s); K2 and K4 the kernel device ms
# and wrapper call ms of the atomic K2 and the two-channel K4.
PREVIOUS_MS = {"K1": {"f32": 1.105, "kron_bf16": 1.122, "kron_hilo": 1.128,
                      "bf16": 1.115, "hilo": 1.316},
               "K2": (0.947, 2.225),
               "K3": {(7, 2): 0.545, (14, 1): 0.868},
               "K4": (1.409, 2.777)}
# The multi-class phase's timed training steps (after one warm-up), and
# the calls each prefix of the perf tools times (after one warm-up).
MULTICLASS_STEPS = 2
PERF_TOOL_ITERS = 3
# H100 SXM device-memory rate (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
# K5 vs the plain loop on well-posed detections (m, rad, px): the kernel
# repeats the loop's float32 operations in its order (the same bits on an
# H100), so only rounding that the solve damps may part them.
TOL_SOLVE = 1e-3
# K6's timed shape: the offline call's C2 (16 stereo pairs, 1280x384).
K6_SHAPE = (32, 256, 96, 320)
# K6's other sites in the offline call, checked bit for bit at their own
# shapes: (shape, [(residual, relu), ...]).  The stem's epilogue takes no
# residual; each stage's last conv does, its first two do not; the FPN's
# laterals take one and no ReLU.
K6_SITES = {
    "stem": ((32, 64, 192, 640), [(False, True)]),
    "C2": (K6_SHAPE, [(False, True), (True, False)]),
    "C3": ((32, 512, 48, 160), [(False, True), (True, True)]),
    "C4": ((32, 1024, 24, 80), [(False, True), (True, True)]),
    "C5": ((32, 2048, 12, 40), [(False, True), (True, True)]),
}


def upstream_state_dict(model) -> dict:
    """A frozen-BN model's weights under the released upstream checkpoint's
    names, as ``convert/stereo_import.import_detector`` reads them: the
    port's container prefixes dropped, and each frozen BN (``scale``,
    ``bias``) written as a BatchNorm of that weight and bias with mean 0
    and variance 1.  CPU tensors."""
    out = {}
    for k, v in model.state_dict().items():
        v = v.detach().cpu().clone()
        for prefix in ("backbone_net.", "rcnn_head.", "kpt_head."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k.endswith(".scale"):
            stem = k[:-len(".scale")]
            out[stem + ".weight"] = v
            out[stem + ".running_mean"] = torch.zeros_like(v)
            out[stem + ".running_var"] = torch.ones_like(v)
        else:
            out[k] = v
    return out


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


def _sha256(t: torch.Tensor) -> str:
    """The sha256 of a tensor's bytes, on the host."""
    return hashlib.sha256(t.detach().contiguous().cpu().numpy()).hexdigest()


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


# The channel counts that take the kernels' narrow lanes: an odd C
# (1-channel lanes, K1-K4) and, for K4, a C above its block's 256 lanes x
# 8 channels (a second pass of the lanes).  Each case draws from its own
# generator, so the shared stream (and the digests of the C = 256 cases)
# stays as it was.
ODD_C = 255
WIDE_C = 2056


def _own_gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _timed(fn, kernel, plain_fn, n_bytes, plain_iters=2):
    """Device ms of ``kernel`` over ``fn`` (profiler), the wrapper call's
    ms, the plain version's ms and the bound (bytes)."""
    return {"ms": _device_ms(fn, 20, kernel), "call_ms": _events_ms(fn, 20),
            "plain_ms": _events_ms(plain_fn, plain_iters),
            "bound_ms": _bound_ms(n_bytes)}


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
    """Counts the calls of the plain versions of the kernels while active:
    the RoIAlign's (``ops.stereo_roi_align``) and, where the solve module
    and the epilogue's are given too, the solve's (``solve.box_estimator``)
    and the convolution epilogue's (``ops.conv_epilogue``)."""

    NAMES = ("stereo_roi_align_packed_ref", "stereo_roi_align_packed_bwd_ref",
             "solve_batch_ref", "conv_epilogue_ref")

    def __init__(self, *modules):
        self.modules = modules
        self.calls = {}

    def __enter__(self):
        self.originals = [(m, n, _counting(m, n, self.calls))
                          for m in self.modules for n in self.NAMES
                          if hasattr(m, n)]
        return self.calls

    def __exit__(self, *exc):
        for module, name, fn in self.originals:
            setattr(module, name, fn)


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


def check_k1(sra, dev, gen, card, digests=None):
    """Phase 3: K1 in every mode against its plain version.  ``digests``
    (a dict or None) takes the sha256 of every output."""
    k1 = sra.stereo_roi_align_kernel
    c = 256
    err = dict.fromkeys(sra.TOOL_HAT_MODES, 0.0)
    ms, call_ms, plain_ms = {}, {}, {}
    bound = store_ms = None
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
            if digests is not None:
                digests[f"K1 {hat} {dtype} B={b} R={r}"] = _sha256(out)
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
                if store_ms is None:
                    # A floor for the store side, not a library call: the
                    # output written alone.
                    store_ms = _events_ms(out.zero_, 20)
            del out, ref
        del fl, fr
    torch.cuda.empty_cache()
    odd = _k1_odd_c(sra, k1, dev, card, digests)
    for hat in sra.TOOL_HAT_MODES:
        print(f"K1 {hat} time at batch 16, bf16: kernel {ms[hat]:.3f} ms "
              f"(device; the two-channel kernel "
              f"{PREVIOUS_MS['K1'][hat]:.3f} ms; "
              f"{call_ms[hat]:.3f} ms per wrapper call), plain "
              f"{plain_ms[hat]:.3f} ms, bound {bound:.3f} ms (bytes), "
              f"store-only floor (the output zeroed, not a library call) "
              f"{store_ms:.3f} ms  [{card}]", flush=True)
    return {hat: {"max_abs_err": err[hat], "ms": ms[hat],
                  "call_ms": call_ms[hat], "plain_ms": plain_ms[hat],
                  "bound_ms": bound, "store_floor_ms": store_ms,
                  f"C={ODD_C}": odd[hat]}
            for hat in sra.TOOL_HAT_MODES}


def _k1_odd_c(sra, k1, dev, card, digests):
    """K1 at an odd C (1-channel lanes) in every mode against its plain
    version at batch 2 (bf16 and float32 levels), each mode timed at batch
    16 (bf16)."""
    c, gen = ODD_C, _own_gen(dev, ODD_C)
    out_stats = {hat: {"max_abs_err": 0.0} for hat in sra.TOOL_HAT_MODES}
    for b, dtype in ((2, torch.bfloat16), (2, torch.float32),
                     (16, torch.bfloat16)):
        fl, fr = _levels(gen, b, c, dtype, dev), _levels(gen, b, c, dtype, dev)
        rl = _edge_case_rois(gen, b, 300, dev)
        rr = rl - torch.tensor([17.0, 0.0, 14.0, 0.0], device=dev)
        for hat in sra.TOOL_HAT_MODES:
            args = (fl, fr, rl, rr, STRIDES, hat)
            if b == 16:
                out = k1(*args)
                out_stats[hat].update(_timed(
                    lambda: k1(*args), "stereo_roi_align_kernel",
                    lambda: sra.stereo_roi_align_packed_ref(*args),
                    out.numel() * 4 + 2 * _level_bytes(b, c, 2), 1))
                del out
                continue
            out = k1(*args)
            ref = sra.stereo_roi_align_packed_ref(*args)
            e, how = _k1_error(out, ref, hat, fl + fr)
            if out[:, 2].abs().max().item() != 0.0:
                raise RuntimeError(f"K1 C={c}: zero-area roi did not give "
                                   "zeros")
            out_stats[hat]["max_abs_err"] = max(
                out_stats[hat]["max_abs_err"], e)
            if digests is not None:
                digests[f"K1 {hat} {dtype} B={b} R=300 C={c}"] = _sha256(out)
            print(f"K1 {hat:9s} {str(dtype):14s} B={b} R=300 C={c} "
                  f"(1-channel lanes): max abs err {e:.3e} ({how})",
                  flush=True)
            del out, ref
        del fl, fr
    torch.cuda.empty_cache()
    for hat, st in out_stats.items():
        print(f"K1 {hat} time at batch 16, bf16, C={c}: kernel "
              f"{st['ms']:.3f} ms (device; {st['call_ms']:.3f} ms per "
              f"wrapper call), plain {st['plain_ms']:.3f} ms, bound "
              f"{st['bound_ms']:.3f} ms (bytes)  [{card}]", flush=True)
    return out_stats


def check_k2(sra, dev, gen, card, digests=None):
    """Phase 4: K2 against its plain backward, deterministic, timed beside
    ``index_add_``.  ``digests`` (a dict or None) takes the sha256 of every
    level gradient."""
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
    if digests is not None:
        for side, grads in (("left", d_l), ("right", d_r)):
            for lvl, d in enumerate(grads):
                digests[f"K2 B={b} R={r} C={c} {side} P{lvl + 2}"] = \
                    _sha256(d)
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
    # C = 34 (not a multiple of 4) takes the 2-channel lanes; its own
    # generator leaves the shared stream (and the later digests) as it was.
    g34 = torch.randn(b, r, sra.ROWS, 34, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(34))
    a34 = k2(g34, rl, rr, shapes, STRIDES)
    b34 = k2(g34, rl, rr, shapes, STRIDES)
    r34 = sra.stereo_roi_align_packed_bwd_ref(g34, rl, rr, shapes, STRIDES)
    err34 = 0.0
    for lvl, (x, y, ref) in enumerate(zip(a34[0] + a34[1], b34[0] + b34[1],
                                          r34[0] + r34[1])):
        e = (x - ref).abs().max().item()
        if not (torch.equal(x, y) and e <= TOL_BWD * ref.abs().max().item()):
            raise RuntimeError(f"K2 C=34 level {lvl}: max abs err {e:.3e}, "
                               f"two launches equal {torch.equal(x, y)}")
        err34 = max(err34, e)
    print(f"K2 B={b} R={r} C=34 (2-channel lanes): max abs err {err34:.3e} "
          f"(tol {TOL_BWD:.0e} x level max |grad|), two launches "
          f"bit-identical", flush=True)
    del g34, a34, b34, r34
    odd = _k2_odd_c(sra, k2, rl, rr, shapes, dev, card, digests)
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
            "store_floor_ms": floor_ms, "one_box_ms": box_ms,
            f"C={ODD_C}": odd}


def _k2_odd_c(sra, k2, rl, rr, shapes, dev, card, digests):
    """K2 at an odd C (1-channel lanes) on the training shapes: against
    its plain backward, two launches the same bits, timed."""
    c = ODD_C
    g = torch.randn(rl.shape[0], rl.shape[1], sra.ROWS, c, device=dev,
                    generator=_own_gen(dev, c))
    args = (g, rl, rr, shapes, STRIDES)
    a, b = k2(*args), k2(*args)
    ref = sra.stereo_roi_align_packed_bwd_ref(*args)
    err = 0.0
    for lvl, (x, y, r) in enumerate(zip(a[0] + a[1], b[0] + b[1],
                                        ref[0] + ref[1])):
        e = (x - r).abs().max().item()
        if not (torch.equal(x, y) and e <= TOL_BWD * r.abs().max().item()):
            raise RuntimeError(f"K2 C={c} level {lvl}: max abs err {e:.3e}, "
                               f"two launches equal {torch.equal(x, y)}")
        err = max(err, e)
    if digests is not None:
        for side, grads in (("left", a[0]), ("right", a[1])):
            for lvl, d in enumerate(grads):
                digests[f"K2 B={rl.shape[0]} R={rl.shape[1]} C={c} {side} "
                        f"P{lvl + 2}"] = _sha256(d)
    meta_l, _ = sra.roi_window_meta(shapes, rl, STRIDES)
    meta_r, _ = sra.roi_window_meta(shapes, rr, STRIDES)
    n_bytes = ((int((meta_l[..., 3] > 0).sum()) * (sra.PK * sra.PK +
                                                   sra.P * sra.P) +
                int((meta_r[..., 3] > 0).sum()) * sra.P * sra.P) * c * 4 +
               sum(d.numel() * 4 for d in a[0] + a[1]))
    st = {"max_abs_err": err, **_timed(
        lambda: k2(*args), "stereo_roi_align_bwd_kernel",
        lambda: sra.stereo_roi_align_packed_bwd_ref(*args), n_bytes, 3)}
    print(f"K2 B={rl.shape[0]} R={rl.shape[1]} C={c} (1-channel lanes): max "
          f"abs err {err:.3e} (tol {TOL_BWD:.0e} x level max |grad|), two "
          f"launches bit-identical; kernel {st['ms']:.3f} ms (device; "
          f"{st['call_ms']:.3f} ms per wrapper call), plain "
          f"{st['plain_ms']:.3f} ms, bound {st['bound_ms']:.3f} ms (bytes)"
          f"  [{card}]", flush=True)
    del g, a, b, ref
    torch.cuda.empty_cache()
    return st


def check_k3(dev, gen, card, digests=None):
    """Phase 5: K3 through its entry point, against its plain version.
    ``digests`` (a dict or None) takes the sha256 of every output."""
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
        if digests is not None:
            name = f"K3 {dtype} P={p} s={s}"
            digests[name] = _sha256(out)
            digests[f"{name} unbatched"] = _sha256(out1)
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
        # A floor for the store side, not a library call: the output
        # written alone.
        store_ms = _events_ms(out.zero_, 20)
        res[dtype, p, s] = {"ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound, "store_floor_ms": store_ms}
        before = (f"the two-channel kernel {PREVIOUS_MS['K3'][p, s]:.3f} ms; "
                  if dtype == torch.bfloat16 else "")
        print(f"K3 {str(dtype):14s} (P, s) = ({p:2d}, {s}) B={b} R={r} "
              f"C={c}: max abs err {e:.3e} (tol {TOL:.0e}); kernel "
              f"{ms:.3f} ms (device; {before}{call_ms:.3f} ms per call), "
              f"plain {plain_ms:.3f} ms, bound {bound:.3f} ms (bytes), "
              f"store-only floor (the output zeroed, not a library call) "
              f"{store_ms:.3f} ms  [{card}]", flush=True)
        del out, out1, ref
    del feats
    torch.cuda.empty_cache()
    odd = _k3_odd_c(win, k3, dev, card, digests)
    head = res[torch.bfloat16, 7, 2]
    return {"max_abs_err": err, **head, "launches": launches,
            "by_case": {f"{str(d).split('.')[-1]} P={p} s={s}": v
                        for (d, p, s), v in res.items()},
            f"C={ODD_C}": odd}


def _k3_odd_c(win, k3, dev, card, digests):
    """K3 at an odd C (1-channel lanes) through its entry point against
    its plain version at batch 2 (bf16 and float32, both (P, s)), timed at
    batch 16 (bf16)."""
    c, gen = ODD_C, _own_gen(dev, ODD_C + 1)
    stats = {}
    for b, dtype in ((2, torch.bfloat16), (2, torch.float32),
                     (16, torch.bfloat16)):
        f = _levels(gen, b, c, dtype, dev)
        rois = _edge_case_rois(gen, b, 300, dev)
        for p, s in ((7, 2), (14, 1)):
            args = (f, rois, STRIDES, p, s)
            out = win.multilevel_roi_align_window(*args)
            if b == 16:
                stats[f"P={p} s={s}"] = _timed(
                    lambda: win.multilevel_roi_align_window(*args),
                    "roi_align_window_kernel",
                    lambda: win.multilevel_roi_align_window_ref(*args),
                    out.numel() * 4 + _level_bytes(b, c, 2))
                continue
            ref = win.multilevel_roi_align_window_ref(*args)
            e = (out - ref).abs().max().item()
            if not e <= TOL:
                raise RuntimeError(f"K3 C={c} {dtype} ({p}, {s}): max abs "
                                   f"err {e:.3e} > {TOL:.0e}")
            stats["max_abs_err"] = max(stats.get("max_abs_err", 0.0), e)
            if digests is not None:
                digests[f"K3 {dtype} P={p} s={s} B={b} C={c}"] = _sha256(out)
            print(f"K3 {str(dtype):14s} (P, s) = ({p:2d}, {s}) B={b} R=300 "
                  f"C={c} (1-channel lanes): max abs err {e:.3e} (tol "
                  f"{TOL:.0e})", flush=True)
            del out, ref
        del f
    for case in ("P=7 s=2", "P=14 s=1"):
        st = stats[case]
        print(f"K3 {case} time at batch 16, bf16, C={c}: kernel "
              f"{st['ms']:.3f} ms (device; {st['call_ms']:.3f} ms per call)"
              f", plain {st['plain_ms']:.3f} ms, bound {st['bound_ms']:.3f} "
              f"ms (bytes)  [{card}]", flush=True)
    torch.cuda.empty_cache()
    return stats


def check_k4(sra, dev, gen, card, digests=None):
    """Phase 6: K4 against its plain version and against K1 f32.
    ``digests`` (a dict or None) takes the sha256 of every output."""
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
        if digests is not None:
            for name, o in zip(("7l", "7r", "14l"), out):
                digests[f"K4 {name} {dtype} B={b} R={r}"] = _sha256(o)
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
            "pack_bound_ms": pack_bound,
            **_k4_any_c(sra, k4, dev, card, digests)}


def _solve_inputs(n, dev, seed):
    """:func:`synthetic_solve_inputs` on the card: ``(args, obs_weights,
    fixed_z, well_posed)``, ``fixed_z`` the cars' depth + 0.3 m."""
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_solve_inputs
    from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
    d = {k: torch.from_numpy(v).to(dev)
         for k, v in synthetic_solve_inputs(n, seed).items()}
    calib = StereoCalib(*d["calib"].T.contiguous(), None, None)
    args = (d["obs"], d["dims_hwl"], d["alpha"], d["kpt_idx"], calib)
    return args, d["obs_weights"], d["depth"] + 0.3, d["well_posed"]


def check_k5(dev, card, digests=None):
    """Phase 6, end: K5 against the plain loop on the card at N = 512 and
    32, z free and fixed, ``Config()``'s 30 iterations; timed beside it.
    ``digests`` (a dict or None) takes the sha256 of every output.  Raises
    beyond :data:`TOL_SOLVE` on the well-posed rows or where finiteness
    differs; flags, without raising, a case whose outputs are not all the
    plain loop's bits: the benchmark's ``solve_px`` and ``align_rel``
    limits were set from runs in which the two gave the same bits."""
    from stereo_rcnn_tpu_torch.solve import box_estimator as be
    err, res, lost = 0.0, {}, []
    for n in (512, 32):
        args, w, z, well = _solve_inputs(n, dev, seed=n)
        for fixed in (None, z):
            def solve(fn=be.solve_batch):
                return fn(*args, obs_weights=w, fixed_z=fixed)
            got = solve()
            torch.cuda.synchronize()
            ref = solve(be.solve_batch_ref)
            same = total = 0
            for a, b in zip(got, ref):
                if not torch.equal(a.isfinite(), b.isfinite()):
                    raise RuntimeError(f"K5 N={n}: finiteness differs from "
                                       "the plain loop's")
                err = max(err, (a[well] - b[well]).abs().max().item())
                same += int((a == b).sum())
                total += a.numel()
            if not err <= TOL_SOLVE:
                raise RuntimeError(f"K5 N={n}: max abs err {err:.3e} > "
                                   f"{TOL_SOLVE:.0e}")
            tag = "fixed z" if fixed is not None else "free z"
            if digests is not None:
                for name, a in zip(got._fields, got):
                    digests[f"K5 {name} N={n} {tag}"] = _sha256(a)
            us = 1e3 * _device_ms(solve, 20, "gauss_newton_solve_kernel")
            call_us = 1e3 * _events_ms(solve, 20)
            plain_ms = _events_ms(lambda: solve(be.solve_batch_ref), 3)
            case = f"N={n} {tag}"
            res[case] = {"us": us, "call_us": call_us, "plain_ms": plain_ms,
                         "same_bits": same / total}
            print(f"K5 {case}: max abs err so far {err:.3e} (tol "
                  f"{TOL_SOLVE:.0e}, {int(well.sum())} well-posed rows of "
                  f"{n}), {same}/{total} outputs the plain loop's bits; "
                  f"kernel {us:.1f} us (device; {call_us:.1f} us per call), "
                  f"plain loop {plain_ms:.2f} ms  [{card}]", flush=True)
            if same < total:
                lost.append(case)
                print(f"K5 FLAG {case}: {total - same} of {total} outputs "
                      "differ from the plain loop's bits; the benchmark's "
                      "solve_px and align_rel limits were set from runs "
                      "that gave the same bits (PERF.md, open questions)",
                      flush=True)
    return {"max_abs_err": err, "bits_lost": lost, "by_case": res}


def check_k6(dev, card, digests=None):
    """Phase 6, end: K6 against its plain version, bit for bit (the same
    float32 additions in the same order, each rounded once), bf16 at batch
    2, 24x40, at the ResNet-101 sites' C and at C = 255, with and without
    a residual and a ReLU; then at the offline call's site shapes
    (:data:`K6_SITES`), where each thread walks many grid strides with its
    bias in registers; then timed at :data:`K6_SHAPE` with a residual and
    a ReLU beside its bound (y and the residual read, the result written),
    the plain version and the unfolded passes it replaces, and its output
    there checked too.  Last, the whole site (C2's conv3: the 1x1
    convolution and its epilogue) three ways: folded with K6, folded with
    torch's own epilogue (the bias in ``F.conv2d``, then in-place add and
    ReLU), and cuDNN's fused convolution + bias + add + ReLU.
    ``digests`` (a dict or None) takes the sha256 of every output."""
    import torch.nn.functional as F

    from stereo_rcnn_tpu_torch.ops import conv_epilogue as ce
    k6 = ce.conv_epilogue_kernel
    cl = torch.channels_last

    def draw(gen, shape):
        return (4 * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16).contiguous(memory_format=cl)

    def same(got, res, relu, y, bias, tag):
        ref = ce.conv_epilogue_ref(y, bias, res, relu)
        if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
            raise RuntimeError(f"K6 {tag}: not the plain version's bits")
        if digests is not None:
            digests[f"K6 {tag}"] = _sha256(got.view(torch.int16))

    checked = 0
    for c in (64, 128, 256, 512, 1024, 2048, ODD_C):
        gen = _own_gen(dev, c)
        y, r = draw(gen, (2, c, 24, 40)), draw(gen, (2, c, 24, 40))
        bias = torch.randn(c, generator=gen, device=dev)
        for res in (None, r):
            for relu in (False, True):
                got = k6(y, bias, res, relu, out=torch.empty_like(y))
                same(got, res, relu, y, bias,
                     f"C={c} residual={res is not None} relu={relu}")
                checked += 1
    for name, (shape, cases) in K6_SITES.items():
        gen = _own_gen(dev, shape[1] + 1)
        y = draw(gen, shape)
        bias = torch.randn(shape[1], generator=gen, device=dev)
        r = draw(gen, shape) if any(res for res, _ in cases) else None
        for res, relu in cases:
            res = r if res else None
            got = k6(y, bias, res, relu, out=torch.empty_like(y))
            same(got, res, relu, y, bias, f"{name} {'x'.join(map(str, shape))}"
                 f" residual={res is not None} relu={relu}")
            checked += 1
        del y, r, got
    n, c, h, w = K6_SHAPE
    gen = _own_gen(dev, 6)
    y, r = draw(gen, K6_SHAPE), draw(gen, K6_SHAPE)
    bias = torch.randn(c, generator=gen, device=dev)
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    out = torch.empty_like(y)
    shape = (1, -1, 1, 1)

    def unfolded():
        # A bottleneck's tail before the fold: bn3 (its scale and bias
        # cast, then multiply and add), the residual add, the ReLU.
        return F.relu(y * scale.to(y.dtype).view(shape) +
                      bias.to(y.dtype).view(shape) + r)

    st = _timed(lambda: k6(y, bias, r, True, out=out),
                "conv_epilogue_kernel",
                lambda: ce.conv_epilogue_ref(y, bias, r, True),
                3 * y.numel() * y.element_size())
    same(out, r, True, y, bias, f"timed {n}x{c}x{h}x{w} residual=True "
         "relu=True")
    checked += 1
    st["unfolded_ms"] = _events_ms(unfolded, 20)
    st["bits_checked"] = checked
    st["site"] = _k6_site_ways(k6, y, r, bias, gen)
    print(f"K6: {checked} cases the plain version's bits (with the offline "
          f"sites {list(K6_SITES)}); at {n}x{c}x{h}x{w} bf16 with a residual"
          f" and ReLU: kernel {st['ms']:.3f} ms (device; "
          f"{st['call_ms']:.3f} ms per wrapper call), bound "
          f"{st['bound_ms']:.3f} ms (bytes; "
          f"{100 * st['bound_ms'] / st['ms']:.1f} %), plain "
          f"{st['plain_ms']:.3f} ms, unfolded passes "
          f"{st['unfolded_ms']:.3f} ms; the site (1x1 conv + epilogue) "
          f"{json.dumps(st['site'])}  [{card}]", flush=True)
    return st


def _k6_site_ways(k6, y, r, bias, gen):
    """C2's conv3 site at the offline shape (``y``'s: a 1x1 convolution
    from C/4 channels, its bias, the residual ``r``, ReLU), timed by CUDA
    events per call three ways: folded + K6 (the program's), folded +
    torch's epilogue (the bias in ``F.conv2d`` as bf16, then ``add_`` and
    ``relu_``), cuDNN's fused ``cudnn_convolution_add_relu``; each with
    the share of its outputs whose bits differ from the program's.  A way
    that raises gives its error instead."""
    import torch.nn.functional as F

    n, c, h, w = y.shape
    dev = y.device
    x = (torch.randn(n, c // 4, h, w, generator=gen, device=dev)
         ).to(y.dtype).contiguous(memory_format=torch.channels_last)
    wt = (torch.randn(c, c // 4, 1, 1, generator=gen, device=dev) / 8
          ).to(y.dtype).contiguous(memory_format=torch.channels_last)
    b16 = bias.to(y.dtype)
    one, zero = (1, 1), (0, 0)
    ways = {
        "fold_k6": lambda: k6(F.conv2d(x, wt), bias, r, True),
        "fold_torch": lambda: F.conv2d(x, wt, b16).add_(r).relu_(),
        "cudnn_fused": lambda: torch.cudnn_convolution_add_relu(
            x, wt, r, 1.0, b16, one, zero, one, 1),
    }
    ours = ways["fold_k6"]()
    res = {}
    for name, fn in ways.items():
        try:
            got = fn()
            res[name] = {"ms": _events_ms(fn, 20),
                         "bits_differ": (got.view(torch.int16) !=
                                         ours.view(torch.int16)
                                         ).float().mean().item()}
        except RuntimeError as e:
            res[name] = {"error": str(e).splitlines()[0][:200]}
    return res


def _k4_any_c(sra, k4, dev, card, digests):
    """K4 at an odd C (1-channel lanes) and at a C beyond one pass of its
    lanes, against its plain version at batch 2 (bf16 and float32); the
    odd C timed at batch 16, the wide one at batch 2 (bf16)."""
    res = {}
    for c, b_time in ((ODD_C, 16), (WIDE_C, 2)):
        gen = _own_gen(dev, c)
        st = {"max_abs_err": 0.0}
        for b, dtype, check in ((2, torch.bfloat16, True),
                                (2, torch.float32, True),
                                (b_time, torch.bfloat16, False)):
            fl = _levels(gen, b, c, dtype, dev)
            fr = _levels(gen, b, c, dtype, dev)
            rl = _edge_case_rois(gen, b, 300, dev)
            rr = rl - torch.tensor([17.0, 0.0, 14.0, 0.0], device=dev)
            shapes = [(f.shape[1], f.shape[2]) for f in fl]
            atlas_l, atlas_r = sra.pack_atlas(fl)[0], sra.pack_atlas(fr)[0]
            args = (atlas_l, atlas_r, shapes, rl, rr, STRIDES)
            out = k4(*args)
            if not check:
                st.update(_timed(
                    lambda: k4(*args), "stereo_roi_align_atlas_kernel",
                    lambda: sra.stereo_roi_align_atlas_ref(fl, fr, rl, rr,
                                                           STRIDES),
                    sum(o.numel() * 4 for o in out) +
                    2 * _level_bytes(b, c, 2)))
                del fl, fr, out, atlas_l, atlas_r
                continue
            ref = sra.stereo_roi_align_atlas_ref(fl, fr, rl, rr, STRIDES)
            e = max((o - x).abs().max().item() for o, x in zip(out, ref))
            if not e <= TOL:
                raise RuntimeError(f"K4 C={c} {dtype}: max abs err {e:.3e} "
                                   f"> {TOL:.0e}")
            if any(o[:, 2].abs().max().item() != 0.0 for o in out):
                raise RuntimeError(f"K4 C={c}: zero-area roi did not give "
                                   "zeros")
            st["max_abs_err"] = max(st["max_abs_err"], e)
            if digests is not None:
                for name, o in zip(("7l", "7r", "14l"), out):
                    digests[f"K4 {name} {dtype} B={b} R=300 C={c}"] = \
                        _sha256(o)
            print(f"K4 {str(dtype):14s} B={b} R=300 C={c}: max abs err "
                  f"{e:.3e} vs plain (tol {TOL:.0e})", flush=True)
            del fl, fr, out, ref, atlas_l, atlas_r
        torch.cuda.empty_cache()
        print(f"K4 time at batch {b_time}, bf16, C={c}: kernel "
              f"{st['ms']:.3f} ms (device; {st['call_ms']:.3f} ms per "
              f"wrapper call), plain {st['plain_ms']:.3f} ms, bound "
              f"{st['bound_ms']:.3f} ms (bytes)  [{card}]", flush=True)
        res[f"C={c}"] = st
    return res


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
    from stereo_rcnn_tpu_torch.models.resnet_fpn import STAGE_BLOCKS
    from stereo_rcnn_tpu_torch.models.stereo_rpn import select_proposals

    from stereo_rcnn_tpu_torch.ops import conv_epilogue as ce
    from stereo_rcnn_tpu_torch.solve import box_estimator as be

    k1, k2 = sra.stereo_roi_align_kernel, sra.stereo_roi_align_bwd_kernel
    k5, k6 = be.gauss_newton_solve_kernel, ce.conv_epilogue_kernel
    base = Config()
    # K6 after the stem, each of a bottleneck's three convolutions and the
    # FPN's seven: 107 a call for ResNet-101.
    k6_per_call = 1 + 3 * sum(STAGE_BLOCKS[base.backbone.depth]) + 7

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
        with _PlainCalls(sra, be, ce) as plain:
            n_det = {}
            for b in (16, 1):
                before = k1.launches, k5.launches, k6.launches
                out = fn(model, left[:b], right[:b])
                torch.cuda.synchronize()
                if (k1.launches > before[0]) != fused:
                    raise RuntimeError(f"{name}, batch {b}: K1 launches "
                                       f"{k1.launches - before[0]}")
                # The solve, then the z-fixed re-solve: one K5 launch each.
                if k5.launches != before[1] + 2:
                    raise RuntimeError(f"{name}, batch {b}: K5 launches "
                                       f"{k5.launches - before[1]}, not 2")
                if k6.launches != before[2] + k6_per_call:
                    raise RuntimeError(
                        f"{name}, batch {b}: K6 launches "
                        f"{k6.launches - before[2]}, not {k6_per_call}")
                n_det[b] = _check_detections(out, b, d)
        if n_det[16] == 0:
            raise RuntimeError(f"{name}: no detections at batch 16")
        launches[name] = (dict(k1.launches_by_hat), k2.launches)
        if k2.launches or plain:
            raise RuntimeError(f"{name}: K2 launches {k2.launches}, plain "
                               f"versions {plain}")
        print(f"inference {name}: n_det {n_det[16]} of {16 * d} at batch 16,"
              f" {n_det[1]} of {d} at batch 1, finite; K1 launches "
              f"{launches[name][0]}, K2 0, K5 2 a call, K6 {k6_per_call} a "
              "call, plain versions 0 calls", flush=True)

    # Timed in turns, the configurations in order and then reversed: the
    # host-bound stages vary from call to call.
    results = {name: [] for name in configs}
    with _PlainCalls(sra, be, ce) as plain:
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


def _cli(name, fn, *args):
    """``fn(*args)`` with its stdout captured and echoed; returns
    ``(result, stdout, wall seconds)``."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print("\n".join(f"  {name}| {line}" for line in out.splitlines()))
    return res, out, wall


def _same_state(state, saved, what):
    """Raise unless ``state`` (a TrainState) equals the checkpoint dict
    ``saved`` tensor for tensor."""
    model = state.model.state_dict()
    bad = [k for k in saved["model"]
           if not torch.equal(model[k].cpu(), saved["model"][k])]
    bad += [f"trace {k}" for k in saved["trace"]
            if not torch.equal(state.trace[k].cpu(), saved["trace"][k])]
    if (bad or set(model) != set(saved["model"]) or
            set(state.trace) != set(saved["trace"]) or
            state.step != saved["step"] or
            not torch.equal(state.uncert.detach().cpu(), saved["uncert"])):
        raise RuntimeError(f"tools: {what} differs from the checkpoint "
                           f"({bad[:3]})")


def tools(sra, dev, card):
    """Phase 11: the training and evaluation CLIs as a user runs them, at
    full width, on a rendered KITTI tree."""
    import os
    import shutil

    from stereo_rcnn_tpu_torch.config import (save_config,
                                              synthetic_fullres_config)
    from stereo_rcnn_tpu_torch.data.synthetic import (random_scene,
                                                      render_pair,
                                                      write_kitti_frame)
    from stereo_rcnn_tpu_torch.geometry.calib import default_kitti_calib
    from stereo_rcnn_tpu_torch.tools import eval_synth, test_net, train
    from stereo_rcnn_tpu_torch.train.checkpoint import checkpoint_path
    from stereo_rcnn_tpu_torch.utils.host_preproc import native_available

    t_phase = time.perf_counter()
    if not native_available():
        raise RuntimeError("tools: the native host preprocessing library "
                           "did not build (csrc/host_preproc.cpp)")
    k1, k2 = sra.stereo_roi_align_kernel, sra.stereo_roi_align_bwd_kernel
    work = os.path.join("runs", "chip_smoke_tools")
    shutil.rmtree(work, ignore_errors=True)
    tree, ck = os.path.join(work, "kitti"), os.path.join(work, "ckpt")
    cfg = synthetic_fullres_config()
    cfg_json = os.path.join(work, "synthetic_fullres.json")
    os.makedirs(work)
    save_config(cfg, cfg_json)
    t0 = time.perf_counter()
    calib = default_kitti_calib()
    rng = np.random.RandomState(11)
    for i in range(8):
        objs = random_scene(rng, 4, calib, 375, 1242)
        left, right = render_pair(objs, calib, 375, 1242, rng)
        write_kitti_frame(tree, f"{i:06d}", objs, calib, left, right)
    walls = {"write tree": time.perf_counter() - t0}
    launches = {"K1": 0, "K2": 0}

    def counted(name, fn, *args):
        k1.reset_counts()
        k2.reset_counts()
        with _PlainCalls(sra) as plain:
            res, out, walls[name] = _cli(name, fn, *args)
        if plain:
            raise RuntimeError(f"tools: {name} ran plain versions {plain}")
        got = {"K1": k1.launches, "K2": k2.launches}
        for k, v in got.items():
            launches[k] += v
        return res, out, got

    common = ["--config", cfg_json, "--kitti-root", tree, "--image-ext",
              ".npy", "--batch-per-device", "8", "--ckpt-dir", ck,
              "--disp-interval", "1"]
    state2, _, got = counted("train", train.run,
                             train.parse_args(common + ["--epochs", "2"]))
    if state2.step != 2 or got != {"K1": 2, "K2": 2}:
        raise RuntimeError(f"tools: train reached step {state2.step} with "
                           f"launches {got} (expected 2 steps, 2 each)")
    for f in (checkpoint_path(ck, 2), os.path.join(ck, "config.json"),
              os.path.join(ck, "params_export", "params.pt")):
        if not os.path.exists(f):
            raise RuntimeError(f"tools: train wrote no {f}")
    with open(os.path.join(ck, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    bad = [r for r in rows if not all(np.isfinite(float(v))
                                      for k, v in r.items()
                                      if k != "pairs_per_sec")]
    if len(rows) != 2 or bad:
        raise RuntimeError(f"tools: metrics.csv rows {rows}")
    saved = torch.load(checkpoint_path(ck, 2), map_location="cpu",
                       weights_only=True)
    _same_state(state2, saved, "the trained state at step 2")
    del state2
    seen = []
    state3, out, got = counted(
        "resume", train.run,
        train.parse_args(common + ["--epochs", "3", "--resume"]),
        lambda st: (_same_state(st, saved, "the restored state"),
                    seen.append(st.step)))
    if (seen != [2] or state3.step != 3 or got != {"K1": 1, "K2": 1} or
            "resumed from step 2" not in out):
        raise RuntimeError(f"tools: resume restored {seen}, reached "
                           f"{state3.step}, launches {got}")
    del state3, saved
    torch.cuda.empty_cache()
    _, out, got = counted("test_net", test_net.main, [
        "--kitti-root", tree, "--ckpt-dir", ck, "--out",
        os.path.join(work, "results"), "--batch", "8", "--image-ext",
        ".npy"])
    if (got["K1"] < 1 or "AP_3d@0.7 (R40)" not in out or
            "AP_bev@0.5 (R11)" not in out or "8 frames" not in out or
            len(os.listdir(os.path.join(work, "results"))) != 8):
        raise RuntimeError(f"tools: test_net launches {got}")
    _, out, got = counted("eval_synth", eval_synth.main, [
        "--ckpt-dir", ck, "--batches", "1", "--batch", "4"])
    if got["K1"] < 1 or "AP_3d@0.5 (R40)" not in out or \
            "restored step 3" not in out:
        raise RuntimeError(f"tools: eval_synth launches {got}")
    shutil.rmtree(os.path.join(work, "results"))
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"tools phase: {wall:.1f} s; " + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()) +
        f"; launches on the tools path {launches}; plain versions 0 calls; "
        f"native host preprocessing: yes  [{card}]", flush=True)
    # The serving phase takes over the tree and the checkpoint.
    return launches, work


def _png_size(path):
    """``(width, height)`` of an 8-bit RGB PNG, raising unless its image
    data decodes to that many rows of that many pixels."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError(f"{path} is not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            size = struct.unpack(">II", data[pos + 8:pos + 16])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h = size
    if len(zlib.decompress(idat)) != h * (1 + 3 * w):
        raise RuntimeError(f"{path}: image data is not {w}x{h} RGB")
    return w, h


def serving(sra, dev, card, work):
    """Phase 12: norm calibration, export, serving, diagnosis and the demo
    at full width, on the tools phase's checkpoint (GroupNorm-32, 3 steps)
    and 8-frame tree, which it deletes at the end."""
    import os
    import shutil

    from stereo_rcnn_tpu_torch.config import Config, load_config, save_config
    from stereo_rcnn_tpu_torch.convert.norm_calibrate import calibrate
    from stereo_rcnn_tpu_torch.data.synthetic import (random_scene,
                                                      render_pair,
                                                      write_kitti_frame)
    from stereo_rcnn_tpu_torch.geometry.calib import default_kitti_calib
    from stereo_rcnn_tpu_torch.inference import make_full_pipeline
    from stereo_rcnn_tpu_torch.models.detector import build_model
    from stereo_rcnn_tpu_torch.ops import conv_epilogue as ce
    from stereo_rcnn_tpu_torch.solve import box_estimator as be
    from stereo_rcnn_tpu_torch.tools import (calibrate_norm, demo, diag_3d,
                                             export_model, serve)
    from stereo_rcnn_tpu_torch.train.checkpoint import (PARAMS_FILE,
                                                        export_params,
                                                        restore_params)

    t_phase = time.perf_counter()
    k1, k2 = sra.stereo_roi_align_kernel, sra.stereo_roi_align_bwd_kernel
    tree, ck = os.path.join(work, "kitti", "training"), os.path.join(work,
                                                                     "ckpt")
    walls, launches = {}, {}

    def counted(name, fn, *args):
        k1.reset_counts()
        k2.reset_counts()
        with _PlainCalls(sra) as plain:
            res, out, walls[name] = _cli(name, fn, *args)
        if plain or k2.launches:
            raise RuntimeError(f"serving: {name} ran plain versions {plain},"
                               f" K2 {k2.launches} times")
        launches[name] = {h: n for h, n in k1.launches_by_hat.items() if n}
        return res, out

    dirs = [os.path.join(tree, d) for d in ("image_2", "image_3", "calib")]
    serve_args = ["--left-dir", dirs[0], "--right-dir", dirs[1],
                  "--calib-dir", dirs[2], "--image-ext", ".npy"]
    # 1. Calibrate from one image, in float32 (TF32 is off), and hold the
    # calibrated backbone to the GroupNorm one on it.
    t0 = time.perf_counter()
    cfg_gn = load_config(os.path.join(ck, "config.json"),
                         overrides={"backbone": {"remat": False}})
    cfg32 = dataclasses.replace(cfg_gn, compute_dtype="float32")
    model_gn = restore_params(os.path.join(ck, "params_export"),
                              build_model(cfg32).to(dev).eval())
    img = serve.read_batch(*dirs, ".npy", ["000000"], 1, cfg32.data.image_h,
                           cfg32.data.image_w, cfg32.backbone.pixel_means_bgr,
                           dev)[0]
    cfg_aff, model_aff = calibrate(cfg32, model_gn, [(img, img)])
    with torch.no_grad():
        levels = zip(model_gn.backbone(img), model_aff.backbone(img))
        rel = [((a - b).abs().max() / a.abs().max()).item()
               for a, b in levels]
    if not max(rel) <= TOL_CALIB:
        raise RuntimeError(f"serving: one-image calibration off by {rel} of "
                           f"each level's largest value (tol {TOL_CALIB})")
    calibrated = os.path.join(work, "calibrated_1img")
    export_params(os.path.join(calibrated, "params_export"), model_aff)
    save_config(dataclasses.replace(cfg_aff,
                                    compute_dtype=cfg_gn.compute_dtype),
                os.path.join(calibrated, "config.json"))
    del model_gn, model_aff, img
    torch.cuda.empty_cache()
    walls["calibrate 1 image"] = time.perf_counter() - t0
    print(f"one-image calibration (float32, ResNet-{cfg32.backbone.depth}): "
          f"P2..P6 within {', '.join(f'{r:.2e}' for r in rel)} of each "
          f"level's largest value (tol {TOL_CALIB})", flush=True)

    # 2. The calibration tool: a 3-step model may fail its own gate.
    rc, out = counted("calibrate_norm", calibrate_norm.main, [
        "--ckpt-dir", ck, "--calib-batches", "1", "--eval-batches", "1",
        "--batch", "8"])
    cal = os.path.join(ck, "calibrated")
    wrote = {f: os.path.exists(os.path.join(cal, f)) for f in
             (os.path.join("params_export", PARAMS_FILE), "config.json",
              "VALID")}
    if rc == 0 and all(wrote.values()):
        outcome = "passed its gate and wrote params_export, config.json, VALID"
    elif rc == 1 and "validation FAILED" in out and not wrote["VALID"]:
        outcome = "failed its gate (rc 1) and wrote no VALID marker"
    else:
        raise RuntimeError(f"serving: calibrate_norm rc {rc}, wrote {wrote}")
    if not launches["calibrate_norm"].get("f32"):
        raise RuntimeError("serving: calibrate_norm launched no K1")
    print(f"calibrate_norm: {outcome}", flush=True)

    # 3. Export bench.py's program (Config(), "pallas", kron_bf16) at batch
    # 8 with the one-image calibration's weights, then verify it.
    base = Config()
    cfg = dataclasses.replace(base, rcnn=dataclasses.replace(
        base.rcnn, roi_align_impl="pallas", roi_align_hat="kron_bf16"))
    cfg_json = os.path.join(work, "res101_pallas.json")
    save_config(cfg, cfg_json)
    artifact = os.path.join(work, "res101_pallas.pt2")
    _, out = counted("export_model", export_model.main, [
        "--config", cfg_json, "--batch", "8", "--ckpt-dir", calibrated,
        "--out", artifact])
    m = re.search(r"exported ([\d.]+) MB .* traced in ([\d.]+)s, saved in "
                  r"([\d.]+)s", out)
    if m is None or launches["export_model"]:
        raise RuntimeError(f"serving: export_model launched "
                           f"{launches['export_model']} (the trace launches "
                           "nothing)")
    mb, trace_s, save_s = (float(x) for x in m.groups())
    _, out = counted("export verify", export_model.main, [
        "--verify", artifact, "--config", cfg_json])
    if ("verify OK: ran batch 8" not in out or
            launches["export verify"] != {"kron_bf16": 1}):
        raise RuntimeError(f"serving: verify launched "
                           f"{launches['export verify']}")

    # 4. Serve the tree, grown to SERVE_FRAMES frames from the same
    # renderer, with the weights loaded over the artifact's.
    t0 = time.perf_counter()
    calib, rng = default_kitti_calib(), np.random.RandomState(12)
    for i in range(len(os.listdir(dirs[0])), SERVE_FRAMES):
        objs = random_scene(rng, 4, calib, 375, 1242)
        left, right = render_pair(objs, calib, 375, 1242, rng)
        write_kitti_frame(os.path.dirname(tree), f"{i:06d}", objs, calib,
                          left, right)
    walls["write serve tree"] = time.perf_counter() - t0
    results = os.path.join(work, "served")
    pipe, out = counted("serve", serve.run, serve.parse_args([
        "--artifact", artifact, "--ckpt-dir", calibrated, "--out",
        results] + serve_args))
    m = re.search(r"loaded in ([\d.]+)s", out)
    first = re.search(r"first batch ([\d.]+)s", out)
    steady = re.search(r"after the first batch: (\d+) frames in [\d.]+s "
                       r"\(([\d.]+) pairs/s\); per batch (median .*)", out)
    n_batches = SERVE_FRAMES // 8
    if (m is None or first is None or steady is None or
            f"served {SERVE_FRAMES} frames" not in out or
            len(os.listdir(results)) != SERVE_FRAMES or
            launches["serve"] != {"kron_bf16": n_batches}):
        raise RuntimeError(f"serving: serve launched {launches['serve']}, "
                           f"wrote {len(os.listdir(results))} files")
    load_s, first_s = float(m.group(1)), float(first.group(1))
    steady_n, pairs_s = int(steady.group(1)), float(steady.group(2))
    per_batch = steady.group(3)
    # The artifact as serve loaded it, with the weights it served, against
    # the eager pipeline with those weights on one batch.
    sd = torch.load(os.path.join(calibrated, "params_export", PARAMS_FILE),
                    map_location=dev, weights_only=True)
    model = build_model(cfg).to(dev).eval()
    model.load_state_dict(sd)
    ids = [f"{i:06d}" for i in range(8)]
    batch = serve.read_batch(*dirs, ".npy", ids, 8, cfg.data.image_h,
                             cfg.data.image_w, cfg.backbone.pixel_means_bgr,
                             dev)[:4]
    eager = make_full_pipeline(cfg)
    with _PlainCalls(sra, be, ce) as plain:
        ours = pipe(*batch)
        ref = eager(model, *batch)
        # Mean ms per call over RATIO_CALLS calls, in RATIO_TURNS
        # alternating turns, so that the ratio comes with its spread.
        ms = {"artifact": [], "eager": []}
        for name, fn in (("artifact", pipe), ("eager", eager)) * RATIO_TURNS:
            args = batch if name == "artifact" else (model, *batch)
            ms[name].append(_events_ms(lambda: fn(*args), RATIO_CALLS))
    ratio = [a / e for a, e in zip(ms["artifact"], ms["eager"])]
    valid = ref.det.valid
    diffs = {name: (getattr(ours.det, name) - getattr(ref.det, name)
                    )[valid].abs().max().item()
             for name in ("box_left", "box_right", "score")}
    if (plain or not torch.equal(ours.det.valid, valid) or not valid.any()
            or max(diffs.values()) > TOL_SERVE or
            not torch.isfinite(ours.position[valid]).all()):
        raise RuntimeError(f"serving: artifact vs eager valid "
                           f"{int(ours.det.valid.sum())}/{int(valid.sum())},"
                           f" diffs {diffs}, plain versions {plain}")
    print(f"artifact vs eager make_full_pipeline, batch 8 of the tree: valid "
          f"equal ({int(valid.sum())}), max |diff| " + ", ".join(
              f"{k} {v:.2e}" for k, v in diffs.items()) +
          f" (tol {TOL_SERVE}), positions finite; ms per call (CUDA events, "
          f"mean of {RATIO_CALLS} calls, {RATIO_TURNS} alternating turns): "
          f"artifact {', '.join(f'{v:.1f}' for v in ms['artifact'])} "
          f"(median {np.median(ms['artifact']):.1f}), eager "
          f"{', '.join(f'{v:.1f}' for v in ms['eager'])} (median "
          f"{np.median(ms['eager']):.1f}); artifact/eager per turn "
          f"{min(ratio):.3f}..{max(ratio):.3f} (median "
          f"{np.median(ratio):.3f})  [{card}]", flush=True)
    del pipe, model, ours, ref, batch, sd
    torch.cuda.empty_cache()

    # 5. Diagnose the checkpoint; 6. the demo on Config() (the gather).
    _, out = counted("diag_3d", diag_3d.main, [
        "--ckpt-dir", ck, "--batches", "1", "--batch", "8"])
    if (not re.search(r"\d+ detections / \d+ gts / \d+ matched", out) or
            not launches["diag_3d"].get("f32")):
        raise RuntimeError(f"serving: diag_3d launched {launches['diag_3d']}")
    png = os.path.join(work, "demo.png")
    counted("demo", demo.main, ["--synthetic", "--out", png])
    h, w = base.data.image_h, base.data.image_w
    size = _png_size(png)
    if size != (w, 2 * h + demo.bev_side(h, w)) or launches["demo"]:
        raise RuntimeError(f"serving: demo PNG {size}, K1 launches "
                           f"{launches['demo']} (the gather launches none)")
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    k1_serving = {}
    for name, by_hat in launches.items():
        for hat, n in by_hat.items():
            k1_serving[hat] = k1_serving.get(hat, 0) + n
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s; " +
          ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) +
          f"; artifact {mb:.1f} MB, traced in {trace_s:.1f} s, saved in "
          f"{save_s:.1f} s, loaded in {load_s:.1f} s (serve); serve "
          f"{SERVE_FRAMES} frames at batch 8: first batch {first_s:.3f} s, "
          f"then {pairs_s:.2f} pairs/s over {steady_n} frames (loading "
          f"excluded; per batch {per_batch}); demo PNG {size[0]}x{size[1]}; K1 launches by tool "
          f"{launches}; plain versions 0 calls  [{card}]", flush=True)
    return k1_serving


# Phase 13's tolerance for several ranks against one process at the global
# batch: the loss, relative; and each top-level module's update (new - old)
# in norm, ||dp - one|| / ||one||.  cuDNN picks its algorithms by batch
# size, so the two sum in other orders.  In bf16 a feature one rounding
# apart reorders near-equal random proposal scores, and the sampled rois
# differ (measured on "NVIDIA H100 80GB HBM3, 700.00 W", two gloo ranks of
# one card: loss 2.6e-3 apart, the keypoint head's update 0.26); so the
# check runs in float32 with the RPN's objectness scaled up 300x (scores
# saturate, ties broken by index), as the CPU parity tests do: measured
# loss 2.6e-7 apart, updates 5.5e-4 at most (backbone).
TOL_DP_LOSS = 1e-3
TOL_DP_UPDATE = 5e-3


def _flat(tree):
    """The tensors of nested tuples, in order."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def _dp_train_rank(batch_path, backend, one_card, steps, out_path,
                   compute_dtype, rpn_scale, compare):
    """One rank of phase 13's training check (a spawned process):
    ``synthetic_fullres_config()`` in ``compute_dtype`` with the RPN's
    objectness scaled by ``rpn_scale`` (its deltas divided by it); one
    data-parallel step from the initial state, with ``compare`` held on
    rank 0 against one process at the global batch (cuDNN deterministic
    for both: with one rank the two must be the same bits), then
    ``steps`` timed steps and the gradient all-reduce alone."""
    from stereo_rcnn_tpu_torch.config import synthetic_fullres_config
    from stereo_rcnn_tpu_torch.ops import stereo_roi_align as sra
    from stereo_rcnn_tpu_torch.parallel import (data_parallel_train_step,
                                                make_mesh, replicate,
                                                shard_batch)
    from stereo_rcnn_tpu_torch.parallel.mesh import all_reduce_gradients
    from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                             make_train_step, step_generator)
    from stereo_rcnn_tpu_torch.train.step import trainable_params
    from stereo_rcnn_tpu_torch.train.targets import (GroundTruth,
                                                     ground_truth_to_torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(synthetic_fullres_config(),
                              compute_dtype=compute_dtype)
    k1, k2 = sra.stereo_roi_align_kernel, sra.stereo_roi_align_bwd_kernel
    with make_mesh(device="cuda:0" if one_card else None,
                   backend=backend) as mesh:
        dev = mesh.device
        gb = cfg.train.batch_per_device * mesh.data_size
        with np.load(batch_path) as z:
            il, ir = z["il"][:gb], z["ir"][:gb]
            gt = GroundTruth(*[z[k][:gb] for k in GroundTruth._fields])

        def on_dev(l_, r_, g_):
            return Batch(torch.from_numpy(l_).to(dev),
                         torch.from_numpy(r_).to(dev),
                         ground_truth_to_torch(g_, dev))
        local = on_dev(*shard_batch(mesh, (il, ir, gt)))
        state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
        with torch.no_grad():
            rpn = state.model.RCNN_rpn
            rpn.RPN_cls_score.weight.mul_(rpn_scale)
            rpn.RPN_bbox_pred.weight.div_(rpn_scale)
        replicate(mesh, [state.model, state.uncert])
        start = {k: v.detach().clone()
                 for k, v in state.model.state_dict().items()}
        start_u = state.uncert.detach().clone()
        step = data_parallel_train_step(make_train_step(cfg, device=dev),
                                        mesh)
        torch.backends.cudnn.deterministic = True
        metrics = step(state, local, step_generator(1, 0, dev))
        res = {"rank": mesh.rank, "world": mesh.world_size,
               "backend": mesh.backend, "total": float(metrics["total"])}
        if compare and mesh.rank == 0:
            dp = {k: v.detach().clone()
                  for k, v in trainable_params(state).items()}
            ref = init_train_state(cfg, state_dict={**start,
                                                    "uncert": start_u},
                                   device=dev)
            ref_m = make_train_step(cfg, device=dev)(
                ref, on_dev(il, ir, gt), step_generator(1, 0, dev))
            one = trainable_params(ref)
            res["ref_total"] = float(ref_m["total"])
            res["same_bits"] = (
                all(torch.equal(dp[k], one[k]) for k in dp) and
                all(torch.equal(state.trace[k], ref.trace[k])
                    for k in ref.trace) and
                all(torch.equal(metrics[k], ref_m[k]) for k in ref_m))
            by_mod = {}
            for k, v in dp.items():
                old = start_u if k == "uncert" else start[k]
                d, o = by_mod.setdefault(k.split(".")[0], [0.0, 0.0])
                by_mod[k.split(".")[0]] = [
                    d + float((v - one[k]).detach().double().square().sum()),
                    o + float((one[k] - old).detach().double().square()
                              .sum())]
            res["update_rel"] = {m: (d / o) ** 0.5 if o else 0.0
                                 for m, (d, o) in by_mod.items()}
            del ref, one, dp
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
        mesh.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        k1.reset_counts()
        k2.reset_counts()
        times = []
        for i in range(steps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            metrics = step(state, local, step_generator(1, i + 1, dev),
                           reduce_metrics=i + 1 == steps)
            t1.record()
            torch.cuda.synchronize(dev)
            times.append(t0.elapsed_time(t1))
        res["launches"] = {"K1": k1.launches, "K2": k2.launches}
        res["last_total"] = float(metrics["total"])
        res["times"] = times
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        params = trainable_params(state)
        ar = []
        for _ in range(5):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            all_reduce_gradients(mesh, params)
            t1.record()
            torch.cuda.synchronize(dev)
            ar.append(t0.elapsed_time(t1))
        res["allreduce_ms"] = ar
        res["grad_mb"] = sum(p.grad.numel() * p.grad.element_size()
                             for p in params.values()
                             if p.grad is not None) / 1e6
    with open(f"{out_path}.{res['rank']}.json", "w") as f:
        json.dump(res, f)
    return 0


def _dp_infer_rank(inputs_path, backend, one_card, calls, out_path):
    """One rank of phase 13's sharded inference: ``bench.py``'s program on
    this rank's rows, alone and through ``data_parallel_inference``."""
    from stereo_rcnn_tpu_torch import Config, init_params, make_full_pipeline
    from stereo_rcnn_tpu_torch.inference import broadcast_calib
    from stereo_rcnn_tpu_torch.ops import stereo_roi_align as sra
    from stereo_rcnn_tpu_torch.parallel import (batch_sharding,
                                                data_parallel_inference,
                                                make_mesh, replicate)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = Config()
    cfg = dataclasses.replace(base, rcnn=dataclasses.replace(
        base.rcnn, roi_align_impl="pallas", roi_align_hat="kron_bf16"))
    k1 = sra.stereo_roi_align_kernel
    with make_mesh(device="cuda:0" if one_card else None,
                   backend=backend) as mesh:
        dev = mesh.device
        il, ir, calib = torch.load(inputs_path, weights_only=False)
        b = il.shape[0]
        left = torch.from_numpy(il).to(dev)
        right = torch.from_numpy(ir).to(dev)
        calib_b = broadcast_calib(calib, b, dev)
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)
        replicate(mesh, model)
        fn = make_full_pipeline(cfg)
        rows = batch_sharding(mesh).rows(b)
        alone = fn(model, left[rows], right[rows],
                   type(calib_b)(*[x[rows] for x in calib_b]))
        infer = data_parallel_inference(fn, mesh)
        k1.reset_counts()
        out = infer(model, left, right, calib_b)
        torch.cuda.synchronize(dev)
        launches = dict(k1.launches_by_hat)
        same = all(torch.equal(g[rows], a)
                   for g, a in zip(_flat(out), _flat(alone)))
        n_det = _check_detections(out, b, cfg.rcnn.max_detections)
        walls = []
        for _ in range(calls):
            t0 = time.perf_counter()
            infer(model, left, right, calib_b)
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        res = {"rank": mesh.rank, "world": mesh.world_size,
               "backend": mesh.backend, "rows": [rows.start, rows.stop],
               "same_bits": same, "n_det": n_det, "launches": launches,
               "ms": walls}
    with open(f"{out_path}.{res['rank']}.json", "w") as f:
        json.dump(res, f)
    return 0


def _rank_results(out_path, n):
    out = []
    for r in range(n):
        with open(f"{out_path}.{r}.json") as f:
            out.append(json.load(f))
    return out


def _spawned(what, fn, n, *args):
    from stereo_rcnn_tpu_torch.parallel.launch import spawn
    t0 = time.perf_counter()
    codes = spawn(fn, n, *args, timeout=900)
    wall = time.perf_counter() - t0
    if codes != [0] * n:
        raise RuntimeError(f"data_parallel: {what} ranks exited {codes}")
    return wall


def data_parallel(sra, dev, card, work):
    """Phase 13: data parallelism over ``torch.distributed`` at full width,
    in spawned rank processes: the training step over the visible cards
    (NCCL), two gloo ranks on one card against one process at batch 16,
    sharded inference of ``bench.py``'s program over two ranks, then
    ``tools.train`` over the visible cards (2 steps; SIGTERM during a step
    and ``--resume``) and ``tools.dryrun_multichip``."""
    import os
    import signal
    import shutil

    from stereo_rcnn_tpu_torch import Config, synthetic_images
    from stereo_rcnn_tpu_torch.config import synthetic_fullres_config
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
    from stereo_rcnn_tpu_torch.train.checkpoint import latest_step

    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    dp_dir = os.path.join(work, "data_parallel")
    shutil.rmtree(dp_dir, ignore_errors=True)
    os.makedirs(dp_dir)
    t0 = time.perf_counter()
    cfg = synthetic_fullres_config()
    il, ir, gt, _ = synthetic_batch(cfg, 8 * max(n, 2), seed=7, n_objects=5)
    batch_path = os.path.join(dp_dir, "batch.npz")
    np.savez(batch_path, il=il, ir=ir, **gt._asdict())
    il, ir, calib = synthetic_images(Config(), 16, seed=7, n_objects=5)
    infer_path = os.path.join(dp_dir, "infer.pt")
    torch.save((il, ir, calib), infer_path)
    del il, ir, gt
    torch.cuda.empty_cache()
    print(f"data_parallel: rendered {8 * max(n, 2)} training and 16 "
          f"inference scenes in {time.perf_counter() - t0:.1f} s; {n} "
          f"visible card(s)", flush=True)
    walls, out = {}, {"launches": {"K1": 0, "K2": 0, "K1 kron_bf16": 0}}

    # 1, 2. The training step: NCCL over the visible cards, then two gloo
    # ranks on one card.
    # The shipped config (bf16) over every card: one rank must give the
    # bits of one process; on several cards it is timed, and two of them
    # run the float32 check (TOL_DP_UPDATE) against one process at batch
    # 16, as two gloo ranks of one card do everywhere.
    runs = [("nccl", "nccl", False, n, "bfloat16", 1.0, n == 1)]
    if n >= 2:
        runs.append(("nccl, 2 cards", "nccl", False, 2, "float32", 300.0,
                     True))
    runs.append(("gloo, one card", "gloo", True, 2, "float32", 300.0, True))
    for what, backend, one_card, world, dtype, rpn_scale, compare in runs:
        path = os.path.join(dp_dir, f"train_{len(walls)}")
        walls[f"train {what}"] = _spawned(what, _dp_train_rank, world,
                                          batch_path, backend, one_card, 3,
                                          path, dtype, rpn_scale, compare)
        res = _rank_results(path, world)
        lead = res[0]
        if not compare:
            ok, how = True, "timed only (the check runs on 2 cards)"
        elif world == 1:
            ok = lead["same_bits"]
            how = "the same bits as one process (cuDNN deterministic)"
        else:
            rel_loss = abs(lead["total"] - lead["ref_total"]) / abs(
                lead["ref_total"])
            worst = max(lead["update_rel"].values())
            ok = rel_loss <= TOL_DP_LOSS and worst <= TOL_DP_UPDATE
            how = (f"float32, RPN objectness x{rpn_scale:.0f}: loss "
                   f"{rel_loss:.2e} from one process at batch "
                   f"{8 * world} (tol {TOL_DP_LOSS:.0e}), updates by module "
                   + ", ".join(f"{m} {v:.2e}"
                               for m, v in lead["update_rel"].items()) +
                   f" (tol {TOL_DP_UPDATE:.0e} in norm)")
        launches = [r["launches"] for r in res]
        if not ok or any(l_ != {"K1": 3, "K2": 3} for l_ in launches):
            raise RuntimeError(f"data_parallel {what}: {how}; launches "
                               f"{launches}")
        for r in res:
            out["launches"]["K1"] += r["launches"]["K1"]
            out["launches"]["K2"] += r["launches"]["K2"]
        ms = sorted(lead["times"])[len(lead["times"]) // 2]
        ar = sorted(lead["allreduce_ms"])[len(lead["allreduce_ms"]) // 2]
        peaks = ", ".join(f"{r['peak_gib']:.2f}" for r in res)
        out[f"train {what}"] = {"ms": ms, "allreduce_ms": ar,
                                "world": world, "dtype": dtype}
        print(f"data_parallel train, {what}, {world} rank(s) x batch 8, "
              f"{dtype}: "
              f"{how}; {ms:.1f} ms/step (median of "
              f"{', '.join(f'{t:.1f}' for t in lead['times'])}), "
              f"{8 * world * 1000.0 / ms:.2f} global pairs/s; gradient "
              f"all-reduce {ar:.2f} ms ({lead['grad_mb']:.0f} MB, median of "
              f"5); peak memory per rank {peaks} GiB; K1 "
              f"and K2 3 launches per rank; wall {walls[f'train {what}']:.1f}"
              f" s  [{card}]", flush=True)

    # 3. Sharded inference over two ranks (NCCL on two cards, else gloo on
    # one).
    world = 2
    backend = "nccl" if n >= 2 else "gloo"
    path = os.path.join(dp_dir, "infer")
    walls["inference"] = _spawned("inference", _dp_infer_rank, world,
                                  infer_path, backend, n < 2, 3, path)
    res = _rank_results(path, world)
    if not all(r["same_bits"] and r["launches"]["kron_bf16"] == 1
               for r in res):
        raise RuntimeError(f"data_parallel inference: {res}")
    out["launches"]["K1 kron_bf16"] = sum(r["launches"]["kron_bf16"]
                                          for r in res)
    ms = sorted(res[0]["ms"])[1]
    out["inference"] = {"ms": ms, "backend": backend}
    print(f"data_parallel inference, bench.py's program at global batch 16 "
          f"over {world} {backend} ranks: each rank's rows of the gathered "
          f"detections equal its pipeline alone on them bit for bit "
          f"(rows {[r['rows'] for r in res]}), {res[0]['n_det']} detections"
          f", finite; {ms:.1f} ms per call (median of 3: "
          f"{', '.join(f'{t:.1f}' for t in res[0]['ms'])}); K1 kron_bf16 1 "
          f"launch per rank  [{card}]", flush=True)

    # 4. The CLIs over the visible cards, on the tools phase's tree.
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    tree = os.path.join(work, "kitti")
    common = ["--config", os.path.join(work, "synthetic_fullres.json"),
              "--kitti-root", tree, "--image-ext", ".npy",
              "--batch-per-device", "8", "--disp-interval", "1"]

    def cli(name, *args):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m",
                               f"stereo_rcnn_tpu_torch.tools.{name}", *args],
                              capture_output=True, text=True, env=env,
                              timeout=900)
        return proc, time.perf_counter() - t0

    ck_a = os.path.join(dp_dir, "ckpt_a")
    proc, walls["train 2 steps"] = cli("train", *common, "--ckpt-dir", ck_a,
                                       "--epochs", "2")
    if (proc.returncode != 0 or latest_step(ck_a) != 2 or
            f"devices: {n}, global batch: {8 * n}" not in proc.stdout):
        raise RuntimeError(f"data_parallel: tools.train rc "
                           f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    ck_b = os.path.join(dp_dir, "ckpt_b")
    t0 = time.perf_counter()
    trainer = subprocess.Popen(
        [sys.executable, "-m", "stereo_rcnn_tpu_torch.tools.train", *common,
         "--ckpt-dir", ck_b, "--epochs", "50", "--ckpt-every", "1000"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    lines = []
    try:
        for line in trainer.stdout:
            lines.append(line)
            if line.startswith("[step 1]"):
                # Past the first epoch's end (one step an epoch here),
                # into the second step's batch loading or step.
                time.sleep(0.5)
                trainer.send_signal(signal.SIGTERM)
                break
        rest, _ = trainer.communicate(timeout=600)
        lines.append(rest)
    finally:
        if trainer.poll() is None:
            trainer.kill()
            trainer.wait()
    walls["train SIGTERM"] = time.perf_counter() - t0
    text = "".join(lines)
    saved = latest_step(ck_b)
    ckpts = [f for f in os.listdir(ck_b) if f.startswith("ckpt_")]
    # The flag is read after each step and at each epoch's end.
    if (trainer.returncode != 75 or saved is None or len(ckpts) != 1 or
            not re.search(rf"preempted at (step {saved} |epoch boundary "
                          rf"{saved}/)", text)):
        raise RuntimeError(f"data_parallel: SIGTERM run rc "
                           f"{trainer.returncode}, checkpoints {ckpts}\n"
                           f"{text}")
    proc, walls["train --resume"] = cli("train", *common, "--ckpt-dir", ck_b,
                                        "--epochs", "3", "--resume")
    if (proc.returncode != 0 or latest_step(ck_b) != 3 or
            f"resumed from step {saved}" not in proc.stdout):
        raise RuntimeError(f"data_parallel: --resume rc {proc.returncode}"
                           f"\n{proc.stdout}{proc.stderr}")
    proc, walls["dryrun_multichip"] = cli("dryrun_multichip")
    if (proc.returncode != 0 or "train OK" not in proc.stdout or
            "inference OK" not in proc.stdout):
        raise RuntimeError(f"data_parallel: dryrun_multichip rc "
                           f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    print("  dryrun_multichip| " + "\n  dryrun_multichip| ".join(
        proc.stdout.strip().splitlines()), flush=True)
    shutil.rmtree(dp_dir)
    out["saved_at"] = saved
    print(f"data_parallel phase: {time.perf_counter() - t_phase:.1f} s; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) +
          f"; SIGTERM: rc 75, one checkpoint at step {saved}, --resume to "
          f"step 3; launches on the path {out['launches']}  [{card}]",
          flush=True)
    return out


def multiclass(sra, dev, card):
    """Phase 14: the multi-class configuration (background / Car / Van) at
    full width: training steps, the pipeline at batch 16, and the
    training and evaluation CLIs on a two-class tree."""
    import os
    import shutil

    from stereo_rcnn_tpu_torch.config import (save_config,
                                              synthetic_multiclass_config)
    from stereo_rcnn_tpu_torch.data.synthetic import (random_scene,
                                                      render_pair,
                                                      synthetic_batch,
                                                      synthetic_images,
                                                      write_kitti_frame)
    from stereo_rcnn_tpu_torch.geometry.calib import default_kitti_calib
    from stereo_rcnn_tpu_torch.inference import make_full_pipeline
    from stereo_rcnn_tpu_torch.models.detector import init_params
    from stereo_rcnn_tpu_torch.ops import conv_epilogue as ce
    from stereo_rcnn_tpu_torch.solve import box_estimator as be
    from stereo_rcnn_tpu_torch.tools import test_net, train
    from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                             make_train_step)
    from stereo_rcnn_tpu_torch.train.targets import ground_truth_to_torch

    k1, k2 = sra.stereo_roi_align_kernel, sra.stereo_roi_align_bwd_kernel
    cfg = synthetic_multiclass_config()
    b = cfg.train.batch_per_device
    launches = {}

    def counts():
        return {"K1": k1.launches, "K2": k2.launches}

    # Training: one warm-up and MULTICLASS_STEPS timed steps.
    il, ir, gt, _ = synthetic_batch(cfg, b, seed=7, n_objects=5)
    classes = set(gt.cls[gt.valid].tolist())
    if classes != {1, 2}:
        raise RuntimeError(f"multiclass: rendered classes {classes}")
    batch = Batch(torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev),
                  ground_truth_to_torch(gt, dev))
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    step = make_train_step(cfg, device=dev)
    tgen = torch.Generator(device=dev).manual_seed(0)
    print(f"multiclass: depth {cfg.backbone.depth}, norm "
          f"{cfg.backbone.norm}, remat {cfg.backbone.remat}, "
          f"{cfg.rcnn.roi_align_impl} RoIAlign ({cfg.rcnn.roi_align_hat}), "
          f"{cfg.data.image_w}x{cfg.data.image_h}, {cfg.compute_dtype}, "
          f"classes {cfg.data.classes}, {cfg.rcnn.rois_per_image} rois per "
          f"image, batch {b}; GT classes {sorted(classes)}", flush=True)
    params = dict(state.model.named_parameters())
    cls_w = "rcnn_head.RCNN_cls_score.weight"
    before = params[cls_w].detach().clone()
    torch.cuda.reset_peak_memory_stats()
    k1.reset_counts()
    k2.reset_counts()
    with _PlainCalls(sra) as plain:
        times, host = _train_steps(
            step, state, batch, tgen, params,
            (cls_w, "backbone_net.RCNN_layer4.0.conv2.weight"),
            MULTICLASS_STEPS, card, "multiclass train")
    launches["training"] = counts()
    expect = MULTICLASS_STEPS + 1
    if plain or launches["training"] != {"K1": expect, "K2": expect}:
        raise RuntimeError(f"multiclass training: launches "
                           f"{launches['training']} (expected {expect} "
                           f"each), plain versions {plain}")
    moved = (params[cls_w].detach() - before).abs().amax(dim=1)
    if moved.numel() != 3 or not bool((moved > 0).all()):
        raise RuntimeError(f"multiclass: cls_score rows moved {moved}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = sorted(times)[len(times) // 2]
    print(f"multiclass training: {ms:.1f} ms/step (median of {len(times)}:"
          f" {', '.join(f'{t:.1f}' for t in times)}; host "
          f"{', '.join(f'{t:.1f}' for t in host)}), {b * 1000.0 / ms:.2f} "
          f"pairs/s at batch {b}, peak memory {peak:.2f} GiB; launches "
          f"{launches['training']}; cls_score rows (bg, Car, Van) moved "
          f"{[f'{v:.2e}' for v in moved.tolist()]}  [{card}]", flush=True)
    del state, step, batch, params, before
    torch.cuda.empty_cache()

    # The pipeline at batch 16 with K1.
    bi = 16
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    il, ir, calib = synthetic_images(cfg, bi, seed=7, n_objects=5)
    left, right = torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev)
    fn = make_full_pipeline(cfg, calib)
    k1.reset_counts()
    k2.reset_counts()
    with _PlainCalls(sra, be, ce) as plain:
        out = fn(model, left, right)
        torch.cuda.synchronize()
    launches["inference"] = counts()
    if plain or launches["inference"] != {"K1": 1, "K2": 0}:
        raise RuntimeError(f"multiclass inference: launches "
                           f"{launches['inference']}, plain {plain}")
    n_valid = _check_detections(out, bi, cfg.rcnn.max_detections)
    by_class = {int(c): int(((out.det.cls == c) & out.det.valid).sum())
                for c in (1, 2)}
    call_ms = _events_ms(lambda: fn(model, left, right), 3)
    print(f"multiclass inference: batch {bi}, {n_valid} valid detections "
          f"(by class {by_class}), detections "
          f"{tuple(out.det.valid.shape)}, {call_ms:.1f} ms per call, "
          f"{bi * 1000.0 / call_ms:.2f} pairs/s  [{card}]", flush=True)
    del model, out, left, right
    torch.cuda.empty_cache()

    # tools.train then tools.test_net on an 8-frame two-class tree.
    work = os.path.join("runs", "chip_smoke_multiclass")
    shutil.rmtree(work, ignore_errors=True)
    tree, ck = os.path.join(work, "kitti"), os.path.join(work, "ckpt")
    os.makedirs(work)
    cfg_json = os.path.join(work, "synthetic_multiclass.json")
    save_config(cfg, cfg_json)
    kcalib = default_kitti_calib()
    rng = np.random.RandomState(13)
    n_van = 0
    for i in range(8):
        objs = random_scene(rng, 4, kcalib, 375, 1242,
                            class_names=("Car", "Van"))
        n_van += sum(o.type == "Van" for o in objs)
        left, right = render_pair(objs, kcalib, 375, 1242, rng)
        write_kitti_frame(tree, f"{i:06d}", objs, kcalib, left, right)
    if not n_van:
        raise RuntimeError("multiclass: the tree holds no Van")
    walls = {}
    k1.reset_counts()
    k2.reset_counts()
    with _PlainCalls(sra) as plain:
        state, _, walls["train"] = _cli(
            "mc train", train.run, train.parse_args(
                ["--config", cfg_json, "--kitti-root", tree, "--image-ext",
                 ".npy", "--batch-per-device", "8", "--ckpt-dir", ck,
                 "--epochs", "2", "--disp-interval", "1"]))
        got_train = counts()
        k1.reset_counts()
        k2.reset_counts()
        _, out, walls["test_net"] = _cli("mc test_net", test_net.main, [
            "--kitti-root", tree, "--ckpt-dir", ck, "--out",
            os.path.join(work, "results"), "--batch", "8", "--image-ext",
            ".npy"])
        got_test = counts()
    launches["tools"] = {"K1": got_train["K1"] + got_test["K1"],
                         "K2": got_train["K2"]}
    if (plain or state.step != 2 or got_train != {"K1": 2, "K2": 2} or
            got_test["K1"] < 1 or got_test["K2"]):
        raise RuntimeError(f"multiclass tools: step {state.step}, train "
                           f"launches {got_train}, test_net {got_test}, "
                           f"plain {plain}")
    for name in ("Car", "Van"):
        if f"[{name}] AP_3d@0.5 (R40)" not in out:
            raise RuntimeError(f"multiclass: test_net printed no {name} AP")
    del state
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    print(f"multiclass tools: train {walls['train']:.1f} s, test_net "
          f"{walls['test_net']:.1f} s; both per-class AP lines printed; "
          f"launches {launches['tools']}; plain versions 0 calls  [{card}]",
          flush=True)
    return {"ms": ms, "pairs_per_s": b * 1000.0 / ms, "peak_gib": peak,
            "launches": launches}


def perf_tools(sra, card):
    """Phase 15: the stage-breakdown and roofline tools as a user runs
    them, at batch 16, with the fused RoIAlign and with the gather."""
    from stereo_rcnn_tpu_torch.tools import perf_breakdown, roofline

    k1 = sra.stereo_roi_align_kernel
    launches = {}
    tables = {}
    for impl in ("pallas", "xla"):
        argv = ["--batch", "16", "--iters", str(PERF_TOOL_ITERS), "--impl",
                impl]
        k1.reset_counts()
        with _PlainCalls(sra) as plain:
            _cli(f"perf_breakdown {impl}", perf_breakdown.main, argv)
            rows, _, _ = _cli(f"roofline {impl}", roofline.main, argv)
        launches[impl] = k1.launches
        if plain or (k1.launches > 0) != (impl == "pallas"):
            raise RuntimeError(f"perf_tools {impl}: K1 launches "
                               f"{k1.launches}, plain versions {plain}")
        worst = max(max(r["util"], r["mfu"]) for r in rows)
        if worst > roofline.MAX_SHARE:
            raise RuntimeError(f"perf_tools {impl}: a share {worst} above "
                               f"{roofline.MAX_SHARE}")
        tables[impl] = rows
        torch.cuda.empty_cache()
    print(f"perf_tools: K1 launches {launches}; no util or MFU above "
          f"{roofline.MAX_SHARE}  [{card}]", flush=True)
    return {"launches": launches["pallas"], "tables": tables}


def golden(dev, card):
    """Phase 16: ``tools.capture_golden`` on a ``.pth`` in the upstream
    names written from a random ``Config()`` model."""
    import ast
    import os
    import shutil

    from stereo_rcnn_tpu_torch.config import Config
    from stereo_rcnn_tpu_torch.data.synthetic import (random_scene,
                                                      render_pair,
                                                      write_kitti_frame)
    from stereo_rcnn_tpu_torch.geometry.calib import default_kitti_calib
    from stereo_rcnn_tpu_torch.models.detector import init_params
    from stereo_rcnn_tpu_torch.tools import capture_golden

    work = os.path.join("runs", "chip_smoke_golden")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    model = init_params(Config(), torch.Generator().manual_seed(0), dev)
    pth = os.path.join(work, "upstream.pth")
    torch.save({"model": upstream_state_dict(model), "epoch": 12}, pth)
    del model
    calib = default_kitti_calib()
    rng = np.random.RandomState(17)
    objs = random_scene(rng, 4, calib, 375, 1242)
    left, right = render_pair(objs, calib, 375, 1242, rng)
    write_kitti_frame(work, "000000", objs, calib, left, right)
    tr = os.path.join(work, "training")
    npz = os.path.join(work, "golden.npz")
    arrays, out, wall = _cli("capture_golden", capture_golden.main, [
        "--pth", pth, "--left", os.path.join(tr, "image_2", "000000.npy"),
        "--right", os.path.join(tr, "image_3", "000000.npy"), "--calib",
        os.path.join(tr, "calib", "000000.txt"), "--out", npz])
    # The JAX tool's keys, read from its np.savez call.
    with open(os.path.join("tools", "capture_golden.py")) as f:
        keys = next(tuple(k.arg for k in node.keywords)
                    for node in ast.walk(ast.parse(f.read()))
                    if isinstance(node, ast.Call) and
                    getattr(node.func, "attr", "") == "savez")
    with np.load(npz) as f:
        saved = {k: f[k] for k in f.files}
    valid = saved["valid"]
    bad = [k for k, v in saved.items() if k != "valid" and
           not np.isfinite(v[valid] if v.ndim and len(v) == len(valid)
                           else v).all()]
    if (tuple(saved) != keys or bad or "UNCLAIMED" in out or
            "checkpoint extras: ['epoch']" not in out):
        raise RuntimeError(f"golden: keys {tuple(saved)} (the JAX tool's: "
                           f"{keys}), non-finite {bad}")
    shutil.rmtree(work)
    print(f"golden: {wall:.1f} s, {int(valid.sum())} detections, the JAX "
          f"tool's {len(keys)} keys, finite  [{card}]", flush=True)
    return saved


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--training-only", action="store_true",
                        help="run only the build and the training phases; "
                             "prints no result line")
    parser.add_argument("--train-steps", type=int, default=3,
                        help="timed steps on the fused training path")
    parser.add_argument("--digests", metavar="PATH",
                        help="write the sha256 of every K1, K2, K3 and K4 "
                             "output checked to PATH (JSON)")
    args = parser.parse_args(argv)
    # -- 1. environment --------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs a CUDA device")
    from stereo_rcnn_tpu_torch.ops import conv_epilogue as ce
    from stereo_rcnn_tpu_torch.ops import roi_align_window as win
    from stereo_rcnn_tpu_torch.ops import stereo_roi_align as sra
    from stereo_rcnn_tpu_torch.ops.cuda_build import load_kernels
    from stereo_rcnn_tpu_torch.solve import box_estimator as be

    t_start = time.perf_counter()
    phase_s = {}
    kernels = (sra.stereo_roi_align_kernel, sra.stereo_roi_align_bwd_kernel,
               win.roi_align_window_kernel, sra.stereo_roi_align_atlas_kernel,
               be.gauss_newton_solve_kernel, ce.conv_epilogue_kernel)
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

    # K5's and K6's launches by phase, from counts reset as each phase
    # starts.
    k5_by_phase, k6_by_phase = {}, {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        be.gauss_newton_solve_kernel.reset_counts()
        ce.conv_epilogue_kernel.reset_counts()
        res = fn(*args)
        k5_by_phase[name] = be.gauss_newton_solve_kernel.launches
        k6_by_phase[name] = ce.conv_epilogue_kernel.launches
        phase_s[name] = time.perf_counter() - t0
        print(f"[phase {name}: {phase_s[name]:.1f} s]", flush=True)
        return res

    # -- 2. build ---------------------------------------------------------
    def build():
        load_kernels(kernels)
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
    digests = None if args.digests is None else {}
    k1 = phase("K1", check_k1, sra, dev, gen, card, digests)
    k2 = phase("K2", check_k2, sra, dev, gen, card, digests)
    k3 = phase("K3", check_k3, dev, gen, card, digests)
    k4 = phase("K4", check_k4, sra, dev, gen, card, digests)
    k5 = phase("K5", check_k5, dev, card, digests)
    k6 = phase("K6", check_k6, dev, card, digests)
    if digests is not None:
        with open(args.digests, "w") as f:
            json.dump(digests, f, indent=1, sort_keys=True)
        print(f"{len(digests)} output digests written to {args.digests}",
              flush=True)
    _, infer_launches, _ = phase("inference", inference, sra, dev, card)
    train = phase("training", training, sra, dev, card, args.train_steps)
    _, tool_k1, tool_k4 = phase("bench_roialign", bench_tool, sra)
    cli, work = phase("tools", tools, sra, dev, card)
    dp = phase("data_parallel", data_parallel, sra, dev, card, work)
    served = phase("serving", serving, sra, dev, card, work)
    mc = phase("multiclass", multiclass, sra, dev, card)
    perf = phase("perf_tools", perf_tools, sra, card)
    phase("golden", golden, dev, card)

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
            paths["tools"] = cli["K1"]
            paths["data_parallel training"] = dp["launches"]["K1"]
            for what in ("training", "inference", "tools"):
                paths[f"multiclass {what}"] = mc["launches"][what]["K1"]
            paths["perf_tools"] = perf["launches"]
        if hat == "kron_bf16":
            paths["data_parallel inference"] = dp["launches"]["K1 kron_bf16"]
        if served.get(hat):
            paths["serving"] = served[hat]
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
    k2_paths["tools"] = cli["K2"]
    k2_paths["data_parallel training"] = dp["launches"]["K2"]
    k2_paths["multiclass training"] = mc["launches"]["training"]["K2"]
    k2_paths["multiclass tools"] = mc["launches"]["tools"]["K2"]
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
        "store_floor_ms": k3["store_floor_ms"], "bound_by": "bytes",
        "library_ms": None, "by_case": k3["by_case"],
        f"C={ODD_C}": k3[f"C={ODD_C}"]})
    entries.append({
        "name": "stereo_roi_align_atlas", "route": "cuda",
        "source": "stereo_rcnn_tpu_torch/csrc/stereo_roi_align_atlas.cu",
        "replaces": "stereo_rcnn_tpu/ops/roi_align_pallas.py:618",
        "launches": tool_k4, "launches_by_path": {"bench_roialign": tool_k4},
        **k4, "bound_by": "bytes", "library_ms": None})
    k5_paths = {name: n for name, n in k5_by_phase.items() if n}
    if not (k5_by_phase["K5"] and k5_by_phase["inference"]):
        raise RuntimeError(f"K5 launches by phase {k5_by_phase}: none in "
                           "its check or in the inference phase")
    entries.append({
        "name": "gauss_newton_solve", "route": "cuda",
        "source": "stereo_rcnn_tpu_torch/csrc/box_solve.cu",
        "replaces": "no Pallas kernel: stereo_rcnn_tpu/solve/"
                    "box_estimator.py::solve_batch is XLA-compiled jnp",
        "launches": sum(k5_paths.values()), "launches_by_path": k5_paths,
        **k5, "bound_by": "the serial chain of iterations",
        "library_ms": None})
    k6_paths = {name: n for name, n in k6_by_phase.items() if n}
    if not (k6_by_phase["K6"] and k6_by_phase["inference"]):
        raise RuntimeError(f"K6 launches by phase {k6_by_phase}: none in "
                           "its check or in the inference phase")
    entries.append({
        "name": "conv_epilogue", "route": "cuda",
        "source": "stereo_rcnn_tpu_torch/csrc/conv_epilogue.cu",
        "replaces": "no Pallas kernel: XLA fuses the epilogue into the "
                    "convolution on the TPU",
        "launches": sum(k6_paths.values()), "launches_by_path": k6_paths,
        **k6, "bound_by": "bytes", "library_ms": None})
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
