"""Build the port's CUDA kernels, time each alone, and drive its inference,
training, RoIAlign-benchmark, tools, data-parallel, serving, multi-class,
perf-tool and golden-capture paths once on one GPU (or, for the
data-parallel phase, on every visible card).

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit (``nvcc``).  The kernels' correctness in every mode,
lane width and edge case is checked by the card tests, ``python -m pytest
--noconftest -m cuda tests/test_torch_cuda.py``; this script holds each
kernel to the same limits at the main paths' shapes.  Comparisons of
two commits run in turns through ``h100_bench/run.py``, and the time of
each pipeline stage comes from ``utils.profiling.recording()`` on a real
call or ``h100_bench/stages.py``.  Phases, each raising on failure:

1. environment: torch / CUDA versions, the card's name and power limit,
   TF32 off for matmuls and convolutions;
2. build the six kernels, one ``nvcc`` per source, started together: K1
   the fused stereo RoIAlign in its five sampling-weight modes
   (csrc/stereo_roi_align.cu), K2 its backward
   (csrc/stereo_roi_align_bwd.cu), K3 the windowed one-sided RoIAlign
   (csrc/roi_align_window.cu), K4 the atlas variant
   (csrc/stereo_roi_align_atlas.cu), K5 the Gauss-Newton 3D solve
   (csrc/box_solve.cu) and K6 the backbone's convolution epilogue
   (csrc/conv_epilogue.cu); the register and spill lines of ``ptxas``;
3. kernels: one table of every kernel alone at the main paths' shapes
   (:func:`kernel_rows`): its device time (``torch.profiler``, 20
   launches), its plain PyTorch version's time on the same card (CUDA
   events), its bound (the bytes the work needs at the H100 SXM's
   3.35 TB/s) and the share of its output values equal to the plain
   version's; each row raises unless the output is within its plain
   version's limit, the card tests' limits (``utils.kernel_checks``: K1
   1e-4 with f32 weights, 1e-5 in the kron modes, the two-matmul rule in
   ``bf16`` and ``hilo``; K2 1e-5 of each level's largest value; K3 and
   K4 1e-4; K5 1e-3 on the well-posed rows, the same finiteness on all;
   K6 the same bits);
4. inference: ``make_full_pipeline`` at full width (ResNet-101, FPN 256,
   fc 2048, 1280x384, bf16; one random model from seed 0 and rendered
   scenes, seed 7, 5 objects) in three configurations, each at batch 16
   and batch 1: ``bench.py``'s program (``roi_align_impl="pallas"``,
   ``kron_bf16``), ``Config()`` itself (``"xla"``, the atlas gather: no
   K1) and the fused kernel with f32 weights; each call launches K5 twice
   (the solve and the z-fixed re-solve) and K6 107 times (the stem, 33
   bottlenecks x 3, the FPN's 7), gives detections of the right shapes,
   finite, and runs no plain version;
5. training: one ``make_train_step`` step of ``synthetic_fullres_config()``
   (ResNet-101, GroupNorm, remat, 1280x384, bf16, 128 rois per image) at
   batch 8 on rendered scenes (seed 7, 5 objects) per RoIAlign
   implementation: the fused one launches K1 and K2 once, the gather
   neither; finite losses, the head, trunk and stem updated, no plain
   version;
6. bench_roialign: the RoIAlign microbenchmark tool,
   ``stereo_rcnn_tpu_torch.tools.bench_roialign`` with ``--iters 5``: K1
   in each of its five modes, K4 (and its packing) and the gather; every
   K1 mode and K4 must launch;
7. tools: the training and evaluation CLIs as a user runs them, at full
   width (``synthetic_fullres_config()`` written as JSON, batch 8), with
   the native host preprocessing built: a KITTI tree of 8 rendered frames
   at 1242x375 written as ``.npy`` (``data.synthetic.write_kitti_frame``);
   ``tools.train`` for 2 epochs of 1 step (K1 and K2 launched twice,
   finite losses, a checkpoint, the params export and ``config.json``),
   then ``--resume --epochs 3`` (the restored state equal to the saved
   one, tensor for tensor; one more step, K1 and K2 once); ``tools.test_net``
   on the tree with the params export and ``tools.eval_synth --batches 1
   --batch 4``, each printing its AP lines and launching K1; no plain
   RoIAlign version runs.  Each CLI's wall seconds are printed;
8. data_parallel (after "tools", before "serving"), in spawned rank
   processes (``parallel.launch.spawn``): ``synthetic_fullres_config()``
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
   subprocesses on the tools phase's tree, ``tools.train`` over the
   visible cards (2 steps), a run stopped by SIGTERM after its first step
   (rc 75, one checkpoint) and its ``--resume``, and
   ``tools.dryrun_multichip``; each one's wall seconds are printed;
9. serving, on the tools phase's checkpoint and tree:
   ``convert.norm_calibrate`` from one image in float32, the calibrated
   backbone held to the GroupNorm one within 5e-5 of each level's largest
   value, written as a params export with its ``config.json`` (norm
   "frozen"); ``tools.calibrate_norm`` (batch 8, one calibration and one
   held-out batch), which a 3-step model may fail: rc 0 with all three
   files, or rc 1 with "validation FAILED" and no ``VALID``;
   ``tools.export_model`` of ``bench.py``'s program (``Config()``,
   ``"pallas"``, ``kron_bf16``) at batch 8 with the calibrated weights
   (the trace launches nothing), and ``--verify``; ``tools.serve`` on the
   tree, grown to 64 rendered frames, with the weights loaded over the
   artifact's (64 result files, K1 ``kron_bf16`` launched once a batch;
   the first batch's seconds and the pairs/s of the batches after it are
   printed apart); the loaded artifact against the eager pipeline on one
   batch of the tree (equal ``valid``, boxes and scores within 1e-3,
   finite positions; ms per call in 6 alternating turns of 3 calls);
   ``tools.diag_3d`` on the checkpoint (its match line, K1 launched) and
   ``tools.demo --synthetic`` (``Config()``'s gather: no K1; its PNG must
   decode to 1280x1536).  No plain RoIAlign version and no K2 runs.  The
   trace, save and load seconds, the artifact's MB, ``serve``'s first
   batch and steady pairs/s and each tool's wall seconds are printed;
10. multiclass: ``synthetic_multiclass_config()`` (background / Car /
    Van, per-class mean dims; ResNet-101, GroupNorm, remat, the fused
    RoIAlign with f32 weights, 1280x384, bf16, 128 rois per image):
    ``make_train_step`` at batch 8 on rendered two-class scenes (seed 7),
    one warm-up and two timed steps (K1 and K2 launched each step, finite
    losses, all three rows of ``cls_score`` updated);
    ``make_full_pipeline`` at batch 16 (K1 once, detections of shape
    [16, max_detections], finite); ``tools.train`` for 2 steps on an
    8-frame two-class ``.npy`` tree and ``tools.test_net`` on it (both
    ``[Car]`` and ``[Van]`` AP lines).  No plain RoIAlign version runs.
    ms/step, peak memory and pairs/s are printed;
11. perf_tools: the stage-breakdown and roofline tools
    (``tools.perf_breakdown``, ``tools.roofline``) at batch 16 with 3
    timed calls per prefix, with ``--impl pallas`` (K1 launches) and
    ``--impl xla`` (none); no util or MFU above 1.05;
12. golden: ``tools.capture_golden`` on a ``.pth`` in the upstream names
    written from a random ``Config()`` model
    (``convert.stereo_import.upstream_state_dict``), a rendered ``.npy``
    pair and its KITTI calib file: the ``.npz`` holds the JAX tool's keys
    (read from its ``np.savez`` call), finite.

Every phase's wall seconds are printed.  The line before the last is the
kernels' JSON record (the table, and each kernel's launches by phase);
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits non-zero and prints no result.

    python3 chip_smoke.py --digests PATH

also writes to PATH a JSON object of the sha256 of every kernel output
in the table, keyed by its row: the inputs come from seeded generators,
so two builds that give the same file give the same bits on them.  The
file is written right after the table, before the inference phase: to
compare two commits bit for bit, run this script in an unpacked parent
checkout too (a git-ignored directory such as ``_trees/parent/``, with
this script and, where the parent lacks them, the input builders of
``data/synthetic.py`` and ``utils/kernel_checks.py``) and compare the two
files.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import functools
import hashlib
import io
import json
import re
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from stereo_rcnn_tpu_torch.tools.bench_roialign import events_ms as _events_ms
from stereo_rcnn_tpu_torch.utils import kernel_checks as kc
from stereo_rcnn_tpu_torch.utils.kernel_checks import tensors

STRIDES = (4, 8, 16, 32)
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
# The multi-class phase's timed training steps (after one warm-up), and
# the calls each prefix of the perf tools times (after one warm-up).
MULTICLASS_STEPS = 2
PERF_TOOL_ITERS = 3
# H100 SXM device-memory rate (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
# The channel counts of the kernel table: the main paths' C = 256, an odd
# C (1-channel lanes, K1-K4) and, for K4, a C above its block's 256 lanes
# x 8 channels (a second pass of the lanes).
ODD_C = 255
WIDE_C = 2056
# K6's shape in the table: the offline call's C2 (16 stereo pairs,
# 1280x384).
K6_SHAPE = (32, 256, 96, 320)


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


def _sha256(out) -> str:
    """The sha256 of the bytes of every tensor of ``out``, in order."""
    h = hashlib.sha256()
    for t in tensors(out):
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _nbytes(*outs) -> int:
    return sum(t.numel() * t.element_size() for out in outs
               for t in tensors(out))


class Row(NamedTuple):
    """One kernel alone on one set of inputs."""

    name: str              # the kernel, its mode and shape
    kernel: str            # the CUDA kernel function's name
    card: Callable         # one launch
    plain: Callable        # the plain version on the same inputs
    check: Callable        # (out, ref): raises where out misses its limit
    n_bytes: int           # read and written once each: the bound's bytes


def kernel_rows(dev):
    """The table's rows, made lazily (each kernel's inputs live only while
    its rows are timed): K1 in each mode, K3 at both (P, s) and K4 at
    batch 16, 300 rois, bf16 levels, C = 256 and 255 (K4 also C = 2056 at
    batch 2); K2 at the training step's batch 8, 128 rois; K5 at the
    pipeline's N = 512 and 32, 30 iterations; K6 at :data:`K6_SHAPE` with
    a residual and a ReLU.  The inputs are the card tests' builders
    (``data.synthetic``)."""
    from stereo_rcnn_tpu_torch.data.synthetic import (synthetic_roi_inputs,
                                                      synthetic_solve_inputs)
    from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
    from stereo_rcnn_tpu_torch.ops import conv_epilogue as ce
    from stereo_rcnn_tpu_torch.ops import roi_align_window as win
    from stereo_rcnn_tpu_torch.ops import stereo_roi_align as sra
    from stereo_rcnn_tpu_torch.solve import box_estimator as be
    part = functools.partial
    bf16 = torch.bfloat16

    for c in (256, ODD_C):
        fl, fr, rl, rr = synthetic_roi_inputs(16, c, seed=c, device=dev,
                                              dtype=bf16)
        levels = _nbytes(fl, fr)
        shape = f"B=16 R=300 C={c}"
        for hat in sra.TOOL_HAT_MODES:
            args = (fl, fr, rl, rr, STRIDES, hat)
            yield Row(f"K1 {hat} {shape}", "stereo_roi_align_kernel",
                      part(sra.stereo_roi_align_kernel, *args),
                      part(sra.stereo_roi_align_packed_ref, *args),
                      part(kc.close_k1, hat=hat, feats=fl + fr),
                      16 * 300 * sra.ROWS * c * 4 + levels)
        for p, s in ((7, 2), (14, 1)):
            args = (fl, rl, STRIDES, p, s)
            yield Row(f"K3 P={p} s={s} {shape}", "roi_align_window_kernel",
                      part(win.roi_align_window_kernel, *args),
                      part(win.multilevel_roi_align_window_ref, *args),
                      kc.close_sampled, 16 * 300 * p * p * c * 4 + levels // 2)
        del fl, fr
    for b, c in ((16, 256), (16, ODD_C), (2, WIDE_C)):
        fl, fr, rl, rr = synthetic_roi_inputs(b, c, seed=c + 1, device=dev,
                                              dtype=bf16)
        shapes = [(f.shape[1], f.shape[2]) for f in fl]
        atlases = (sra.pack_atlas(fl)[0], sra.pack_atlas(fr)[0])
        yield Row(f"K4 B={b} R=300 C={c}", "stereo_roi_align_atlas_kernel",
                  part(sra.stereo_roi_align_atlas_kernel, *atlases, shapes,
                       rl, rr, STRIDES),
                  part(sra.stereo_roi_align_atlas_ref, fl, fr, rl, rr,
                       STRIDES), kc.close_sampled,
                  b * 300 * (2 * sra.P * sra.P + sra.PK * sra.PK) * c * 4 +
                  _nbytes(fl, fr))
        del fl, fr, atlases
    for c in (256, ODD_C):
        _, _, rl, rr = synthetic_roi_inputs(8, 1, r=128, seed=c + 2,
                                            device=dev)
        shapes = [(384 // s, 1280 // s) for s in STRIDES]
        g = torch.randn(8, 128, sra.ROWS, c, device=dev, generator=(
            torch.Generator(device=dev).manual_seed(c + 3)))
        args = (g, rl, rr, shapes, STRIDES)
        # The cotangent rows the valid rois need (left 196 + 49, right 49)
        # and both sides' float32 gradients, each written once.
        n_l, n_r = [int((sra.roi_window_meta(shapes, x, STRIDES)[0][..., 3]
                         > 0).sum()) for x in (rl, rr)]
        yield Row(f"K2 B=8 R=128 C={c}", "stereo_roi_align_bwd_kernel",
                  part(sra.stereo_roi_align_bwd_kernel, *args),
                  part(sra.stereo_roi_align_packed_bwd_ref, *args),
                  kc.close_per_level,
                  (n_l * (sra.PK * sra.PK + sra.P * sra.P) +
                   n_r * sra.P * sra.P) * c * 4 +
                  2 * 8 * sum(h * w for h, w in shapes) * c * 4)
        del g
    for n in (512, 32):
        d = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_solve_inputs(n, seed=n).items()}
        cal = d["calib"].T.contiguous()
        ins = (d["obs"], d["obs_weights"], d["dims_hwl"], d["alpha"],
               d["kpt_idx"], *cal)
        yield Row(f"K5 N={n}", "gauss_newton_solve_kernel",
                  part(be.gauss_newton_solve_kernel, *ins, None, 30, 1e-3),
                  part(be.solve_batch_ref, d["obs"], d["dims_hwl"],
                       d["alpha"], d["kpt_idx"],
                       StereoCalib(*cal, None, None), d["obs_weights"], 30,
                       1e-3), part(kc.close_solve, well=d["well_posed"]),
                  _nbytes(ins) + n * 5 * 4)
    gen = torch.Generator(device=dev).manual_seed(6)
    y, r = [(4 * torch.randn(K6_SHAPE, generator=gen, device=dev)).to(
        bf16).contiguous(memory_format=torch.channels_last)
        for _ in range(2)]
    bias = torch.randn(K6_SHAPE[1], generator=gen, device=dev)
    yield Row(f"K6 {'x'.join(map(str, K6_SHAPE))} residual relu",
              "conv_epilogue_kernel",
              part(ce.conv_epilogue_kernel, y, bias, r, True,
                   out=torch.empty_like(y)),
              part(ce.conv_epilogue_ref, y, bias, r, True), kc.same_bits,
              3 * _nbytes(y))


def time_row(row: Row, card: str) -> dict:
    """A row of the table: the kernel's device ms (20 launches), its plain
    version's ms (2 calls, CUDA events), the bound's ms, and the share of
    the kernel's output values equal to the plain version's (NaN equal to
    NaN); and the sha256 of the kernel's output.  Raises where the output
    misses the row's limit (``utils.kernel_checks``, the card tests'
    limits)."""
    out = row.card()
    digest = _sha256(out)
    ref = row.plain()
    try:
        row.check(out, ref)
    except AssertionError as e:
        raise RuntimeError(f"{row.name}: the kernel's output misses its "
                           f"plain version's limit: {e}") from e
    same = total = 0
    for a, b in zip(tensors(out), tensors(ref), strict=True):
        same += int(((a == b) | (a.isnan() & b.isnan())).sum())
        total += a.numel()
    del out, ref
    st = {"ms": _device_ms(row.card, 20, row.kernel),
          "plain_ms": _events_ms(row.plain, 2),
          "bound_ms": 1e3 * row.n_bytes / HBM_BYTES_PER_S,
          "plain_equal": same / total, "sha256": digest}
    print(f"{row.name}: kernel {st['ms']:.3f} ms (device), plain "
          f"{st['plain_ms']:.3f} ms, bound {st['bound_ms']:.3f} ms "
          f"({100 * st['bound_ms'] / st['ms']:.1f} %, "
          f"{row.n_bytes / 1e6:.0f} MB), {100 * st['plain_equal']:.3f} % "
          f"of the values the plain version's  [{card}]", flush=True)
    return st


def kernel_table(dev, card) -> dict:
    """Phase 3: the table, ``{row name: time_row's stats}``."""
    table = {row.name: time_row(row, card) for row in kernel_rows(dev)}
    torch.cuda.empty_cache()
    return table


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


def inference(sra, dev, card):
    """Phase 4: three RoIAlign configurations of the inference path, one
    call each at batch 16 and at batch 1.  Returns each configuration's
    K1 launches by mode and its K2 launches."""
    from stereo_rcnn_tpu_torch import (Config, init_params,
                                       make_full_pipeline, synthetic_images)
    from stereo_rcnn_tpu_torch.models.resnet_fpn import STAGE_BLOCKS
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
              f"call, plain versions 0 calls  [{card}]", flush=True)
    del model, left, right, out
    torch.cuda.empty_cache()
    return launches


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


def training(sra, dev, card):
    """Phase 5: one training step per RoIAlign implementation, the fused
    one and the gather."""
    from stereo_rcnn_tpu_torch.config import synthetic_fullres_config
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
    from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                             make_train_step)
    from stereo_rcnn_tpu_torch.train.losses import LOSS_NAMES
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
    for impl in ("pallas", "xla"):
        cfg_i = dataclasses.replace(cfg, rcnn=dataclasses.replace(
            cfg.rcnn, roi_align_impl=impl))
        state.model.cfg = cfg_i
        step = make_train_step(cfg_i, device=dev)
        k1.reset_counts()
        k2.reset_counts()
        snap = {k: params[k].detach().clone() for k in watched}
        with _PlainCalls(sra) as plain:
            metrics = step(state, batch, tgen)
            torch.cuda.synchronize()
        vals = {k: float(metrics[k]) for k in (*LOSS_NAMES, "total",
                                               "grad_norm")}
        if not all(v == v and abs(v) < float("inf") for v in vals.values()):
            raise RuntimeError(f"training {impl}: non-finite {vals}")
        moved = {k: (params[k].detach() - snap[k]).abs().max().item()
                 for k in watched}
        if not all(v > 0 for v in moved.values()):
            raise RuntimeError(f"training {impl}: not updated {moved}")
        launched = {"K1": k1.launches, "K2": k2.launches}
        expect = int(impl == "pallas")
        if plain or launched != {"K1": expect, "K2": expect}:
            raise RuntimeError(f"training {impl}: launches {launched} "
                               f"(expected {expect} each), plain "
                               f"versions {plain}")
        out[impl] = {"launches": launched}
        print(f"training path, roi_align_impl={impl}: launches {launched}, "
              "plain versions 0 calls; "
              + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
              + f"; the head, trunk and stem updated  [{card}]", flush=True)
    return out


def bench_tool(sra):
    """Phase 6: the RoIAlign microbenchmark tool as a user runs it."""
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
    """Phase 7: the training and evaluation CLIs as a user runs them, at
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
    """Phase 9: norm calibration, export, serving, diagnosis and the demo
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


# The data-parallel phase's tolerance for several ranks against one process at the global
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
    """One rank of the data-parallel phase's training check (a spawned process):
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
    """One rank of the data-parallel phase's sharded inference: ``bench.py``'s program on
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
    """Phase 8: data parallelism over ``torch.distributed`` at full width,
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
    """Phase 10: the multi-class configuration (background / Car / Van) at
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
    """Phase 11: the stage-breakdown and roofline tools as a user runs
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
    """Phase 12: ``tools.capture_golden`` on a ``.pth`` in the upstream
    names written from a random ``Config()`` model."""
    import ast
    import os
    import shutil

    from stereo_rcnn_tpu_torch.config import Config
    from stereo_rcnn_tpu_torch.convert.stereo_import import \
        upstream_state_dict
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
    parser.add_argument("--digests", metavar="PATH",
                        help="write the sha256 of every kernel output of "
                             "the table to PATH (JSON)")
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

    # K3's, K5's and K6's launches by phase, from counts reset as each
    # phase starts (no phase resets them itself).
    counted = {"K3": win.roi_align_window_kernel,
               "K5": be.gauss_newton_solve_kernel,
               "K6": ce.conv_epilogue_kernel}
    by_phase = {k: {} for k in counted}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        for k in counted.values():
            k.reset_counts()
        res = fn(*args)
        for key, k in counted.items():
            by_phase[key][name] = k.launches
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

    table = phase("kernels", kernel_table, dev, card)
    if args.digests is not None:
        with open(args.digests, "w") as f:
            json.dump({name: st["sha256"] for name, st in table.items()}, f,
                      indent=1, sort_keys=True)
        print(f"{len(table)} output digests written to {args.digests}",
              flush=True)
    infer_launches = phase("inference", inference, sra, dev, card)
    train = phase("training", training, sra, dev, card)
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

    def alone(prefix):
        return {name: st for name, st in table.items()
                if name.startswith(prefix)}

    entries = []
    for hat in sra.TOOL_HAT_MODES:
        paths = k1_paths(hat)
        entries.append({
            "name": "stereo_roi_align_fwd", "mode": hat, "route": "cuda",
            "source": "stereo_rcnn_tpu_torch/csrc/stereo_roi_align.cu",
            "replaces": "stereo_rcnn_tpu/ops/roi_align_pallas.py:359",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "alone": alone(f"K1 {hat} "), "bound_by": "bytes",
            "library_ms": None})
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
        "alone": alone("K2 "), "bound_by": "bytes"})
    for key, name, source, replaces, bound_by in (
            ("K3", "roi_align_window", "roi_align_window.cu",
             "stereo_rcnn_tpu/ops/roi_align_pallas.py:47", "bytes"),
            ("K5", "gauss_newton_solve", "box_solve.cu",
             "no Pallas kernel: stereo_rcnn_tpu/solve/box_estimator.py::"
             "solve_batch is XLA-compiled jnp",
             "the serial chain of iterations"),
            ("K6", "conv_epilogue", "conv_epilogue.cu",
             "no Pallas kernel: XLA fuses the epilogue into the "
             "convolution on the TPU", "bytes")):
        paths = {p: n for p, n in by_phase[key].items() if n}
        entries.append({
            "name": name, "route": "cuda",
            "source": f"stereo_rcnn_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths, "alone": alone(f"{key} "),
            "bound_by": bound_by, "library_ms": None})
    entries.append({
        "name": "stereo_roi_align_atlas", "route": "cuda",
        "source": "stereo_rcnn_tpu_torch/csrc/stereo_roi_align_atlas.cu",
        "replaces": "stereo_rcnn_tpu/ops/roi_align_pallas.py:618",
        "launches": tool_k4, "launches_by_path": {"bench_roialign": tool_k4},
        "alone": alone("K4 "), "bound_by": "bytes", "library_ms": None})
    for key in ("K5", "K6"):
        if not by_phase[key]["inference"]:
            raise RuntimeError(f"{key} launches by phase {by_phase[key]}: "
                               "none in the inference phase")
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
