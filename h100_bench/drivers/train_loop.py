"""Back-to-back optimizer steps of the program's training path.

``stereo_rcnn_tpu_torch.train.make_train_step(cfg, steps_per_epoch)``
on a state made by ``init_train_state`` from the benchmark's weights, as
``tools/train.py`` drives it on one card: each step copies its ``batch``
pairs and their ground truth from pinned host memory to the card, and
draws its target-sampling uniforms from ``step_generator(seed, step)``.
Steps rotate through a pool of ``pool_pairs`` rendered pairs;
``steps_per_epoch`` is ``pool_pairs / batch``.  The window counts the
pairs of the steps it completed and ends on a sync.

Two steps are compared with the reference (``compare/train.py``): the
first, from the seeded state, and one after the window, from the state
the window left.  The program hands out the proposals of those steps
(``step_fn(..., evidence=...)``), and the reference repeats each step on
them with the same state, batch and uniforms.

Traffic keys: ``batch``, ``pool_pairs`` (a multiple of ``batch``),
``objects_per_pair``, ``warmup_steps``, ``trace_steps`` (each of the two
traced windows of a ``--trace 1`` run), ``reference_block`` (images per
reference block), ``calibrate_steps`` (the steps between the compared
steps of the program and of the control in ``calibrate``) and
``calibrate_gap_steps`` (the same for a planted fault).
"""

from __future__ import annotations

import gc
import inspect
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from h100_bench.harness import Cell, Outcome, host_delta, host_sample
from h100_bench.inputs import POOL, WEIGHTS, sub_seed, working_calib

#: Sub-seed tag of the target-sampling uniforms.
UNIFORMS = 3


def render_train_pool(cfg, pairs: int, objects: int, seed: int,
                      threads: int = 4):
    """``(left, right, gt)``: the pairs ``inputs.render_pool`` renders
    from ``seed`` and their packed ground truth (numpy leaves [N, G,
    ...])."""
    from h100_bench.reference.data.synthetic import (random_scene,
                                                     render_pair)
    from h100_bench.reference.train.ground_truth import (annotations,
                                                         pack_ground_truth)
    from h100_bench.reference.train.targets import GroundTruth
    calib = working_calib(cfg)
    h, w = cfg.data.image_h, cfg.data.image_w
    means = np.asarray(cfg.backbone.pixel_means_bgr, np.float32)
    classes = tuple(cfg.data.classes[1:])

    def one(i):
        rng = np.random.RandomState(sub_seed(seed, POOL, i) % (1 << 32))
        objs = random_scene(rng, objects, calib, h, w, classes)
        il, ir = render_pair(objs, calib, h, w, rng,
                             appearance=cfg.data.synthetic_appearance)
        gt = pack_ground_truth(annotations(objs, calib, float(w), cfg.data),
                               cfg.train.max_gt_boxes)
        return il - means, ir - means, gt

    with ThreadPoolExecutor(threads) as ex:
        done = list(ex.map(one, range(pairs)))
    return (np.stack([d[0] for d in done]), np.stack([d[1] for d in done]),
            GroundTruth(*[np.stack(f) for f in zip(*[d[2] for d in done])]))


def uniforms_of(cfg, seed: int, step: int, batch: int, device):
    """The uniforms ``step_generator(seed, step)`` draws for a step of
    ``batch`` images (the reference's copies of both)."""
    import torch
    from h100_bench.reference.geometry.anchors import anchors_per_level
    from h100_bench.reference.train.targets import draw_uniforms
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + step) % (1 << 63))
    a = sum(anchors_per_level(cfg.anchors, cfg.data.image_h,
                              cfg.data.image_w))
    return draw_uniforms(gen, batch, a, cfg.rpn.train_post_nms_top_n +
                         cfg.train.max_gt_boxes, torch.device(device))


def check_program() -> None:
    """Raise unless the program can hand out a step's proposals."""
    from stereo_rcnn_tpu_torch.train import step
    if "evidence" not in inspect.signature(step.compute_losses).parameters:
        raise SystemExit("this program's training step cannot hand out its "
                         "proposals (no evidence argument): the training "
                         "cell cannot be checked")


class Pool:
    """The rendered pool, pinned on the host (on a card) or not."""

    def __init__(self, left, right, gt, pin: bool):
        import torch
        self.left = torch.from_numpy(left)
        self.right = torch.from_numpy(right)
        self.gt = [torch.from_numpy(np.ascontiguousarray(x)) for x in gt]
        if pin:
            self.left = self.left.pin_memory()
            self.right = self.right.pin_memory()
            self.gt = [x.pin_memory() for x in self.gt]
        self.n = self.left.shape[0]

    def batch(self, step: int, batch: int, device):
        """The ``batch`` pairs of ``step`` on ``device``: ``(left,
        right, gt fields)``."""
        i = (step * batch) % self.n
        return (self.left[i:i + batch].to(device, non_blocking=True),
                self.right[i:i + batch].to(device, non_blocking=True),
                [x[i:i + batch].to(device, non_blocking=True)
                 for x in self.gt])


class Program:
    """The system under test: ``init_train_state`` from the benchmark's
    weights and ``make_train_step``."""

    def __init__(self, cell: Cell, state_dict, device, steps_per_epoch):
        from stereo_rcnn_tpu_torch.config import load_config
        from stereo_rcnn_tpu_torch.train import step as train_step
        from stereo_rcnn_tpu_torch.train import targets
        self.cfg = load_config(None, overrides=cell.config["config"])
        self.state = train_step.init_train_state(
            self.cfg, state_dict=state_dict, device=device)
        self.step_fn = train_step.make_train_step(self.cfg, steps_per_epoch,
                                                  device=device)
        self.device = device
        self._mod, self._targets = train_step, targets

    def generator(self, seed: int, step: int):
        return self._mod.step_generator(seed, step, self.device)

    def __call__(self, left, right, gt, generator=None, uniforms=None,
                 evidence=None) -> Dict:
        batch = self._mod.Batch(left, right, self._targets.GroundTruth(*gt))
        if uniforms is not None:
            uniforms = self._targets.Uniforms(*uniforms)
        return self.step_fn(self.state, batch, generator=generator,
                            uniforms=uniforms, evidence=evidence)

    def params(self) -> Dict:
        import torch
        with torch.no_grad():
            return {**{k: v.detach().clone() for k, v in
                       self.state.model.state_dict().items()},
                    "uncert": self.state.uncert.detach().clone()}

    def compared_step(self, left, right, gt, uniforms):
        """Run one step and record it whole (``compare.train.Record``)."""
        from h100_bench.compare.train import Record
        from h100_bench.reference.train.losses import LOSS_NAMES
        from h100_bench.reference.train.step import Batch
        from h100_bench.reference.train.targets import GroundTruth
        count = self.state.step
        before = self.params()
        trace = {k: v.detach().clone() for k, v in self.state.trace.items()}
        ev: Dict = {}
        metrics = self(left, right, gt, uniforms=uniforms, evidence=ev)
        named = {**dict(self.state.model.named_parameters()),
                 "uncert": self.state.uncert}
        grads = {k: p.grad.detach().clone() for k, p in named.items()
                 if p.grad is not None}
        return Record(
            count=count, params=before, trace=trace,
            batch=Batch(left, right, GroundTruth(*gt)), uniforms=uniforms,
            proposals={k: ev[k] for k in ("left", "right", "valid")},
            losses={k: metrics[k].detach().clone() for k in LOSS_NAMES},
            num_fg_rpn=ev["num_fg_rpn"], num_fg_rcnn=ev["num_fg_rcnn"],
            grads=grads, g_norm=metrics["grad_norm"].detach().clone(),
            after=self.params())


def setup(cell: Cell, seed: int, device):
    """``(cfg, pool, state_dict)``: the reference's config, the pool and
    the weights, all from ``seed``."""
    from h100_bench.reference.config import load_config
    from h100_bench.reference.train.weights import training_state_dict
    tr = cell.traffic
    cfg = load_config(None, overrides=cell.config["config"])
    left, right, gt = render_train_pool(cfg, tr["pool_pairs"],
                                        tr["objects_per_pair"], seed)
    sd = training_state_dict(cfg, sub_seed(seed, WEIGHTS), device)
    return cfg, (left, right, gt), sd


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device=None) -> Outcome:
    import torch
    from h100_bench.compare.train import check
    check_program()
    tr = cell.traffic
    batch, pool_n = tr["batch"], tr["pool_pairs"]
    if pool_n % batch:
        raise ValueError("pool_pairs must be a multiple of batch")
    spe = pool_n // batch
    on_card = device is None
    dev = torch.device("cuda", 0) if on_card else torch.device(device)
    split = {"start": time.time() - t_start}
    cfg, (left, right, gt), sd = setup(cell, seed, dev)
    split["inputs"] = time.time() - t_start
    program = Program(cell, sd, dev, spe)
    del sd
    pool = Pool(left, right, gt, pin=on_card)
    del left, right, gt
    split["program"] = time.time() - t_start
    useed = sub_seed(seed, UNIFORMS)

    # The first compared step, from the seeded state.
    records = [program.compared_step(
        *pool.batch(0, batch, dev),
        uniforms_of(cfg, useed, 0, batch, dev))]
    step_metrics: List[Dict] = []

    def step(k: int, keep: Optional[list] = None):
        ev: Dict = {} if keep is not None else None
        m = program(*pool.batch(k, batch, dev),
                    generator=program.generator(useed, k), evidence=ev)
        if keep is not None:
            keep.append((m, ev["valid"]))

    k = 1
    for _ in range(tr["warmup_steps"]):
        step(k)
        k += 1
    _sync(dev)
    split["warmup"] = time.time() - t_start
    k2 = _k2_counter(on_card)
    k2_before = k2.launches if k2 is not None else 0

    gc.collect()
    gc.disable()
    t_first = time.time()
    setup_s = t_first - t_start
    host0 = host_sample()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    steps = 0
    while time.perf_counter() < deadline:
        step(k, step_metrics)
        k += 1
        steps += 1
    _sync(dev)
    window = time.perf_counter() - t0
    host = host_delta(host0, host_sample(), steps)
    gc.enable()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if k2 is not None and k2.launches - k2_before < steps:
        raise RuntimeError(f"K2 ran {k2.launches - k2_before} times over "
                           f"{steps} steps: the cell's backward did not run")

    layer = {"pairs_per_step": batch,
             "pairs_per_s": steps * batch / window,
             "call_s": window / steps, "cfg": program.cfg,
             "peaks": _peaks()}
    traced = None
    if trace and on_card:
        t_trace = time.perf_counter()
        from h100_bench.stages import by_span, profiled
        from h100_bench.trace import traced as run_traced
        n = tr["trace_steps"]
        traced = run_traced(lambda i: step(k + i), n)
        layer["trace"] = traced
        k += n
        layer["by_span"] = by_span(profiled(lambda i: step(k + i), n))
        k += n
        split["trace_s"] = time.perf_counter() - t_trace

    # The second compared step, from the state the window left.
    records.append(program.compared_step(
        *pool.batch(k, batch, dev),
        uniforms_of(cfg, useed, k, batch, dev)))
    t_check = time.perf_counter()
    del program
    if on_card:
        torch.cuda.empty_cache()
    flops: list = []
    stats = check(cfg, records, spe, tr["reference_block"],
                  flops=flops if trace else None)
    if flops:
        layer["flops_per_pair"] = flops[0] / tr["reference_block"]
    stats.update(_window_stats(step_metrics))
    if "by_span" in layer:
        stats["device_by_span"] = layer["by_span"]
    stats["check_s"] = time.perf_counter() - t_check
    stats["setup_split_s"] = split
    stats["host"] = host
    layer["stats"] = stats
    checks = {n: {"value": stats[n], "limit": lim}
              for n, lim in cell.limits["limits"].items()}
    return Outcome(e2e={"setup_s": setup_s,
                        "pairs_per_s": steps * batch / window},
                   layer=layer, attempted=steps, failed=0, checks=checks,
                   memory_peak_bytes=int(peak), device_count=1,
                   trace=traced)


def _window_stats(step_metrics) -> Dict:
    """Per step of the window: the foreground counts and the valid
    proposals (means per image), the gradient norm, and the steps whose
    losses or gradient norm are not finite."""
    import torch
    from h100_bench.reference.train.losses import LOSS_NAMES
    if not step_metrics:
        return {"nonfinite_steps": 0.0}
    names = LOSS_NAMES + ("grad_norm", "num_fg_rpn", "num_fg_rcnn")
    rows = torch.stack([torch.stack([m[n].float().reshape(()) for n in names]
                                    + [v.float().sum(-1).mean()])
                        for m, v in step_metrics]).cpu().numpy()
    finite = np.isfinite(rows[:, :7]).all(axis=1)
    return {"nonfinite_steps": float((~finite).sum()),
            "num_fg_rpn": rows[:, 7].tolist(),
            "num_fg_rcnn": rows[:, 8].tolist(),
            "valid_proposals": rows[:, 9].tolist(),
            "grad_norm": [float(rows[0, 6]), float(rows[-1, 6])],
            "losses_last": dict(zip(names[:6], rows[-1, :6].tolist()))}


def _k2_counter(on_card: bool):
    if not on_card:
        return None
    from stereo_rcnn_tpu_torch.ops.stereo_roi_align import (
        stereo_roi_align_bwd_kernel)
    return stereo_roi_align_bwd_kernel


def _peaks() -> dict:
    import json
    import os
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "peaks.json")) as f:
        return json.load(f)


def _reference_run(cell: Cell, cfg, pool: Pool, sd, useed: int, spe: int,
                   gap: int, dev, lowered: bool, fault: Optional[str]):
    """Records of the reference put in the program's place (the control,
    or a fault planted): its first step from the seeded state, ``gap``
    steps, and one more, each selecting its own proposals."""
    import torch
    from h100_bench.compare.train import Record
    from h100_bench.reference.train.step import (STEP_FAULTS, Batch,
                                                 reference_step)
    from h100_bench.reference.train.targets import GroundTruth
    tr = cell.traffic
    batch = tr["batch"]
    params = {**sd, "uncert": torch.zeros(6, device=dev)}
    trace: Dict = {}
    records = []
    for k in range(gap + 2):
        left, right, gt = pool.batch(k, batch, dev)
        if fault == "fault_previous_images":
            left, right, _ = pool.batch(k - 1 + pool.n // batch, batch, dev)
        uniforms = uniforms_of(cfg, useed, k, batch, dev)
        if not all(bool(torch.isfinite(v).all()) for v in params.values()):
            # Its weights went to inf: no box can be sampled any more, and
            # the check reads the step as inf.
            nan = torch.full((batch, 1, 4), float("nan"), device=dev)
            records.append(records[-1]._replace(
                count=k, proposals={"left": nan, "right": nan}))
            break
        b = Batch(left, right, GroundTruth(*gt))
        res = reference_step(cfg, params, trace, k, b, uniforms, spe,
                             block=tr["reference_block"], lowered=lowered,
                             fault=fault if fault in STEP_FAULTS else None)
        if k in (0, gap + 1):
            # The check repeats the step on the program's own images.
            left, right, gt = pool.batch(k, batch, dev)
            records.append(Record(
                count=k, params=params, trace=trace,
                batch=Batch(left, right, GroundTruth(*gt)),
                uniforms=uniforms, proposals=res.proposals,
                losses=res.losses, num_fg_rpn=res.num_fg_rpn,
                num_fg_rcnn=res.num_fg_rcnn, grads=res.grads,
                g_norm=res.g_norm, after=res.params))
        params, trace = res.params, res.trace
    return records


def calibrate(cell: Cell, seeds, control_seeds, faults: bool = False,
              device=None):
    """Readings of the correctness numbers (see ``calibrate.py``): for each
    seed, the program's first step, ``calibrate_steps`` steps and one
    more, compared; for each control seed, the reference one precision
    step down in the program's place.  With ``faults``, also the
    reference with each fault of ``compare.train.FAULTS`` planted."""
    import torch
    from h100_bench.compare.train import FAULTS, check
    tr = cell.traffic
    batch, spe = tr["batch"], tr["pool_pairs"] // tr["batch"]
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = dev.type == "cuda"
    if seeds:
        check_program()
    runs = [(s, "program") for s in seeds] + [(s, "control")
                                              for s in control_seeds]
    if faults:
        runs += [(s, f) for s in control_seeds for f in FAULTS]
    for seed, kind in runs:
        t0 = time.perf_counter()
        cfg, (left, right, gt), sd = setup(cell, seed, dev)
        pool = Pool(left, right, gt, pin=on_card)
        useed = sub_seed(seed, UNIFORMS)
        nonfinite = 0
        if kind == "program":
            program = Program(cell, sd, dev, spe)
            records = [program.compared_step(
                *pool.batch(0, batch, dev),
                uniforms_of(cfg, useed, 0, batch, dev))]
            for k in range(1, tr["calibrate_steps"] + 1):
                m = program(*pool.batch(k, batch, dev),
                            generator=program.generator(useed, k))
                nonfinite += not all(math.isfinite(float(v))
                                     for v in m.values())
            k = tr["calibrate_steps"] + 1
            records.append(program.compared_step(
                *pool.batch(k, batch, dev),
                uniforms_of(cfg, useed, k, batch, dev)))
            del program
        else:
            # The control takes the program's schedule; a fault needs
            # only a step between its compared steps.
            gap = tr["calibrate_steps" if kind == "control" else
                     "calibrate_gap_steps"]
            records = _reference_run(
                cell, cfg, pool, sd, useed, spe, gap,
                dev, lowered=kind == "control",
                fault=None if kind == "control" else kind)
        t_prog = time.perf_counter() - t0
        del sd
        if on_card:
            torch.cuda.empty_cache()
        stats = check(cfg, records, spe, tr["reference_block"])
        stats["nonfinite_steps"] = float(nonfinite)
        del records
        if on_card:
            torch.cuda.empty_cache()
        yield {"seed": seed, "kind": kind, "stats": stats,
               "seconds": time.perf_counter() - t0, "program_s": t_prog}
