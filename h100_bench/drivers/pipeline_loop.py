"""Closed-loop clients of the end-to-end inference pipeline.

``stereo_rcnn_tpu_torch.inference.make_full_pipeline(cfg, calib)(model,
left, right)``: one caller sends a batch of ``batch`` pairs, waits for its
3D boxes on the host, and sends the next.  Frames rotate through a pool of
``pool_pairs`` rendered pairs.  A call's latency runs from the pair on
the host (pinned memory) to its detections on the host.

Traffic keys: ``batch``, ``pool_pairs`` (a multiple of ``batch``),
``objects_per_pair``, ``warmup_calls``, ``trace_calls`` (the traced
window of a ``--trace 1`` run) and ``reference_block`` (pairs per
reference call).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from h100_bench.harness import Cell, Outcome, host_delta, host_sample
from h100_bench.inputs import make_weights, render_pool


class Program:
    """The system under test, built from the benchmark's weights."""

    def __init__(self, cell: Cell, state_dict, calib, device):
        import torch
        from stereo_rcnn_tpu_torch.config import load_config
        from stereo_rcnn_tpu_torch.inference import make_full_pipeline
        from stereo_rcnn_tpu_torch.models.detector import build_model
        self.cfg = load_config(None, overrides=cell.config["config"])
        with torch.device("meta"):
            model = build_model(self.cfg)
        model.load_state_dict(state_dict, strict=True, assign=True)
        self.model = model.eval()
        self.pipe = make_full_pipeline(self.cfg, calib)

    def __call__(self, left, right):
        return self.pipe(self.model, left, right)


def frames(call: int, batch: int, pool: int) -> List[int]:
    start = (call * batch) % pool
    return list(range(start, start + batch))


def setup(cell: Cell, seed: int, device):
    """``(cfg, state_dict, pool, class_head, balance_s)``: the
    reference's config, the weights, the pool and the class head's
    balance, all from ``seed``, and the seconds of the balance."""
    from h100_bench.reference.config import load_config
    tr = cell.traffic
    cfg = load_config(None, overrides=cell.config["config"])
    pool = render_pool(cfg, tr["pool_pairs"], tr["objects_per_pair"], seed)
    return (cfg, pool) + make_weights(cfg, seed, device, pool)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device=None, program_factory=Program) -> Outcome:
    import torch
    from h100_bench.compare.pipeline import FIELDS, answer_fields, check
    tr = cell.traffic
    batch, pool_n = tr["batch"], tr["pool_pairs"]
    if pool_n % batch:
        raise ValueError("pool_pairs must be a multiple of batch")
    on_card = device is None
    dev = torch.device("cuda", 0) if on_card else torch.device(device)
    split = {"start": time.time() - t_start}
    cfg, pool, sd, head, balance_s = setup(cell, seed, dev)
    split["inputs"] = time.time() - t_start
    split["balance"] = balance_s
    program = program_factory(cell, sd, tuple(pool.calib), dev)
    del sd
    split["program"] = time.time() - t_start
    pin = on_card
    left_h = torch.from_numpy(pool.left)
    right_h = torch.from_numpy(pool.right)
    if pin:
        left_h, right_h = left_h.pin_memory(), right_h.pin_memory()

    def sync():
        if on_card:
            torch.cuda.current_stream(dev).synchronize()

    def call(k: int) -> Dict[str, np.ndarray]:
        i = frames(k, batch, pool_n)[0]
        left = left_h[i:i + batch].to(dev, non_blocking=True)
        right = right_h[i:i + batch].to(dev, non_blocking=True)
        out = answer_fields(program(left, right))
        host = [t.to("cpu", non_blocking=True) for t in out]
        sync()
        return {f: t.numpy() for f, t in zip(FIELDS, host)}

    for k in range(tr["warmup_calls"]):
        call(k)
    split["warmup"] = time.time() - t_start
    k1 = _k1_counter(on_card)
    k1_before = k1.launches_by_hat.copy() if k1 else None

    # The measured window, the garbage collector held off: its pauses
    # fall at random into a host-bound loop.  Set-up leaves out the
    # reference's balance of the class head.
    gc.collect()
    gc.disable()
    t_first = time.time()
    setup_s = t_first - t_start - balance_s
    host0 = host_sample()
    answers, lat = {}, []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = 0
    while time.perf_counter() < deadline:
        a = time.perf_counter()
        answers[k] = call(k)
        lat.append(time.perf_counter() - a)
        k += 1
    window = time.perf_counter() - t0
    host = host_delta(host0, host_sample(), k)
    gc.enable()
    calls = k
    peak = (torch.cuda.max_memory_allocated(dev) if on_card else 0)
    hat = program.cfg.rcnn.roi_align_hat
    if k1 is not None and program.cfg.rcnn.roi_align_impl == "pallas":
        ran = k1.launches_by_hat[hat] - k1_before[hat]
        if ran < calls:
            raise RuntimeError(f"K1 ran {ran} times in {hat!r} mode over "
                               f"{calls} calls: the cell's mode did not run")

    layer = {"pairs_per_call": batch, "pairs_per_s": calls * batch / window,
             "call_s": window / calls, "cfg": program.cfg,
             "peaks": _peaks()}
    traced = None
    if trace and on_card:
        from h100_bench.trace import traced as run_traced
        traced = run_traced(lambda i: call(calls + i), tr["trace_calls"])
        layer["trace"] = traced

    # The check, once the program is freed.
    t_check = time.perf_counter()
    del program
    if on_card:
        torch.cuda.empty_cache()
    flops: list = []
    frames_of = {c: frames(c, batch, pool_n) for c in answers}
    stats = check(cfg, make_weights(cfg, seed, dev, pool, head)[0], answers,
                  frames_of, pool.left, pool.right, tuple(pool.calib), dev,
                  tr["reference_block"], flops=flops if trace else None)
    if flops:
        layer["flops_per_pair"] = flops[0] / min(tr["reference_block"],
                                                 pool_n)
    stats["check_s"] = time.perf_counter() - t_check
    stats["setup_split_s"] = split
    # Beside the metrics: the latency's median, mean and quarters (the
    # window's first and last), which show how the host's speed moved.
    lat_ms = np.asarray(lat) * 1e3
    quarter = max(len(lat) // 4, 1)
    host["latency_ms_p50_mean_first_last_quarter"] = [
        float(np.percentile(lat_ms, 50)), float(np.mean(lat_ms)),
        float(np.mean(lat_ms[:quarter])), float(np.mean(lat_ms[-quarter:]))]
    stats["host"] = host
    layer["stats"] = stats
    checks = {n: {"value": stats[n], "limit": lim}
              for n, lim in cell.limits["limits"].items()}
    e2e = {"setup_s": setup_s,
           "pairs_per_s": calls * batch / window,
           "latency_p90_ms": float(np.percentile(lat_ms, 90))}
    return Outcome(e2e=e2e, layer=layer, attempted=calls, failed=0,
                   checks=checks, memory_peak_bytes=int(peak),
                   device_count=1, trace=traced)


def _k1_counter(on_card: bool):
    if not on_card:
        return None
    from stereo_rcnn_tpu_torch.ops.stereo_roi_align import (
        stereo_roi_align_kernel)
    return stereo_roi_align_kernel


def _peaks() -> dict:
    import json
    import os
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "peaks.json")) as f:
        return json.load(f)


#: Faults planted in the reference's answers put in the program's place
#: (``calibrate``): each answer's depth 10 % off; the first half of each
#: batch answered with nothing; each image answered with its first
#: detection alone; the batch's first slot answered with the second
#: slot's answer; each perspective keypoint one bin to the right.
FAULTS = ("fault_depth", "fault_half_batch", "fault_one_detection",
          "fault_slot_swap", "fault_keypoint_bin")


def plant(kind: str, answer: Dict[str, np.ndarray],
          evidence: Dict[str, np.ndarray]) -> None:
    """Plant the fault ``kind`` of :data:`FAULTS` in one call's
    ``answer`` (fields [batch, ...]); ``evidence``: the reference's
    ``kpt_logits`` and ``rois`` for the call's frames."""
    batch = answer["valid"].shape[0]
    if kind == "fault_depth":
        answer["position"][..., 2] *= 1.1
        answer["z_refined"] *= 1.1
    elif kind == "fault_half_batch":
        answer["valid"][: max(batch // 2, 1)] = False
    elif kind == "fault_one_detection":
        keep = np.cumsum(answer["valid"], axis=1) == 1
        answer["valid"] &= keep
    elif kind == "fault_slot_swap" and batch > 1:
        for f in answer:
            answer[f][0] = answer[f][1]
    elif kind == "fault_keypoint_bin":
        rois = evidence["rois"]
        answer["kpt_u"] += ((rois[..., 2] - rois[..., 0]) /
                            evidence["kpt_logits"].shape[-1])


def calibrate(cell: Cell, seeds, control_seeds, faults: bool = False,
              device=None, program_factory=Program):
    """Readings of the correctness numbers (see ``calibrate.py``): for each
    seed, the program over every frame of the pool once; for each control
    seed, the reference one precision step down.  With ``faults``, also
    the reference with each fault of :data:`FAULTS` planted in its
    answers (the slot swap only where a batch has two slots)."""
    import torch
    from h100_bench.compare.pipeline import (EVIDENCE, FIELDS,
                                             answer_fields, check,
                                             reference_answers)
    tr = cell.traffic
    batch, pool_n = tr["batch"], tr["pool_pairs"]
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    runs = [(s, "program") for s in seeds] + [(s, "control")
                                              for s in control_seeds]
    if faults:
        runs += [(s, f) for s in control_seeds for f in FAULTS
                 if batch > 1 or f != "fault_slot_swap"]
    for seed, kind in runs:
        t0 = time.perf_counter()
        cfg, pool, sd, head, _ = setup(cell, seed, dev)
        answers = {}
        if kind == "program":
            program = program_factory(cell, sd, tuple(pool.calib), dev)
            with torch.no_grad():
                for k in range(pool_n // batch):
                    i = k * batch
                    out = program(torch.from_numpy(pool.left[i:i + batch]
                                                   ).to(dev),
                                  torch.from_numpy(pool.right[i:i + batch]
                                                   ).to(dev))
                    answers[k] = {f: t.cpu().numpy() for f, t in
                                  zip(FIELDS, answer_fields(out))}
            del program
        else:
            low = reference_answers(cfg, sd, pool.left, pool.right,
                                    tuple(pool.calib), dev,
                                    tr["reference_block"],
                                    lowered=kind == "control")
            for k in range(pool_n // batch):
                i = k * batch
                answers[k] = {f: low[f][i:i + batch].copy() for f in FIELDS}
                plant(kind, answers[k],
                      {f: low[f][i:i + batch] for f in EVIDENCE})
        del sd
        t_prog = time.perf_counter() - t0
        stats = check(cfg, make_weights(cfg, seed, dev, pool, head)[0],
                      answers, {c: frames(c, batch, pool_n) for c in answers},
                      pool.left, pool.right, tuple(pool.calib), dev,
                      tr["reference_block"])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield {"seed": seed, "kind": kind, "stats": stats,
               "seconds": time.perf_counter() - t0, "program_s": t_prog}
