"""Data-parallel training over the cell's cards, as ``tools.train`` runs
the recipe over every visible card.

One rank per card (``parallel.launch.spawn``), each in an NCCL group with
a gloo group beside it for the host (``parallel.make_mesh``).  Every rank
makes the state with ``init_train_state`` from the benchmark's weights
(``train_loop``'s seed), broadcasts it from rank 0 (``replicate``) and
steps ``data_parallel_train_step(make_train_step(cfg, steps_per_epoch))``
on its rows of each global batch (``shard_batch``), with the global
batch's uniforms from ``step_generator(seed, step)``; the gradients are
averaged over the ranks before the clip.  After each step the ranks agree
whether rank 0's window is over (``Mesh.any_rank``, the per-step flag
``tools.train`` checks for a SIGTERM).  The window starts and ends on a
sync and a barrier on every rank; rank 0 measures it.

The pool: global pair ``i`` is ``train_loop.render_train_pool``'s pair
drawn from ``sub_seed(seed, PAIRS, i)``; global step ``k`` takes pairs
``k * B ..`` (B = ``batch`` x ranks, modulo ``pool_pairs``), and each rank
renders and pins only the rows of its own shard.

Two steps are compared with the float32 reference at the global batch
(``compare/train.py``): the first, from the seeded state, and one after
the window.  Rank 0 gathers every rank's images, ground truth, proposals
and foreground counts (``parallel.mesh.gather_batch``); the losses are
the global means, and the gradients and weights, averaged and the same
on every rank, are its own.  The reference repeats that step on rank 0's
card in blocks of ``reference_block``.  Besides, ``sample_mismatch``
counts the images whose sampled anchors or RoIs differ from the
reference's target sampling of the same step (:func:`sample_mismatch`),
and ``replica_mismatch`` the ranks whose weights and momentum differ from
rank 0's, bit for bit, at the end.

Traffic keys: ``train_loop``'s (``batch`` per rank) and ``ranks``;
``pool_pairs`` is a multiple of ``batch`` x ``ranks``.

``run(..., device=None)`` puts each rank on its own card; ``device="cpu"``
runs gloo ranks on the CPU and ``"cuda:0"`` gloo ranks sharing that card
(NCCL takes one rank per card), for tests and for faults on one card.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import hashlib
import inspect
import math
import os
import pickle
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from h100_bench.drivers.train_loop import (UNIFORMS, Pool, Program,
                                           _k2_counter, _peaks,
                                           _reference_run, _sync,
                                           _window_stats, check_program,
                                           render_train_pool, uniforms_of)
from h100_bench.harness import (Cell, Outcome, forbidden_modules,
                                host_delta, host_sample)
from h100_bench.inputs import WEIGHTS, sub_seed

#: Sub-seed tag of the pool's pairs.
PAIRS = 4
#: How long a collective may wait for a rank (the groups' timeout).
COLLECTIVE_TIMEOUT_S = 300.0
#: The span holding the gradient all-reduce's collectives.
COLLECTIVE = "train/all_reduce/collective"
#: Faults planted in the data-parallel step (``calibrate``): the last rank
#: keeps its own gradient (it joins the all-reduce, so no rank hangs, and
#: drops the result); every rank trains on rank 0's rows; the sum of the
#: gradients in place of their mean; uniforms from a rank-local generator.
DP_FAULTS = ("dp_rank_skips_all_reduce", "dp_rank0_rows", "dp_sum_no_mean",
             "dp_local_uniforms")


#: What the step's ``evidence`` says its target sampling chose.
SAMPLED = ("anchor_weights", "rois_left", "roi_weights")


def check_sampling_evidence() -> None:
    """Raise unless the program's step hands out what its target sampling
    chose (``compute_losses``' evidence :data:`SAMPLED`), which
    ``sample_mismatch`` compares."""
    from stereo_rcnn_tpu_torch.train import step
    check_program()
    if not all(k in inspect.getsource(step.compute_losses)
               for k in SAMPLED):
        raise SystemExit("this program's training step does not hand out "
                         "the anchors and RoIs it sampled: the "
                         "data-parallel cell cannot be checked")


def sample_mismatch(cfg, rec, chosen: Dict) -> float:
    """Images of the record's global batch whose sampled anchors or RoIs
    (``chosen``, the program's, gathered in rank order) differ from the
    reference's target sampling of the same images, ground truth,
    proposals and global uniforms.  Sampling is exact, so a sound step
    reads 0; a rank that samples from draws other than its rows of the
    global batch's does not."""
    import torch
    from h100_bench.reference.geometry.anchors import generate_anchors
    from h100_bench.reference.train.targets import (anchor_targets,
                                                    proposal_targets)
    left, gt, u, p = rec.batch.left, rec.batch.gt, rec.uniforms, \
        rec.proposals
    _, h, w, _ = left.shape
    with torch.no_grad():
        anchors = generate_anchors(cfg.anchors, h, w, cfg.box_off,
                                   left.device)
        at = anchor_targets(anchors, gt, cfg.rpn, h, w, u.anchor_fg,
                            u.anchor_bg, cfg.box_off)
        rt = proposal_targets(p["left"], p["right"], p["valid"], gt,
                              cfg.rcnn, u.roi_fg, u.roi_bg, u.roi_take,
                              cfg.box_off)
    differ = ((at.weights != chosen["anchor_weights"]).any(-1) |
              (rt.weights != chosen["roi_weights"]).any(-1) |
              (rt.rois_left != chosen["rois_left"]).flatten(1).any(-1))
    return float(differ.sum())


def render_pairs(cfg, indices, objects: int, seed: int, threads: int = 4):
    """``(left, right, gt)`` of the pool's pairs ``indices``, in order
    (numpy leaves [N, ...])."""
    def one(i):
        return render_train_pool(cfg, 1, objects, sub_seed(seed, PAIRS, i),
                                 threads=1)

    with ThreadPoolExecutor(threads) as ex:
        parts = list(ex.map(one, [int(i) for i in indices]))
    gt = type(parts[0][2])(*[np.concatenate(f) for f in
                             zip(*[p[2] for p in parts])])
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]), gt)


def shard_rows(mesh, global_batch: int, pool_pairs: int) -> np.ndarray:
    """This rank's pairs of each global batch of an epoch, in step order
    (``shard_batch`` of each global batch's pair indices)."""
    from stereo_rcnn_tpu_torch.parallel import shard_batch
    spe = pool_pairs // global_batch
    return np.concatenate([shard_batch(mesh, np.arange(
        k * global_batch, (k + 1) * global_batch)) for k in range(spe)])


class DataParallel:
    """``Program.step_fn``'s stand-in: ``data_parallel_train_step`` of the
    program's own step, with the step's ``evidence`` handed through, and
    one of :data:`DP_FAULTS` planted where asked."""

    def __init__(self, step_fn, mesh, fault: Optional[str] = None):
        from stereo_rcnn_tpu_torch.parallel import data_parallel_train_step
        self.mesh, self.fault = mesh, fault
        self.evidence = self.last_evidence = None

        def inner(state, batch, generator=None, uniforms=None, **kw):
            batch, generator, uniforms, kw = self._plant(
                state, batch, generator, uniforms, kw)
            return step_fn(state, batch, generator, uniforms,
                           evidence=self.evidence, **kw)

        self._step = data_parallel_train_step(inner, mesh)

    def __call__(self, state, batch, generator=None, uniforms=None,
                 evidence=None):
        self.evidence = self.last_evidence = evidence
        try:
            return self._step(state, batch, generator, uniforms)
        finally:
            self.evidence = None

    def _plant(self, state, batch, generator, uniforms, kw):
        import torch
        from stereo_rcnn_tpu_torch.parallel import replicate
        mesh, fault = self.mesh, self.fault
        reduce = kw["reduce_grads"]
        if fault == "dp_rank0_rows":
            batch = type(batch)(batch.images_left.clone(),
                                batch.images_right.clone(),
                                type(batch.gt)(*[x.clone()
                                                 for x in batch.gt]))
            replicate(mesh, batch)
        elif fault == "dp_local_uniforms":
            seed = 1_000_003 * (mesh.rank + 1) + state.step
            if uniforms is not None:
                gen = torch.Generator(device=uniforms[0].device)
                gen.manual_seed(seed)
                uniforms = type(uniforms)(*[
                    torch.rand(u.shape, generator=gen, device=u.device)
                    for u in uniforms])
            else:
                generator = torch.Generator(device=generator.device)
                generator.manual_seed(seed)
        elif fault == "dp_sum_no_mean":
            def summed(params):
                reduce(params)
                for p in params.values():
                    if p.grad is not None:
                        p.grad.mul_(mesh.data_size)
            kw = {**kw, "reduce_grads": summed}
        elif (fault == "dp_rank_skips_all_reduce"
              and mesh.rank == mesh.world_size - 1):
            def skipped(params):
                own = {n: p.grad.clone() for n, p in params.items()
                       if p.grad is not None}
                reduce(params)
                for n, g in own.items():
                    params[n].grad.copy_(g)
            kw = {**kw, "reduce_grads": skipped}
        return batch, generator, uniforms, kw


def _mesh(n: int, device):
    """This rank's mesh: NCCL, one card a rank (``device`` None), or gloo
    ranks on the CPU or sharing one card."""
    from stereo_rcnn_tpu_torch.parallel import make_mesh
    kw = {}
    if "timeout" in inspect.signature(make_mesh).parameters:
        kw["timeout"] = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    backend = None if device is None else "gloo"
    return make_mesh(n, device=device, backend=backend, **kw)


def _counts():
    """``parallel.mesh.counts()``, or None for a program without it."""
    from stereo_rcnn_tpu_torch.parallel import mesh as mesh_mod
    fn = getattr(mesh_mod, "counts", None)
    return None if fn is None else {k: tuple(v) for k, v in fn().items()}


def _build_kernels(mesh) -> None:
    """One build of the step's kernels per host before any rank launches
    them (as ``tools.train`` does)."""
    if mesh.device.type == "cuda" and mesh.local_rank == 0:
        from stereo_rcnn_tpu_torch.ops.cuda_build import load_kernels
        from stereo_rcnn_tpu_torch.ops.stereo_roi_align import (
            stereo_roi_align_bwd_kernel, stereo_roi_align_kernel)
        load_kernels([stereo_roi_align_kernel, stereo_roi_align_bwd_kernel])
    mesh.barrier()


class Rank:
    """One rank's program on one seed: its shard of the pool, the state
    from the seed's weights broadcast from rank 0, and the data-parallel
    step."""

    def __init__(self, cell: Cell, mesh, seed: int,
                 fault: Optional[str] = None):
        from h100_bench.reference.config import load_config
        from h100_bench.reference.train.weights import training_state_dict
        from stereo_rcnn_tpu_torch.parallel import replicate
        tr = cell.traffic
        self.mesh, self.dev = mesh, mesh.device
        self.batch = tr["batch"]
        self.global_batch = tr["batch"] * mesh.data_size
        if tr["pool_pairs"] % self.global_batch:
            raise ValueError("pool_pairs must be a multiple of batch x "
                             "ranks")
        self.spe = tr["pool_pairs"] // self.global_batch
        self.cfg = load_config(None, overrides=cell.config["config"])
        left, right, gt = render_pairs(
            self.cfg, shard_rows(mesh, self.global_batch, tr["pool_pairs"]),
            tr["objects_per_pair"], seed)
        self.pool = Pool(left, right, gt, pin=self.dev.type == "cuda")
        del left, right, gt
        sd = training_state_dict(self.cfg, sub_seed(seed, WEIGHTS), self.dev)
        self.program = Program(cell, sd, self.dev, self.spe)
        del sd
        st = self.program.state
        replicate(mesh, [st.model, st.uncert, st.trace])
        self.program.step_fn = DataParallel(self.program.step_fn, mesh,
                                            fault)
        self.useed = sub_seed(seed, UNIFORMS)

    def step(self, k: int, keep: Optional[list] = None) -> None:
        ev: Optional[Dict] = {} if keep is not None else None
        m = self.program(*self.pool.batch(k, self.batch, self.dev),
                         generator=self.program.generator(self.useed, k),
                         evidence=ev)
        if keep is not None:
            keep.append((m, ev["valid"]))

    def compared_step(self, k: int):
        """Step ``k`` recorded whole; on rank 0 the record of the global
        batch (every rank's rows, proposals and counts) and its
        :func:`sample_mismatch`, else None."""
        from h100_bench.reference.train.step import Batch
        from h100_bench.reference.train.targets import GroundTruth
        from stereo_rcnn_tpu_torch.parallel.mesh import gather_batch
        rec = self.program.compared_step(
            *self.pool.batch(k, self.batch, self.dev),
            uniforms_of(self.cfg, self.useed, k, self.global_batch,
                        self.dev))
        ev = self.program.step_fn.last_evidence
        left, right, gt, props, n_rpn, n_rcnn, chosen = gather_batch(
            self.mesh, (rec.batch.left, rec.batch.right, tuple(rec.batch.gt),
                        rec.proposals, rec.num_fg_rpn, rec.num_fg_rcnn,
                        {k_: ev[k_] for k_ in SAMPLED}))
        if self.mesh.rank != 0:
            return None
        rec = rec._replace(batch=Batch(left, right, GroundTruth(*gt)),
                           proposals=props, num_fg_rpn=n_rpn,
                           num_fg_rcnn=n_rcnn)
        return rec, sample_mismatch(self.cfg, rec, chosen)

    def replica_mismatch(self) -> float:
        """Ranks whose weights and momentum differ from rank 0's, bit for
        bit (sha256 over the host group)."""
        import torch
        import torch.distributed as dist
        st = self.program.state
        digest = hashlib.sha256()
        leaves = {**st.model.state_dict(), "uncert": st.uncert}
        for group in (leaves, st.trace):
            for name in sorted(group):
                t = group[name].detach().contiguous().reshape(-1)
                digest.update(name.encode())
                digest.update(t.view(torch.uint8).cpu().numpy().tobytes())
        every: List[str] = [""] * self.mesh.world_size
        dist.all_gather_object(every, digest.hexdigest(),
                               group=self.mesh.host_group)
        return float(sum(d != every[0] for d in every))


def _span_kernel_s(win, name: str) -> List[float]:
    """Per instance of the span ``name`` in a ``stages.profiled`` window,
    in order: the device seconds of the kernels launched inside it."""
    out = []
    for s, e, n in sorted(win.ranges):
        if n != name:
            continue
        out.append(1e-6 * sum(
            ke - ks for ks, ke, corr in win.kernels
            if s <= win.launches.get(corr, -math.inf) <= e))
    return out


def _aligned(mesh, window, fn, n):
    """``window(fn, n)`` (a profiled window) started on every rank at
    once, with no garbage collection inside it: a rank that collects
    the previous window's millions of events mid-window holds up every
    other rank's all-reduce by seconds."""
    gc.collect()
    mesh.barrier()
    gc.disable()
    try:
        return window(fn, n)
    finally:
        gc.enable()


def _gather_host(mesh, obj) -> Optional[list]:
    """Every rank's ``obj`` on rank 0 (in rank order), None elsewhere."""
    import torch.distributed as dist
    out = [None] * mesh.world_size if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=mesh.host_group)
    return out


def _checks(cell: Cell, stats: Dict) -> Dict:
    return {n: {"value": stats[n], "limit": lim}
            for n, lim in cell.limits["limits"].items()}


def _run_rank(cell: Cell, mesh, seed: int, seconds: float, trace: bool,
              t_start: float) -> Optional[Outcome]:
    import torch
    from h100_bench.compare.train import check
    tr = cell.traffic
    dev = mesh.device
    on_card = dev.type == "cuda"
    lead = mesh.rank == 0
    split = {"start": time.time() - t_start}
    _build_kernels(mesh)
    split["kernels"] = time.time() - t_start
    r = Rank(cell, mesh, seed)
    split["program"] = time.time() - t_start
    cfg, prog_cfg, gb = r.cfg, r.program.cfg, r.global_batch
    compared = [r.compared_step(0)]
    step_metrics: List = []
    k = 1
    for _ in range(tr["warmup_steps"]):
        r.step(k)
        k += 1
    _sync(dev)
    mesh.barrier()
    split["warmup"] = time.time() - t_start
    k2 = _k2_counter(on_card)
    k2_before = k2.launches if k2 is not None else 0

    gc.collect()
    gc.disable()
    setup_s = time.time() - t_start
    host0 = host_sample()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    steps = 0
    while True:
        r.step(k, step_metrics)
        k += 1
        steps += 1
        if mesh.any_rank(lead and time.perf_counter() >= deadline):
            break
    _sync(dev)
    mesh.barrier()
    window = time.perf_counter() - t0
    host = host_delta(host0, host_sample(), steps)
    gc.enable()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if k2 is not None and k2.launches - k2_before < steps:
        raise RuntimeError(f"K2 ran {k2.launches - k2_before} times over "
                           f"{steps} steps: the cell's backward did not run")

    traced, by, coll, grad_bytes, win_step = None, None, None, None, None
    if trace and on_card:
        from h100_bench.stages import by_span, profiled
        from h100_bench.trace import traced as run_traced
        n = tr["trace_steps"]
        before = _counts()
        traced = _aligned(mesh, run_traced, lambda i: r.step(k + i), n)
        k += n
        win = _aligned(mesh, profiled, lambda i: r.step(k + i), n)
        k += n
        after = _counts()
        by = by_span(win)
        coll = _span_kernel_s(win, COLLECTIVE)
        win_step = (win.w1 - win.w0) * 1e-6 / n
        if after is not None and "all_reduce" in after:
            grad_bytes = (after["all_reduce"][1] -
                          before.get("all_reduce", (0, 0))[1]) / (2 * n)

    compared.append(r.compared_step(k))
    mismatch = r.replica_mismatch()
    mine = _window_stats(step_metrics)
    mine.update(host=host, collective_s=coll, memory_peak_bytes=int(peak),
                counts=_counts())
    every = _gather_host(mesh, mine)
    del r
    if on_card:
        torch.cuda.empty_cache()
    if not lead:
        return None

    t_check = time.perf_counter()
    flops: list = []
    stats = check(cfg, [c[0] for c in compared], tr["pool_pairs"] // gb,
                  tr["reference_block"], flops=flops if trace else None)
    stats["sample_mismatch"] = max(c[1] for c in compared)
    del compared
    stats.update(every[0])
    stats["nonfinite_steps"] = max(s["nonfinite_steps"] for s in every)
    stats["replica_mismatch"] = mismatch
    stats["ranks"] = [{k_: v for k_, v in s.items() if k_ != "counts"}
                      for s in every[1:]]
    if by is not None:
        stats["device_by_span"] = by
    stats["check_s"] = time.perf_counter() - t_check
    stats["setup_split_s"] = split
    by_rank = [s["collective_s"] for s in every]
    linked = by_rank[0] is not None and all(
        v and min(v) > 0.0 for v in by_rank)
    layer = {"pairs_per_step": gb, "pairs_per_s": steps * gb / window,
             "call_s": window / steps, "cfg": prog_cfg, "peaks": _peaks(),
             "cards": mesh.data_size, "stats": stats,
             "collective_s": by_rank[0] if linked else None,
             "traced_step_s": win_step,
             "collective_s_by_rank": by_rank if linked else None,
             "gradient_bytes": grad_bytes}
    if traced is not None:
        layer["trace"] = traced
        layer["by_span"] = by
    if flops:
        layer["flops_per_pair"] = flops[0] / tr["reference_block"]
    return Outcome(e2e={"setup_s": setup_s,
                        "pairs_per_s": steps * gb / window},
                   layer=layer, attempted=steps, failed=0,
                   checks=_checks(cell, stats),
                   memory_peak_bytes=max(s["memory_peak_bytes"]
                                         for s in every),
                   device_count=mesh.data_size, trace=traced)


def _calibrate_rank(cell: Cell, mesh, runs, out_path: str) -> None:
    """The ranks' part of :func:`calibrate`: each ``(seed, kind)`` run of
    the program (sound, or a fault of :data:`DP_FAULTS` planted), its
    reading appended to ``out_path`` by rank 0."""
    import torch
    from h100_bench.compare.train import check
    tr = cell.traffic
    on_card = mesh.device.type == "cuda"
    _build_kernels(mesh)
    for seed, kind in runs:
        t0 = time.perf_counter()
        r = Rank(cell, mesh, seed, None if kind == "program" else kind)
        gap = tr["calibrate_steps" if kind == "program" else
                 "calibrate_gap_steps"]
        compared = [r.compared_step(0)]
        nonfinite = 0
        for k in range(1, gap + 1):
            m = r.program(*r.pool.batch(k, r.batch, r.dev),
                          generator=r.program.generator(r.useed, k))
            nonfinite += not all(math.isfinite(float(v))
                                 for v in m.values())
        compared.append(r.compared_step(gap + 1))
        mismatch = r.replica_mismatch()
        cfg, spe = r.cfg, r.spe
        t_prog = time.perf_counter() - t0
        del r
        if on_card:
            torch.cuda.empty_cache()
        if mesh.rank == 0:
            stats = check(cfg, [c[0] for c in compared], spe,
                          tr["reference_block"])
            stats["sample_mismatch"] = max(c[1] for c in compared)
            stats["nonfinite_steps"] = float(nonfinite)
            stats["replica_mismatch"] = mismatch
            with open(out_path, "ab") as f:
                pickle.dump({"seed": seed, "kind": kind, "stats": stats,
                             "seconds": time.perf_counter() - t0,
                             "program_s": t_prog}, f)
        del compared
        if on_card:
            torch.cuda.empty_cache()
        mesh.barrier()


def _rank_main(cell: Cell, device, job: dict, out_path: str) -> int:
    import torch
    torch.set_num_threads(1)
    with _mesh(cell.traffic["ranks"], device) as mesh:
        if job["kind"] == "run":
            out = _run_rank(cell, mesh, job["seed"], job["seconds"],
                            job["trace"], job["t_start"])
            if out is not None:
                with open(out_path, "wb") as f:
                    pickle.dump(out, f)
        else:
            _calibrate_rank(cell, mesh, job["runs"], out_path)
        mesh.barrier()
    bad = forbidden_modules()
    if bad:
        print(f"rank {mesh.rank}: modules of JAX or of the JAX package were "
              "loaded: " + ", ".join(bad), flush=True)
        return 3
    return 0


def _spawn(cell: Cell, device, job: dict, out_path: str,
           timeout: float) -> None:
    from stereo_rcnn_tpu_torch.parallel.launch import spawn
    codes = spawn(_rank_main, cell.traffic["ranks"], cell, device, job,
                  out_path, timeout=timeout)
    if any(codes):
        raise RuntimeError(f"the ranks exited with {codes}")


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device=None) -> Outcome:
    check_sampling_evidence()
    fd, path = tempfile.mkstemp(suffix=".pkl")
    os.close(fd)
    try:
        _spawn(cell, device, {"kind": "run", "seed": seed,
                              "seconds": seconds, "trace": trace,
                              "t_start": t_start}, path,
               timeout=900.0 + 4 * seconds)
        with open(path, "rb") as f:
            return pickle.load(f)
    finally:
        os.remove(path)


def calibrate(cell: Cell, seeds, control_seeds, faults: bool = False,
              device=None):
    """Readings of the correctness numbers (see ``calibrate.py``).  On the
    ranks: for each seed the program's first step, ``calibrate_steps``
    steps and one more, compared; with ``faults``, for each control seed
    each of :data:`DP_FAULTS` planted in the program, with
    ``calibrate_gap_steps`` between its compared steps.  In this process,
    on one card: for each control seed the reference one precision step
    down in the program's place at the global batch, and with ``faults``
    the reference with each of ``compare.train.FAULTS`` planted
    (``train_loop``'s control and faults)."""
    import torch
    from h100_bench.compare.train import FAULTS, check
    from h100_bench.reference.config import load_config
    from h100_bench.reference.train.weights import training_state_dict
    tr = cell.traffic
    runs = [(s, "program") for s in seeds]
    if faults:
        runs += [(s, f) for s in control_seeds for f in DP_FAULTS]
    if runs:
        check_sampling_evidence()
        fd, path = tempfile.mkstemp(suffix=".pkl")
        os.close(fd)
        try:
            failed = None
            try:
                _spawn(cell, device, {"kind": "calibrate", "runs": runs},
                       path, timeout=600.0 + 600.0 * len(runs))
            except RuntimeError as e:
                failed = e
            with open(path, "rb") as f:
                while True:
                    try:
                        yield pickle.load(f)
                    except EOFError:
                        break
            if failed is not None:
                raise failed
        finally:
            os.remove(path)
    if not control_seeds:
        return
    dev = torch.device("cuda", 0) if device is None else torch.device(
        device)
    on_card = dev.type == "cuda"
    gb = tr["batch"] * tr["ranks"]
    spe = tr["pool_pairs"] // gb
    whole = dataclasses.replace(cell, traffic={**tr, "batch": gb})
    cfg = load_config(None, overrides=cell.config["config"])
    for seed in control_seeds:
        left, right, gt = render_pairs(cfg, range(tr["pool_pairs"]),
                                       tr["objects_per_pair"], seed,
                                       threads=8)
        pool = Pool(left, right, gt, pin=on_card)
        del left, right, gt
        for kind in ("control",) + (FAULTS if faults else ()):
            t0 = time.perf_counter()
            sd = training_state_dict(cfg, sub_seed(seed, WEIGHTS), dev)
            gap = tr["calibrate_steps" if kind == "control" else
                     "calibrate_gap_steps"]
            records = _reference_run(
                whole, cfg, pool, sd, sub_seed(seed, UNIFORMS), spe, gap,
                dev, lowered=kind == "control",
                fault=None if kind == "control" else kind)
            t_prog = time.perf_counter() - t0
            del sd
            stats = check(cfg, records, spe, tr["reference_block"])
            stats.update(nonfinite_steps=0.0, replica_mismatch=0.0,
                         sample_mismatch=0.0)
            del records
            if on_card:
                torch.cuda.empty_cache()
            yield {"seed": seed, "kind": kind, "stats": stats,
                   "seconds": time.perf_counter() - t0,
                   "program_s": t_prog}
        del pool
