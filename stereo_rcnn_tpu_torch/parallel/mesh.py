"""Data parallelism over ``torch.distributed``: the port's counterpart of
``stereo_rcnn_tpu.parallel.mesh``.

The JAX package lays its devices out as a 2-D ``Mesh`` (``data`` x
``model``), splits batches on the ``data`` axis, replicates parameters and
lets XLA emit the gradient reduction from the sharding annotations.  Here
one process drives one device (a CUDA card, or the CPU for tests), the
processes form a ``torch.distributed`` group, and the collectives are
written out:

- :func:`make_mesh` forms the group (or joins the one ``torchrun`` or
  :func:`~stereo_rcnn_tpu_torch.parallel.launch.spawn` described in
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT``), with an explicit backend: NCCL on a card, gloo on the
  CPU, or gloo on a card where several ranks share one (NCCL refuses
  that).  Nothing falls back: a failed init raises.
- :func:`batch_sharding` / :func:`shard_batch` give a rank its rows of the
  global batch (``P(DATA_AXIS)`` on dim 0); the ``model`` axis replicates,
  as in the JAX package, where nothing shards over it either.
- :func:`replicate` broadcasts parameters and buffers from rank 0.
- :func:`data_parallel_train_step` reduces the gradients (one all-reduce
  of a flat buffer per dtype over the data axis, then a division by its
  size) between the backward and the optimizer, and draws the target
  sampling's uniforms for the global batch on every rank.
- :func:`data_parallel_inference` runs the pipeline on a rank's rows and
  gathers the detections back in row order.
- :func:`counts` reads the collectives this process has issued, by kind
  (calls and bytes sent); :func:`clear` zeroes them.

The mean of equal-size local gradients is the global one: the losses are
means over the batch of per-image losses, and the uncertainty combination
is linear in each mean (``train/losses.py``).  So the data-parallel step
computes the single-process step at the global batch, up to the order of
the float32 sums.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from collections import Counter
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from stereo_rcnn_tpu_torch.train.losses import LOSS_NAMES
from stereo_rcnn_tpu_torch.utils.profiling import span

DATA_AXIS = "data"
MODEL_AXIS = "model"

_CALLS: Counter = Counter()
_BYTES: Counter = Counter()


class Counts(NamedTuple):
    calls: int      # collectives issued
    bytes: int      # bytes this rank sent into them (its buffer's size)


def _count(kind: str, *tensors: torch.Tensor) -> None:
    _CALLS[kind] += 1
    _BYTES[kind] += sum(t.numel() * t.element_size() for t in tensors)


def counts() -> Dict[str, Counts]:
    """Collectives this process has issued since the start or the last
    :func:`clear`, by kind: ``all_reduce`` (the gradient buffers),
    ``all_reduce_metrics`` (:func:`mean_metrics`), ``broadcast``
    (:func:`replicate`, one per tensor), ``all_gather``
    (:func:`gather_batch`) and ``host_flag`` / ``barrier`` (the host
    group's)."""
    return {k: Counts(_CALLS[k], _BYTES[k]) for k in sorted(_CALLS)}


def clear() -> None:
    """Zero :func:`counts`."""
    _CALLS.clear()
    _BYTES.clear()


@dataclasses.dataclass
class Mesh:
    """This process's place in the ``(data, model)`` grid of ranks: rank
    ``r`` sits at data index ``r // model_parallel`` and model index
    ``r % model_parallel``.  ``groups`` holds the process group of each
    axis through this rank; ``host_group`` is a gloo group over all ranks
    for flags and barriers on the host (no device work, gloo's 30-minute
    timeout while one rank renders or saves)."""

    world_size: int
    rank: int
    local_rank: int
    device: torch.device
    backend: str
    model_parallel: int
    groups: Dict[str, Any]
    host_group: Any
    owns_group: bool

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    def barrier(self) -> None:
        """Every rank waits here for all the others (on the host)."""
        _count("barrier")
        dist.barrier(group=self.host_group)

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on some rank (a MAX all-reduce)."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        _count("host_flag", t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def close(self) -> None:
        """Destroy the process group if :func:`make_mesh` formed it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _rank_device(device, local_rank: int) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for gloo ranks on the CPU")
        return torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    return device


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device: torch.device | str | None = None,
              backend: Optional[str] = None,
              timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """This process's :class:`Mesh` (``stereo_rcnn_tpu.parallel.make_mesh``).

    Joins an initialised default group, else forms one: from ``RANK``,
    ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT`` (``env://``, as
    ``torchrun`` sets them), or, with none set, a group of one rank.
    ``device``: None is the card ``cuda:LOCAL_RANK`` (raises without one),
    ``"cpu"`` the CPU, a CUDA device that card; a card is made current
    before anything is allocated on it.  ``backend``: None is NCCL on a
    card and gloo on the CPU; ``"gloo"`` on a card serves several ranks on
    one card.  ``n_devices``, if given, must be the world size, and
    ``model_parallel`` must divide it.  ``timeout``: how long a
    collective of the device groups formed here (the default group and
    the axes') may wait for a rank (None: ``torch.distributed``'s default
    for the backend); ``host_group`` keeps gloo's default."""
    joined = dist.is_initialized()
    if joined:
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ.get("RANK", "0"))
        world = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the group has {world} "
                         "ranks (start one process per device)")
    if world % model_parallel:
        raise ValueError(f"{world} devices not divisible by "
                         f"mp={model_parallel}")
    device = _rank_device(device, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if joined:
        backend = dist.get_backend()
    else:
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("the NCCL backend needs a CUDA device")
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    rank=rank, world_size=world,
                                    timeout=timeout)
        elif world == 1:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=timeout)
        else:
            raise RuntimeError(f"WORLD_SIZE={world} needs MASTER_ADDR and "
                               "MASTER_PORT (as torchrun sets them)")
    # Every rank creates every group, in the same order.
    mp = model_parallel
    groups = {}
    for d in range(world // mp):
        g = dist.new_group([d * mp + m for m in range(mp)], timeout=timeout)
        if d == rank // mp:
            groups[MODEL_AXIS] = g
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(world // mp)],
                           timeout=timeout)
        if m == rank % mp:
            groups[DATA_AXIS] = g
    # The host group keeps gloo's default timeout: its waits are long
    # (one rank renders, saves or checks while the others wait).
    host_group = (dist.group.WORLD if backend == "gloo" and timeout is None
                  else dist.new_group(backend="gloo"))
    return Mesh(world_size=world, rank=rank, local_rank=local_rank,
                device=device, backend=backend, model_parallel=mp,
                groups=groups, host_group=host_group, owns_group=not joined)


class BatchSharding(NamedTuple):
    """A rank's share of dim 0 (``P(DATA_AXIS)``): part ``index`` of
    ``parts`` equal parts."""

    index: int
    parts: int

    def rows(self, n: int) -> slice:
        """Rows ``[index * b, (index + 1) * b)`` of a global batch of ``n``,
        ``b = n / parts``."""
        if n % self.parts:
            raise ValueError(f"global batch {n} does not split over "
                             f"{self.parts} data ranks")
        b = n // self.parts
        return slice(self.index * b, (self.index + 1) * b)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Leading (batch) dim split over the data axis; the rest replicated."""
    return BatchSharding(mesh.data_index, mesh.data_size)


def _map(fn, tree):
    """``fn`` on every array leaf of nested tuples (NamedTuples too),
    lists and dicts."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    _map(out.append, tree)
    return out


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's rows of every leaf of a global batch (tensors or numpy
    arrays, leading dim B)."""
    sh = batch_sharding(mesh)
    return _map(lambda x: x[sh.rows(x.shape[0])], batch)


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    return _leaves(obj)


@torch.no_grad()
def replicate(mesh: Mesh, obj):
    """Broadcast ``obj``'s tensors from rank 0 in place, and return it: a
    module's parameters and buffers, or the tensors of nested tuples,
    lists and dicts (modules inside them too)."""
    if isinstance(obj, (tuple, list)):
        for x in obj:
            replicate(mesh, x)
        return obj
    if isinstance(obj, dict):
        replicate(mesh, list(obj.values()))
        return obj
    for t in _tensors(obj):
        _count("broadcast", t)
        dist.broadcast(t.detach(), src=0)
    return obj


def _flat_by_dtype(tensors):
    """``{dtype: (flat buffer, [tensors])}``, each buffer their
    concatenation."""
    groups: Dict[torch.dtype, list] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return {dt: (torch.cat([t.reshape(-1) for t in ts]), ts)
            for dt, ts in groups.items()}


@torch.no_grad()
def all_reduce_gradients(mesh: Mesh, params: Dict[str, torch.Tensor]
                         ) -> None:
    """Replace each gradient by its mean over the data axis: one SUM
    all-reduce of a flat buffer per dtype, divided by the data size.
    Every parameter that requires a gradient takes part (a missing one as
    zeros), so the buffers line up on every rank.  Spans (inside the
    step's ``train/all_reduce``): ``train/all_reduce/flatten`` (the
    buffers), ``train/all_reduce/collective`` (the all-reduces alone),
    ``train/all_reduce/unflatten`` (the division and the copies back)."""
    live = [p for p in params.values() if p.requires_grad]
    with span("train/all_reduce/flatten"):
        for p in live:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flats = list(_flat_by_dtype([p.grad for p in live]).values())
    with span("train/all_reduce/collective"):
        for flat, _ in flats:
            _count("all_reduce", flat)
            dist.all_reduce(flat, group=mesh.groups[DATA_AXIS])
    with span("train/all_reduce/unflatten"):
        for flat, ps in flats:
            flat.div_(mesh.data_size)
            at = 0
            for g in ps:
                g.copy_(flat[at:at + g.numel()].view_as(g))
                at += g.numel()


# Metrics that are means over this rank's images; the others (grad_norm
# after the reduction, the learning rate, the uncertainty weights) are
# equal on every rank.
_PER_RANK = (*LOSS_NAMES, "total", "num_fg_rpn", "num_fg_rcnn")


@torch.no_grad()
def mean_metrics(mesh: Mesh, metrics: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The step's metrics as means over the global batch: one all-reduce
    of the per-rank ones over the data axis."""
    keys = [k for k in _PER_RANK if k in metrics]
    flat = torch.stack([metrics[k].float() for k in keys])
    _count("all_reduce_metrics", flat)
    dist.all_reduce(flat, group=mesh.groups[DATA_AXIS])
    flat.div_(mesh.data_size)
    return {**metrics, **dict(zip(keys, flat.unbind()))}


def data_parallel_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """The counterpart of ``stereo_rcnn_tpu.parallel.jit_train_step``:
    ``step_fn`` (``train.make_train_step``) made data-parallel.

    ``dp_step(state, batch, generator=None, uniforms=None,
    reduce_metrics=True) -> metrics`` takes this rank's rows of the global
    batch (:func:`shard_batch`) and a replicated state (:func:`replicate`).
    ``generator`` (seeded alike on every rank) draws the uniforms of the
    global batch, or ``uniforms`` gives them; each rank samples with its
    rows, so the ranks together draw what one process draws.  The
    gradients are averaged over the data axis before the clip and the
    update, so every rank takes the same step.  With ``reduce_metrics``
    the metrics are global means (:func:`mean_metrics`, in the span
    ``train/mean_metrics``), else this rank's.
    """
    def dp_step(state, batch, generator=None, uniforms=None,
                reduce_metrics: bool = True):
        b = batch.images_left.shape[0]
        rows = (mesh.data_index * b, mesh.data_size * b)
        metrics = step_fn(state, batch, generator, uniforms, rows=rows,
                          reduce_grads=lambda params: all_reduce_gradients(
                              mesh, params))
        if not reduce_metrics:
            return metrics
        with span("train/mean_metrics"):
            return mean_metrics(mesh, metrics)
    return dp_step


def gather_batch(mesh: Mesh, tree):
    """Each leaf of ``tree`` (this rank's rows) concatenated over the data
    axis in rank order: one all-gather of a flat buffer per dtype (bool
    leaves as uint8)."""
    leaves = _leaves(tree)
    as_sent = [x.to(torch.uint8) if x.dtype == torch.bool else x
               for x in leaves]
    gathered = {}
    for dt, (flat, ts) in _flat_by_dtype(as_sent).items():
        parts = [torch.empty_like(flat) for _ in range(mesh.data_size)]
        _count("all_gather", flat)
        dist.all_gather(parts, flat, group=mesh.groups[DATA_AXIS])
        at = 0
        for t in ts:
            n = t.numel()
            gathered[id(t)] = torch.cat([p[at:at + n].view_as(t)
                                         for p in parts])
            at += n
    out = iter([gathered[id(s)].to(x.dtype)
                for s, x in zip(as_sent, leaves)])
    return _map(lambda _: next(out), tree)


def data_parallel_inference(pipeline_fn: Callable, mesh: Mesh) -> Callable:
    """The counterpart of ``stereo_rcnn_tpu.parallel.jit_inference``:
    ``fn(model, images_left, images_right, calib_batch, content_wh=None)
    -> Detections3D`` on the global batch, every input split on the batch
    axis.  Each rank runs ``pipeline_fn`` (``inference.make_full_pipeline(
    cfg)``, the runtime-calibration variant) on its rows; the detections
    are gathered back in row order, on every rank."""
    def fn(model, images_left, images_right, calib_batch, content_wh=None):
        rows = batch_sharding(mesh).rows(images_left.shape[0])
        local = pipeline_fn(
            model, images_left[rows], images_right[rows],
            _map(lambda x: x[rows], calib_batch),
            None if content_wh is None else content_wh[rows])
        return gather_batch(mesh, local)
    return fn
