"""Roofline of the port's inference pipeline on one H100.

    python -m stereo_rcnn_tpu_torch.tools.roofline [--batch 16 32]
        [--iters 20] [--impl pallas|xla] [--tiny] [--platform cpu]

Port of the JAX package's ``tools/roofline.py``.  For each nested prefix
of ``tools/perf_breakdown.py`` it counts the work (FLOPs and bytes),
times the prefix with CUDA events, and places it against the card's
roofline::

    roof = max(flops / PEAK_FLOPS, bytes / HBM_BYTES_PER_S)

``util = roof / measured`` is the share of the hardware bound reached
(1.0: the prefix cannot go faster without less work); ``bound`` says
which wall it sits under; ``MFU = flops / PEAK_FLOPS / measured``.

The JAX tool read both counts from XLA's ``cost_analysis`` of the
optimised program.  Eager PyTorch has no such program, so the counts are
taken here in one counting pass of the prefix (the same ops on the same
device as the timed calls):

- FLOPs from ``torch.utils.flop_counter.FlopCounterMode``, which counts
  matrix products and convolutions only (2 per multiply-add); XLA's count
  also holds elementwise work and reductions, and the custom RoIAlign op
  (K1) adds no FLOPs here;
- bytes from :class:`ByteCounter`, a ``TorchDispatchMode`` that adds, for
  every ATen op that is neither a view nor an allocation, the bytes of
  each distinct tensor input once and of each output once.  Eager PyTorch
  runs each op as its own kernels, so this is the op-by-op (unfused)
  traffic, not an optimised program's; it counts a broadcast input's
  distinct elements, and it sees the registered K1 op
  (``stereo_rcnn_tpu_torch::stereo_roi_align_fwd``) like any ATen op.

Peaks are the H100 SXM's published dense rates (NVIDIA data sheet):
:data:`PEAK_FLOPS` by ``compute_dtype``, :data:`HBM_BYTES_PER_S`.  The
table is printed under the card's ``nvidia-smi`` name and power limit (a
card set below 700 W runs below these peaks).  A util or MFU above
:data:`MAX_SHARE` is a counting fault, and the tool raises on it.

On the CPU (``--platform cpu``, for tests) it prints the counts and
"not measured" in place of every time, util and MFU.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from stereo_rcnn_tpu_torch.tools import perf_breakdown

#: H100 SXM dense peaks (NVIDIA data sheet), by ``Config.compute_dtype``:
#: bf16 tensor-core and float32 (non-tensor-core) FLOP/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: H100 SXM HBM3 bandwidth, bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: A util or MFU above this is a counting fault.
MAX_SHARE = 1.05
# Ops that only allocate (no bytes moved) or only compare metadata.
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "resize_", "is_same_size"}


def _is_view(func) -> bool:
    """A view returns an alias of an input that it does not write."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements: a broadcast (stride 0) axis is
    read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class ByteCounter(TorchDispatchMode):
    """Adds up in ``bytes`` what each ATen op reads and writes (see the
    module docstring)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name.split("::")[-1]
        if _is_view(func) or name in _NO_TRAFFIC:
            return out
        seen = set()
        for t in tree_flatten((args, kwargs or {}))[0]:
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                self.bytes += _read_bytes(t)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def count(fn, *args):
    """``(flops, bytes)`` of one call of ``fn(*args)``."""
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False)
    with flops, ByteCounter() as moved:
        fn(*args)
    return float(flops.get_total_flops()), float(moved.bytes)


def main(argv=None) -> list:
    """Print the roofline table for each batch; returns one dict per
    (batch, prefix) with its counts, and ``ms``, ``util`` and ``mfu``
    (None on the CPU)."""
    from stereo_rcnn_tpu_torch.device import resolve_device
    p = perf_breakdown.common_parser(__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[16])
    args = p.parse_args(argv)
    dev = resolve_device(None if args.platform == "auto" else "cpu")
    on_card = dev.type == "cuda"
    rows = []
    for batch in args.batch:
        cfg, model, left, right, calib_b = perf_breakdown.setup(
            batch, args.impl, args.tiny, dev)
        peak = PEAK_FLOPS[cfg.compute_dtype]
        where = (perf_breakdown.card_name() if on_card
                 else "cpu: counts only, times not measured")
        print(f"\nbatch={batch} impl={args.impl} "
              f"res={cfg.data.image_h}x{cfg.data.image_w} "
              f"dtype={cfg.compute_dtype}  peak {peak / 1e12:.0f} TFLOP/s, "
              f"HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s (H100 SXM data sheet)"
              f"  [{where}]")
        print(f"{'prefix':18s} {'ms/batch':>12s} {'GFLOP':>9s} {'GB':>8s} "
              f"{'roof ms':>8s} {'bound':>6s} {'util':>12s} {'MFU':>12s}")
        for name, fn in perf_breakdown.prefixes(cfg, model, calib_b):
            flops, n_bytes = count(fn, left, right)
            t_flop, t_mem = flops / peak, n_bytes / HBM_BYTES_PER_S
            roof = max(t_flop, t_mem)
            bound = "flops" if t_flop >= t_mem else "bytes"
            row = {"batch": batch, "prefix": name, "gflop": flops / 1e9,
                   "gb": n_bytes / 1e9, "roof_ms": roof * 1e3,
                   "bound": bound, "ms": None, "util": None, "mfu": None}
            if on_card:
                ms = perf_breakdown.time_ms(fn, left, right, args.iters)
                row.update(ms=ms, util=roof * 1e3 / ms,
                           mfu=t_flop * 1e3 / ms)
                if row["util"] > MAX_SHARE or row["mfu"] > MAX_SHARE:
                    raise RuntimeError(
                        f"roofline: {name} at batch {batch}: util "
                        f"{row['util']:.3f}, MFU {row['mfu']:.3f} above "
                        f"{MAX_SHARE}: a counting fault")
                shown = (f"{ms:12.2f}", f"{row['util']:12.3f}",
                         f"{row['mfu']:12.3f}")
            else:
                shown = (f"{'not measured':>12s}",) * 3
            print(f"{name:18s} {shown[0]} {flops / 1e9:9.2f} "
                  f"{n_bytes / 1e9:8.3f} {roof * 1e3:8.3f} {bound:>6s} "
                  f"{shown[1]} {shown[2]}", flush=True)
            rows.append(row)
        del model, left, right
        if on_card:
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
