"""Arithmetic shared by the per-layer readers of ``metrics/``.  Each
reader gets the driver's context dict and returns a number, or None where
the run had nothing for it to read (no traced window, no such kernel)."""

from __future__ import annotations

from typing import Optional

from h100_bench.work.roi_align_bytes import k1_bytes

K1 = r"\bstereo_roi_align_kernel[<(]"


def launches_per_unit(ctx: dict) -> Optional[float]:
    """Kernels the card ran per call (or step) of the traced window."""
    tr = ctx.get("trace")
    if tr is None or not tr.units:
        return None
    return len(tr.kernels) / tr.units


def idle_percent(ctx: dict) -> Optional[float]:
    """The share of an untraced call with nothing on the card, in %: the
    device's busy seconds per call of the traced window over the seconds
    per call of the measured window.  The profiler slows the host's
    issue of a host-bound call, so the traced window's own length would
    count the profiler's time as idle."""
    tr = ctx.get("trace")
    call_s = ctx.get("call_s")
    if tr is None or not tr.units or not call_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.units / call_s)


def mfu_percent(ctx: dict, rate_key: str) -> Optional[float]:
    """The reference's FLOPs per pair at the cell's shapes times the
    window's pairs per second, over the card's published dense
    peak in the configuration's compute dtype, in %."""
    flops = ctx.get("flops_per_pair")
    rate = ctx.get(rate_key)
    if not flops or not rate:
        return None
    peak = ctx["peaks"]["flops_per_s"][ctx["cfg"].compute_dtype]
    return 100.0 * flops * rate / peak


def _roofline(ctx: dict, pattern: str, n_bytes: int) -> Optional[float]:
    tr = ctx.get("trace")
    if tr is None:
        return None
    times = tr.kernel_times(pattern)
    if not times:
        return None
    bound = n_bytes / ctx["peaks"]["hbm_bytes_per_s"]
    return 100.0 * bound / (sum(times) / len(times))


def _shape(cfg):
    return (cfg.data.image_h, cfg.data.image_w)


def k1_roofline(ctx: dict) -> Optional[float]:
    """K1's bound (its output and rois from their shapes, at the card's
    HBM rate; :mod:`work.roi_align_bytes`) over its mean device time per
    launch in the traced window, in %."""
    if ctx.get("trace") is None:
        return None
    cfg = ctx["cfg"]
    return _roofline(ctx, K1, k1_bytes(
        ctx["pairs_per_call"], cfg.rpn.test_post_nms_top_n,
        cfg.backbone.fpn_dim, _shape(cfg), levels=False))
