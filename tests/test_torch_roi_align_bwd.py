"""The fused stereo RoIAlign's backward in the port, on the CPU.

``stereo_roi_align_packed_bwd_ref`` (the plain version of the CUDA kernel
K2) against ``jax.vjp`` through ``stereo_roi_align_batched_packed``, whose
backward is the Pallas kernel in interpret mode; against
``torch.autograd`` of the plain forward; and the autograd Function that
the detector calls.

The rois (at 512x256, where the P2 and P3 windows are narrower than their
levels) include a roi wider than its 64-cell window, rois that leave the
image at the bottom-right (their samples clamp to the window's last cell,
``p = win - 1``, where the hat weight and the floor/frac taps must agree),
one fully outside, and zero-area rois (exact zero gradient).

Tolerance: 1e-5 of each level's largest |gradient| (float32 sums of the
same terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu.ops.roi_align_pallas import (
    stereo_roi_align_batched_packed)
from stereo_rcnn_tpu_torch.ops import stereo_roi_align as t_sra

STRIDES = (4, 8, 16, 32)
H, W, C, B = 256, 512, 8, 2
TOL = 1e-5


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(11)
    shapes = [(H // s, W // s) for s in STRIDES]
    fl = [rng.rand(B, h, w, C).astype(np.float32) for h, w in shapes]
    fr = [rng.rand(B, h, w, C).astype(np.float32) for h, w in shapes]
    rois = np.array([
        [60, 40, 100, 70],        # P2
        [150, 60, 240, 105],      # P2/P3
        [200, 20, 380, 110],      # P3
        [100, 100, 400, 120],     # P2, 75 cells wide: wider than 64
        [420, 200, 560, 300],     # leaves the image at the bottom-right
        [600, 300, 700, 400],     # fully outside
        [40, 20, 400, 220],       # P4
        [-100, -80, 600, 400],    # P5, beyond the image on every side
        [30, 30, 30, 30],         # zero area
        [0, 0, 0, 0],             # zero area (a padded GT row)
    ], np.float32)
    rl = np.stack([rois, rois[::-1].copy()])
    rr = rl - np.float32([12, 0, 9, 0])
    empty = (rl[..., 2] <= rl[..., 0]) | (rl[..., 3] <= rl[..., 1])
    rr[empty] = rl[empty]
    r = rl.shape[1]
    cot = rng.randn(B, r, t_sra.ROWS, C).astype(np.float32)
    return shapes, fl, fr, rl, rr, cot


def _jax_grads(fl, fr, rl, rr, cot):
    def fwd(fl_, fr_):
        return stereo_roi_align_batched_packed(
            tuple(fl_), tuple(fr_), jnp.asarray(rl), jnp.asarray(rr),
            STRIDES, 7, 14, True)
    _, vjp = jax.vjp(fwd, [jnp.asarray(f) for f in fl],
                     [jnp.asarray(f) for f in fr])
    return vjp(jnp.asarray(cot))


def _close_per_level(ours, theirs, what):
    for lvl, (o, t) in enumerate(zip(ours, theirs)):
        o = o.detach().numpy() if isinstance(o, torch.Tensor) else o
        t = np.asarray(t)
        scale = float(np.abs(t).max())
        assert scale > 0.0, (what, lvl)
        np.testing.assert_allclose(o, t, rtol=0, atol=TOL * scale,
                                   err_msg=f"{what} level {lvl}")


def test_plain_backward_matches_jax(case):
    shapes, fl, fr, rl, rr, cot = case
    d_l, d_r = t_sra.stereo_roi_align_packed_bwd_ref(
        torch.from_numpy(cot), torch.from_numpy(rl), torch.from_numpy(rr),
        shapes, STRIDES)
    j_l, j_r = _jax_grads(fl, fr, rl, rr, cot)
    _close_per_level(d_l, j_l, "left")
    _close_per_level(d_r, j_r, "right")


def test_plain_backward_matches_autograd(case):
    shapes, fl, fr, rl, rr, cot = case
    tl = [torch.from_numpy(f).requires_grad_(True) for f in fl]
    tr = [torch.from_numpy(f).requires_grad_(True) for f in fr]
    out = t_sra.stereo_roi_align_packed_ref(tl, tr, torch.from_numpy(rl),
                                            torch.from_numpy(rr), STRIDES)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                tl + tr)
    d_l, d_r = t_sra.stereo_roi_align_packed_bwd_ref(
        torch.from_numpy(cot), torch.from_numpy(rl), torch.from_numpy(rr),
        shapes, STRIDES)
    _close_per_level(d_l, grads[:4], "left")
    _close_per_level(d_r, grads[4:], "right")


def test_zero_area_rois_get_zero_gradient(case):
    shapes, fl, fr, rl, rr, cot = case
    zero = np.zeros_like(rl)
    d_l, d_r = t_sra.stereo_roi_align_packed_bwd_ref(
        torch.from_numpy(cot), torch.from_numpy(zero),
        torch.from_numpy(zero), shapes, STRIDES)
    assert all(not d.any() for d in d_l + d_r)
    # Only the zero-area rows of the cotangent: zero gradient too.
    only = np.zeros_like(cot)
    only[0, -2:], only[1, :2] = cot[0, -2:], cot[1, :2]
    d_l, d_r = t_sra.stereo_roi_align_packed_bwd_ref(
        torch.from_numpy(only), torch.from_numpy(rl), torch.from_numpy(rr),
        shapes, STRIDES)
    assert all(not d.any() for d in d_l + d_r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_uses_the_plain_backward(case, dtype):
    """The differentiable entry the detector calls: on CPU tensors its
    backward is the plain backward, cast to the levels' dtype."""
    shapes, fl, fr, rl, rr, cot = case
    tl = [torch.from_numpy(f).to(dtype).requires_grad_(True) for f in fl]
    tr = [torch.from_numpy(f).to(dtype).requires_grad_(True) for f in fr]
    rl_t, rr_t = torch.from_numpy(rl), torch.from_numpy(rr)
    out = t_sra.stereo_roi_align_packed(tl, tr, rl_t, rr_t, STRIDES)
    with torch.no_grad():
        ref = t_sra.stereo_roi_align_packed_ref(tl, tr, rl_t, rr_t, STRIDES)
    assert torch.equal(out, ref)
    out.backward(torch.from_numpy(cot))
    d_l, d_r = t_sra.stereo_roi_align_packed_bwd_ref(
        torch.from_numpy(cot), rl_t, rr_t, shapes, STRIDES)
    for t, d in zip(tl + tr, d_l + d_r):
        assert t.grad.dtype == dtype
        assert torch.equal(t.grad, d.to(dtype))


def _kernel_rect(meta, geom, shapes):
    """K2's tile test restated (``axis_meets`` in
    ``csrc/stereo_roi_align_bwd.cu``): per roi and axis, the low tap of
    sample 0 and the high tap of sample 13, in absolute level cells
    ``(first row, last row, first column, last column)``."""
    win = np.array(t_sra.window_shapes(shapes))[meta[..., 0]]    # [B, R, 2]
    out = []
    for axis in (0, 1):
        last = (win[..., axis] - 1).astype(np.float32)
        start, step = geom[..., axis], geom[..., 2 + axis]

        def tap_cell(k):                # the fused multiply-add, clamped
            pos = (np.float64(k) * step + start).astype(np.float32)
            return np.floor(np.minimum(np.maximum(pos, 0.0), last))
        origin = meta[..., 1 + axis]
        out += [origin + tap_cell(0.5).astype(np.int64),
                origin + np.minimum(tap_cell(t_sra.PK - 0.5) + 1.0,
                                    last).astype(np.int64)]
    return np.stack(out, -1)


def test_tap_rects_span_every_tap(case):
    """K2's tile test: the rectangle its hit scan computes from a roi's
    metadata (:func:`_kernel_rect`) is exactly the span of the taps that
    ``packed_bwd_contributions`` scatters for each valid roi, so every tap
    falls inside it; a zero-area roi has its valid bit 0, which the scan
    skips, and scatters only zeros."""
    shapes, fl, fr, rl, rr, cot = case
    sizes = [h * w for h, w in shapes]
    offsets = np.cumsum([0] + sizes[:-1])
    widths = np.array([w for _, w in shapes])
    contrib = t_sra.packed_bwd_contributions(
        torch.from_numpy(cot), torch.from_numpy(rl), torch.from_numpy(rr),
        shapes, STRIDES)
    r = rl.shape[1]
    for rois, side in ((rl, contrib[0]), (rr, contrib[1])):
        meta, geom = t_sra.roi_window_meta(shapes, torch.from_numpy(rois),
                                           STRIDES)
        meta, geom = meta.numpy(), geom.numpy()
        rect = _kernel_rect(meta, geom, shapes)
        level = meta[..., 0]
        valid = meta[..., 3] > 0
        idx = torch.stack([i.reshape(B, r, -1) for i, _ in side],
                          -1).reshape(B, r, -1).numpy()
        rem = (idx - (np.arange(B) * sum(sizes))[:, None, None] -
               offsets[level][..., None])
        rows, cols = rem // widths[level][..., None], \
            rem % widths[level][..., None]
        span = np.stack([rows.min(-1), rows.max(-1), cols.min(-1),
                         cols.max(-1)], -1)
        assert valid.sum() >= 2 * 7 and (~valid).sum() >= 2 * 2
        np.testing.assert_array_equal(rect[valid], span[valid])
        empty = (rois[..., 2] <= rois[..., 0]) | (rois[..., 3] <= rois[..., 1])
        np.testing.assert_array_equal(valid, ~empty)
        values = torch.stack([v.reshape(B, r, -1) for _, v in side], -1)
        assert not values[torch.from_numpy(~valid)].any()
