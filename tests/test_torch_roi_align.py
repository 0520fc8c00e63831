"""The port's one-sided RoIAlign against the JAX package, on the CPU: the
atlas gather ``ops/roi_align.py::multilevel_roi_align`` (what the JAX
package leaves to XLA, the ``Config()`` default) with its gradient, and
the plain version of K3 (``ops/roi_align_window.py``) against
``multilevel_roi_align_pallas`` in interpret mode.

Inputs come from numpy with fixed seeds: a 256x512 pyramid, C=32, rois on
every level, plus a zero-area roi, a roi fully outside the image, a roi
beyond the image on every side, rois wider than their window (as the
300x40 px and 1200x100 px cases of ``tests/test_torch_ops.py``) and, for
the gather, rois whose samples fall just inside and just outside the 1-px
out-of-bounds margin.

Tolerances: float32 1e-5 absolute on unit-scale features (the same taps
and weights; XLA fuses the sample position's multiply-add, torch rounds
twice); bfloat16 one bf16 step (2^-8) of the largest |output|, since XLA
on the CPU may keep bf16 intermediates in float32 where torch rounds each
op; gradients 1e-5 of the largest |gradient|; K3 1e-4 absolute, as K1's
test (its plain version weights 4 taps per sample where the TPU kernel
runs two f32 hat matmuls, and XLA fuses the positions' multiply-add: a
position an ulp apart moves a sample by up to 2e-5 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu.ops.roi_align import multilevel_roi_align as j_align
from stereo_rcnn_tpu.ops.roi_align_pallas import multilevel_roi_align_pallas
from stereo_rcnn_tpu_torch.ops import roi_align_window as t_win
from stereo_rcnn_tpu_torch.ops.roi_align import (fpn_level_assignment,
                                                 multilevel_roi_align,
                                                 roi_align)

STRIDES = (4, 8, 16, 32)
H, W, C, B = 256, 512, 32, 2


def _rois(rng, n=24):
    xy = rng.uniform(-20, [W, H], size=(n, 2))
    wh = rng.uniform(1, [400, 200], size=(n, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:8] = [[30, 30, 30, 30],          # zero area
                [600, 300, 700, 400],      # fully outside the image
                [-60, -50, 600, 350],      # beyond the image on every side
                [40, 60, 440, 90],         # P2, 100 cells: wider than 96
                [20, 100, 500, 140],       # P3, 60 cells wide
                [100, 230, 140, 270],      # P2: samples past y = 64 cells
                [200, -10, 240, 30],       # P2: samples above y = -1 cell
                [-12, 80, 30, 100]]        # P2: samples left of x = -1
    return rois


def _inputs(dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, H // s, W // s, C).astype(np.float32)
             for s in STRIDES]
    rois = np.stack([_rois(rng), _rois(rng)[::-1].copy()])
    if dtype is not np.float32:
        feats = [np.asarray(jnp.asarray(f, jnp.bfloat16)) for f in feats]
    return feats, rois


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def test_margin_cases_are_exercised():
    """The edge rois put samples on both sides of the 1-px margin, and
    every level gets rois."""
    _, rois = _inputs()
    levels = fpn_level_assignment(torch.from_numpy(rois), 4).numpy()
    assert set(levels.ravel().tolist()) == {0, 1, 2, 3}
    # Roi 5 at P2: 14 sample rows over y in [57.5, 67.5] cells of a
    # 64-row level; roi 6 over y in [-2.5, 7.5].
    ys = 57.5 + (np.arange(14) + 0.5) / 14 * 10.0
    assert ((ys > 63) & (ys <= 64)).any() and (ys > 64).any()
    ys = -2.5 + (np.arange(14) + 0.5) / 14 * 10.0
    assert ((ys >= -1) & (ys < 0)).any() and (ys < -1).any()
    # Roi 3 is wider than K3's 96-column window at P2.
    assert levels[0, 3] == 0 and (rois[0, 3, 2] - rois[0, 3, 0]) / 4 > 96
    assert levels[0, 5] == levels[0, 6] == levels[0, 7] == 0


@pytest.mark.parametrize("p, s", [(7, 2), (14, 1)])
@pytest.mark.parametrize("bf16", [False, True])
def test_atlas_gather_matches_jax(p, s, bf16):
    feats, rois = _inputs(jnp.bfloat16 if bf16 else np.float32)
    t_feats = [_to_torch(f) for f in feats]
    for batched in (True, False):
        fj = [jnp.asarray(f if batched else f[0]) for f in feats]
        ft = t_feats if batched else [f[0] for f in t_feats]
        r = rois if batched else rois[0]
        ref = np.asarray(j_align(fj, jnp.asarray(r), STRIDES, p, s))
        out = multilevel_roi_align(ft, torch.from_numpy(r), STRIDES, p, s)
        assert out.dtype == ft[0].dtype
        assert out.shape == ref.shape
        ref = ref.astype(np.float32)
        tol = 2.0 ** -8 * np.abs(ref).max() if bf16 else 1e-5
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                                   atol=tol)
    # The roi fully outside the image gives zeros.
    assert float(out[1].abs().max()) == 0.0


def test_single_level_roi_align_matches_jax():
    from stereo_rcnn_tpu.ops.roi_align import roi_align as j_single
    feats, rois = _inputs()
    ref = np.asarray(j_single(jnp.asarray(feats[1][0]),
                              jnp.asarray(rois[0]), 7, 1 / 8, 2))
    out = roi_align(torch.from_numpy(feats[1][0]), torch.from_numpy(rois[0]),
                    7, 1 / 8, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_atlas_gather_gradient_matches_jax():
    """torch autograd through the gather (a scatter-add) against jax.vjp on
    the same cotangent, both output sizes, float32."""
    feats, rois = _inputs()
    rng = np.random.RandomState(3)
    for p, s in ((7, 2), (14, 1)):
        cot = rng.randn(B, rois.shape[1], p, p, C).astype(np.float32)
        _, vjp = jax.vjp(lambda fs: j_align(fs, jnp.asarray(rois), STRIDES,
                                            p, s),
                         [jnp.asarray(f) for f in feats])
        (ref,) = vjp(jnp.asarray(cot))
        t_feats = [torch.from_numpy(f).requires_grad_(True) for f in feats]
        multilevel_roi_align(t_feats, torch.from_numpy(rois), STRIDES, p,
                             s).backward(torch.from_numpy(cot))
        for lvl, (t, g) in enumerate(zip(t_feats, ref)):
            g = np.asarray(g)
            scale = float(np.abs(g).max())
            assert scale > 0.0, lvl
            np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"level {lvl}")


# ---------------------------------------------------------------------------
# K3: the windowed one-sided RoIAlign.
# ---------------------------------------------------------------------------

def test_k3_window_meta_matches_jax():
    """Levels, window origins (8-aligned) and geometry as the TPU kernel's
    wrapper computes them, at a pyramid whose levels exceed the 48x96
    window."""
    rng = np.random.RandomState(4)
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    rois = _rois(rng) * np.float32([5, 3, 5, 3])
    meta, geom = t_win.roi_align_window_meta(shapes, torch.from_numpy(rois),
                                             STRIDES, 7)
    # The JAX wrapper's own arithmetic (roi_align_pallas.py :132-158).
    from stereo_rcnn_tpu.ops.roi_align import fpn_level_assignment as j_lv
    lv = np.asarray(j_lv(jnp.asarray(rois), 4))
    wins = [(min(h, 48), min(w, 96)) for h, w in shapes]
    scale = 1.0 / np.float32(STRIDES)[lv]
    sc = rois * scale[:, None]
    rw = np.maximum(sc[:, 2] - sc[:, 0], 1.0)
    rh = np.maximum(sc[:, 3] - sc[:, 1], 1.0)
    wh = np.float32([w[0] for w in wins])[lv]
    ww = np.float32([w[1] for w in wins])[lv]
    lh = np.float32([s[0] for s in shapes])[lv]
    lw = np.float32([s[1] for s in shapes])[lv]
    y0 = np.clip(np.floor(sc[:, 1] + rh / 2 - wh / 2), 0,
                 np.maximum(lh - wh, 0)).astype(np.int32)
    x0 = np.clip(np.floor(sc[:, 0] + rw / 2 - ww / 2), 0,
                 np.maximum(lw - ww, 0)).astype(np.int32) // 8 * 8
    np.testing.assert_array_equal(meta.numpy(),
                                  np.stack([lv, y0, x0, np.ones_like(lv)],
                                           -1))
    np.testing.assert_allclose(
        geom.numpy(), np.stack([sc[:, 1] - y0, sc[:, 0] - x0, rh / 7,
                                rw / 7], -1), rtol=0, atol=1e-5)
    assert (x0 % 8 == 0).all() and (x0 > 0).any()


@pytest.mark.parametrize("p, s", [(7, 2), (14, 1)])
@pytest.mark.parametrize("bf16", [False, True])
def test_k3_plain_matches_jax_kernel(p, s, bf16):
    """multilevel_roi_align_window (plain on the CPU) against
    multilevel_roi_align_pallas in interpret mode, batched and unbatched.
    The zero-area roi is sampled as a 1-cell roi, not zeroed."""
    feats, rois = _inputs(jnp.bfloat16 if bf16 else np.float32, seed=1)
    feats = [np.abs(f) for f in feats]
    t_feats = [_to_torch(f) for f in feats]
    for batched in (True, False):
        fj = [jnp.asarray(f if batched else f[0]) for f in feats]
        ft = t_feats if batched else [f[0] for f in t_feats]
        r = rois if batched else rois[0]
        ref = np.asarray(multilevel_roi_align_pallas(
            fj, jnp.asarray(r), STRIDES, p, s, interpret=True))
        before = t_win.roi_align_window_kernel.launches
        out = t_win.multilevel_roi_align_window(ft, torch.from_numpy(r),
                                                STRIDES, p, s)
        assert t_win.roi_align_window_kernel.launches == before
        assert out.dtype == torch.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    zero_area = ref[0]
    assert np.abs(zero_area).max() > 0.0
    np.testing.assert_allclose(out[0].numpy(), zero_area, rtol=0, atol=1e-4)


def test_k3_wrapper_rejects_other_devices():
    feats, rois = _inputs()
    with pytest.raises(RuntimeError, match="no implementation"):
        t_win.multilevel_roi_align_window(
            [torch.from_numpy(f).to("meta") for f in feats],
            torch.from_numpy(rois).to("meta"), STRIDES, 7, 2)
