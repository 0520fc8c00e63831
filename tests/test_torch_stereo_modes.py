"""The fused stereo RoIAlign's other forms in the port against the JAX
package, on the CPU: K1's kron sampling-weight modes (``kron_bf16``,
``kron_hilo``), its tool-only two-matmul modes (``bf16``, ``hilo``) and K4,
the atlas variant, each through its plain version against the Pallas
kernel in interpret mode.

Inputs come from numpy with fixed seeds: a 256x512 pyramid (so the P2 and
P3 windows are narrower than their levels), C=8, unit-variance features,
rois on every level, a zero-area roi, one fully outside the image, one
beyond it on every side, one wider than its 64-column window, and small
rois whose samples are under one cell apart (the two samples of a right
bin share rows and columns, so their hats are summed before the
rounding).

Tolerances: the kron modes 1e-5 absolute: the port computes the same
rounded weights as the TPU kernel's interpret run (positions rounded once,
as XLA's fused multiply-add), so only the float32 sums' order differs.
The two-matmul modes 1e-5 absolute too, for the same reason: the same
rounded hats, and y-pass sums over the same two (left) or four (right)
touched rows.  A bf16 intermediate one float32 rounding from a bf16
boundary would move by a bf16 step (about 1e-2 here) where the two sum in
another order; these inputs hit none (measured: 2.4e-7).
K4 1e-4 absolute against the Pallas kernel, as K1's f32 test (XLA fuses the
positions' multiply-add, the plain version rounds twice); K4's plain
version against K1's f32 plain version 1e-5 (the same taps on the same
values; in fact equal).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu.ops.roi_align_pallas import (
    _atlas_meta, _pack_atlas, stereo_roi_align_batched_packed,
    stereo_roi_align_pallas, stereo_roi_align_pallas_atlas)
from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.models import detector as t_det
from stereo_rcnn_tpu_torch.ops import stereo_roi_align as t_sra

STRIDES = (4, 8, 16, 32)
H, W, C, B = 256, 512, 8, 2


def _inputs(dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    shapes = [(H // s, W // s) for s in STRIDES]
    fl = [rng.randn(B, h, w, C).astype(np.float32) for h, w in shapes]
    fr = [rng.randn(B, h, w, C).astype(np.float32) for h, w in shapes]
    xy = rng.uniform(-20, [W, H], size=(24, 2))
    wh = rng.uniform(1, [300, 160], size=(24, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:8] = [[30, 30, 30, 30],            # zero area
                [600, 300, 700, 400],        # fully outside the image
                [-60, -50, 600, 350],        # beyond the image, every side
                [40, 60, 340, 90],           # P2, 75 cells: wider than 64
                [100, 100, 103, 102],        # 3x2 px: 0.05 cells apart
                [300, 40, 320, 55],          # 20x15 px: under 1 cell apart
                [400, 200, 440, 230],        # 40x30 px: under 1 cell apart
                [0, 0, 511, 255]]            # the whole image, P4
    rl = np.stack([rois, rois[::-1].copy()])
    rr = rl - np.float32([9, 0, 6, 0])
    if dtype is not np.float32:
        fl = [np.asarray(jnp.asarray(f, jnp.bfloat16)) for f in fl]
        fr = [np.asarray(jnp.asarray(f, jnp.bfloat16)) for f in fr]
    return fl, fr, rl, rr


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _torch_args(fl, fr, rl, rr):
    return ([_to_torch(f) for f in fl], [_to_torch(f) for f in fr],
            torch.from_numpy(rl), torch.from_numpy(rr))


@pytest.mark.parametrize("hat", ["kron_bf16", "kron_hilo"])
@pytest.mark.parametrize("bf16", [False, True])
def test_k1_kron_plain_matches_jax_kernel(hat, bf16):
    """All 294 rows of K1's plain version in a kron mode against
    ``stereo_roi_align_batched_packed(..., hat=...)`` in interpret mode."""
    fl, fr, rl, rr = _inputs(jnp.bfloat16 if bf16 else np.float32)
    ref = np.asarray(stereo_roi_align_batched_packed(
        tuple(jnp.asarray(f) for f in fl), tuple(jnp.asarray(f) for f in fr),
        jnp.asarray(rl), jnp.asarray(rr), STRIDES, 7, 14, True, hat))
    before = t_sra.stereo_roi_align_kernel.launches
    out = t_sra.stereo_roi_align_packed(*_torch_args(fl, fr, rl, rr),
                                        STRIDES, hat)
    assert t_sra.stereo_roi_align_kernel.launches == before
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert float(out[0, 0].abs().max()) == 0.0          # zero-area roi
    # The small rois' samples are under one cell apart, so the two samples
    # of a right bin share rows and columns: the avg-folded weights matter.
    level_shapes = [(H // s, W // s) for s in STRIDES]
    _, geom = t_sra.roi_window_meta(level_shapes, torch.from_numpy(rr),
                                    STRIDES)
    assert (geom[0, 4:7, 2:] < 1).all()


@pytest.mark.parametrize("hat", ["bf16", "hilo"])
@pytest.mark.parametrize("bf16", [False, True])
def test_k1_two_matmul_plain_matches_jax_kernel(hat, bf16):
    """All 294 rows of K1's plain version in a two-matmul mode against
    ``stereo_roi_align_pallas(hat_dtype=jnp.bfloat16 / "hilo")`` in
    interpret mode, image by image: the kpt samples, the left 7x7 and the
    right 7x7 (``ps=7, avg=2``)."""
    fl, fr, rl, rr = _inputs(jnp.bfloat16 if bf16 else np.float32)
    out = t_sra.stereo_roi_align_packed_ref(*_torch_args(fl, fr, rl, rr),
                                            STRIDES, hat)
    assert out.dtype == torch.float32
    r = rl.shape[1]
    for b in range(B):
        p7l, p7r, k14 = stereo_roi_align_pallas(
            [jnp.asarray(f[b]) for f in fl], [jnp.asarray(f[b]) for f in fr],
            jnp.asarray(rl[b]), jnp.asarray(rr[b]), STRIDES, 7, 14,
            interpret=True, hat_dtype=jnp.bfloat16 if hat == "bf16" else hat)
        ref = np.concatenate([np.asarray(x).reshape(r, -1, C)
                              for x in (k14, p7l, p7r)], axis=1)
        np.testing.assert_allclose(out[b].numpy(), ref, rtol=0, atol=1e-5)
    assert float(out[0, 0].abs().max()) == 0.0          # zero-area roi
    # Not the kron weights, nor the f32 ones: the mode is its own.
    args = _torch_args(fl, fr, rl, rr)
    for other in ("f32", "kron_bf16" if hat == "bf16" else "kron_hilo"):
        assert not torch.equal(
            out, t_sra.stereo_roi_align_packed_ref(*args, STRIDES, other))


@pytest.mark.parametrize("hat", ["bf16", "hilo"])
def test_two_matmul_modes_stay_off_the_public_entry(hat):
    """As the JAX package's ``_HAT_MODES``: the public entry and the
    detector's ``rcnn.roi_align_hat`` refuse the tool-only modes, which the
    kernel-level entry (here its plain version) takes."""
    fl, fr, rl, rr = _torch_args(*_inputs())
    assert hat not in t_sra.HAT_MODES and hat in t_sra.TOOL_HAT_MODES
    with pytest.raises(KeyError):
        t_sra.stereo_roi_align_packed(fl, fr, rl, rr, STRIDES, hat)
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, rcnn=dataclasses.replace(
        cfg.rcnn, roi_align_impl="pallas", roi_align_hat=hat))
    with pytest.raises(KeyError):
        t_det.roi_features(types.SimpleNamespace(cfg=cfg), fl, fr, rl, rr)
    assert t_sra.stereo_roi_align_packed_ref(
        fl, fr, rl, rr, STRIDES, hat).shape == (B, rl.shape[1], 294, C)


def test_kron_modes_keep_the_f32_backward():
    """A kron forward differs from the f32 one by about the bf16 weight
    error, and its gradient is the f32 mode's exactly: the backward is the
    exact f32 transpose whatever the hat, as in the JAX package."""
    fl, fr, rl, rr = _inputs()
    g = torch.from_numpy(np.random.RandomState(5).randn(
        B, rl.shape[1], t_sra.ROWS, C).astype(np.float32))
    outs, grads = {}, {}
    for hat in ("f32", "kron_bf16", "kron_hilo"):
        tl, tr, trl, trr = _torch_args(fl, fr, rl, rr)
        for t in tl + tr:
            t.requires_grad_(True)
        out = t_sra.stereo_roi_align_packed(tl, tr, trl, trr, STRIDES, hat)
        out.backward(g)
        outs[hat] = out.detach()
        grads[hat] = [t.grad for t in tl + tr]
    scale = float(outs["f32"].abs().max())
    for hat in ("kron_bf16", "kron_hilo"):
        assert not torch.equal(outs[hat], outs["f32"])
        for a, b in zip(grads[hat], grads["f32"]):
            assert torch.equal(a, b)
    err_bf16 = float((outs["kron_bf16"] - outs["f32"]).abs().max())
    err_hilo = float((outs["kron_hilo"] - outs["f32"]).abs().max())
    assert err_bf16 <= 2.0 ** -7 * scale
    assert err_hilo <= 1e-4 * scale and err_hilo < err_bf16


def test_unknown_hat_raises():
    fl, fr, rl, rr = _inputs()
    with pytest.raises(KeyError):
        t_sra.stereo_roi_align_packed(*_torch_args(fl, fr, rl, rr), STRIDES,
                                      "bf16")


# ---------------------------------------------------------------------------
# K4: the atlas variant.
# ---------------------------------------------------------------------------

def test_k4_atlas_and_meta_match_jax():
    fl, _, rl, _ = _inputs()
    shapes = [f.shape[1:3] for f in fl]
    atlas, offsets = t_sra.pack_atlas([torch.from_numpy(f) for f in fl])
    meta, geom = t_sra.atlas_meta(shapes, torch.from_numpy(rl), STRIDES)
    for b in range(B):
        ref, ref_offs = _pack_atlas([jnp.asarray(f[b]) for f in fl])
        np.testing.assert_array_equal(atlas[b].numpy(), np.asarray(ref))
        assert offsets == list(ref_offs)
        meta_j, geom_j = _atlas_meta(shapes, jnp.asarray(rl[b]), STRIDES, 14)
        np.testing.assert_array_equal(meta[b].numpy(), np.asarray(meta_j))
        np.testing.assert_allclose(geom[b].numpy(), np.asarray(geom_j),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_k4_plain_matches_jax_kernel_and_k1(bf16):
    """``stereo_roi_align_atlas`` (plain on the CPU) against
    ``stereo_roi_align_pallas_atlas`` in interpret mode, image by image,
    and against K1's f32 plain version on the same inputs."""
    fl, fr, rl, rr = _inputs(jnp.bfloat16 if bf16 else np.float32, seed=1)
    args = _torch_args(fl, fr, rl, rr)
    before = t_sra.stereo_roi_align_atlas_kernel.launches
    out = t_sra.stereo_roi_align_atlas(*args, STRIDES)
    assert t_sra.stereo_roi_align_atlas_kernel.launches == before
    for b in range(B):
        ref = stereo_roi_align_pallas_atlas(
            [jnp.asarray(f[b]) for f in fl], [jnp.asarray(f[b]) for f in fr],
            jnp.asarray(rl[b]), jnp.asarray(rr[b]), STRIDES, 7, 14,
            interpret=True)
        for o, r in zip(out, ref):
            assert o.dtype == torch.float32
            np.testing.assert_allclose(o[b].numpy(), np.asarray(r), rtol=0,
                                       atol=1e-4)
    assert float(out[2][0, 0].abs().max()) == 0.0       # zero-area roi
    out7l, out7r, out14l = out
    k1 = t_sra.stereo_roi_align_packed_ref(*args, STRIDES)
    r = rl.shape[1]
    for o, rows in ((out14l, slice(0, 196)), (out7l, slice(196, 245)),
                    (out7r, slice(245, 294))):
        np.testing.assert_allclose(o.reshape(B, r, -1, C).numpy(),
                                   k1[:, :, rows].numpy(), rtol=0, atol=1e-5)
