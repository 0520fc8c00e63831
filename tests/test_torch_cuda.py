"""The port's CUDA kernels against their plain PyTorch versions, on a card.

K1 in every sampling-weight mode (the tool-only two-matmul modes too), its
backward K2 (deterministic: two launches give the same bits), the windowed
RoIAlign K3 and the atlas variant K4, on the inputs of
``data.synthetic.synthetic_roi_inputs`` (which ``chip_smoke.py``'s kernel
table times too): rois of realistic sizes plus a zero-area roi, one
outside the image, one beyond it on every side and two wider than their
window.  K1 and K3 are also checked at C = 36, which is not a multiple of
8 and so takes their 2-channel lanes (C = 256 takes the 8-channel ones),
and the two lane widths must give the same bits.  K2 takes 8-channel
lanes where C % 4 == 0 and 2-channel lanes at any other even C: it is
checked at C = 34 too.  Every kernel takes an odd C through 1-channel
lanes (checked at C = 35 and 255, K2 at C = 33 and 255), which give the
bits of the wider lanes; K4 also takes a C beyond one pass of its 256
lanes x 8 channels (C = 2056).  K1 in every mode, K2, K3 and K4 are
checked at the main paths' shapes too (inference: batch 16, 300 rois;
training: batch 8, 128 rois), and K1 on a model's own backbone features.
K5, the Gauss-Newton 3D solve, against the plain loop it fuses, at the
pipeline's N = 512 and N = 32, with and without edge rows.  K6, the
backbone's convolution epilogue, bit for bit against its plain version at
the ResNet-101 sites' channel counts (16-byte lanes), at C = 255
(1-channel lanes) and at the offline call's site shapes, and its 107
launches a pipeline call of ``res101_kron``.  A warm pipeline call of
``res101_kron`` (batch 16 and 1) and a warm training step's loss forward
of ``res101_gn``'s recipe wait for the card nowhere (their constants come
from ``utils/device_constants.py``), with the bits of a fresh cache.  The
limits live in ``utils.kernel_checks``, and ``chip_smoke.py``'s kernel
table holds the kernels to them too.  Every test here carries the
``cuda`` marker and skips without a CUDA device.  The file imports no
JAX, so it runs on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from stereo_rcnn_tpu_torch.data.synthetic import (synthetic_roi_inputs,
                                                  synthetic_solve_inputs)
from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
from stereo_rcnn_tpu_torch.ops import conv_epilogue as t_epi
from stereo_rcnn_tpu_torch.ops import stereo_roi_align as t_sra
from stereo_rcnn_tpu_torch.solve import box_estimator as t_box
from stereo_rcnn_tpu_torch.utils import device_constants as dc
from stereo_rcnn_tpu_torch.utils import kernel_checks as kc

STRIDES = (4, 8, 16, 32)


def _inputs(c, dtype=torch.float32, b=2, r=300, seed=0):
    """:func:`synthetic_roi_inputs` on the card: 1280x384 level shapes;
    rois on every level (a P5 roi beyond the image on every side), a
    zero-area and an out-of-image roi, and two rois wider than their
    64-cell window."""
    return synthetic_roi_inputs(b, c, r=r, seed=seed, device="cuda",
                                dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 36, 35])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_cuda_kernel_matches_plain(dtype, c):
    """The CUDA kernel against its plain version on the card, at the main
    path's channel width (8-channel lanes), at C = 36 (2-channel lanes)
    and at C = 35 (1-channel lanes).  1e-4: both read the same features; the two differ only in
    fused multiply-adds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tl, tr, rl_t, rr_t = _inputs(c, dtype)
    before = t_sra.stereo_roi_align_kernel.launches
    out = t_sra.stereo_roi_align_packed(tl, tr, rl_t, rr_t, STRIDES)
    torch.cuda.synchronize()
    assert t_sra.stereo_roi_align_kernel.launches == before + 1
    ref = t_sra.stereo_roi_align_packed_ref(tl, tr, rl_t, rr_t, STRIDES)
    kc.close_k1(out, ref, "f32")


@pytest.mark.cuda
@pytest.mark.parametrize("hat", ["f32", "kron_bf16"])
def test_registered_op_launches_k1(hat):
    """``torch.ops.stereo_rcnn_tpu_torch.stereo_roi_align_fwd`` (the node
    an exported program holds) on CUDA tensors launches K1 once and gives
    the wrapper's bits; its result agrees with the plain version within
    the mode's tolerance (1e-4 f32, 1e-5 kron)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tl, tr, rl_t, rr_t = _inputs(256, torch.bfloat16)
    k1 = t_sra.stereo_roi_align_kernel
    before, by_hat = k1.launches, k1.launches_by_hat[hat]
    out = torch.ops.stereo_rcnn_tpu_torch.stereo_roi_align_fwd(
        tl, tr, rl_t, rr_t, list(STRIDES), hat)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert k1.launches_by_hat[hat] == by_hat + 1
    assert out.shape == (2, 300, t_sra.ROWS, 256)
    assert torch.equal(out, k1(tl, tr, rl_t, rr_t, STRIDES, hat))
    ref = t_sra.stereo_roi_align_packed_ref(tl, tr, rl_t, rr_t, STRIDES, hat)
    kc.close_k1(out, ref, hat)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 34, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_cuda_kernel_matches_plain_backward(dtype, c):
    """K2 against the plain backward on the card, and the autograd
    Function's backward launching it, with 8-channel lanes (C = 256),
    2-channel lanes (C = 34) and 1-channel lanes (C = 33).  1e-5 of each level's largest |gradient|:
    both sum the same float32 terms, K2 per gradient cell in roi, sample
    and tap order with each multiply fused into its add, the plain version
    tap by tap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tl, tr, rl_t, rr_t = _inputs(c, dtype)
    shapes = [f.shape[1:3] for f in tl]
    g = torch.randn(2, 300, t_sra.ROWS, c, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    before = t_sra.stereo_roi_align_bwd_kernel.launches
    d_l, d_r = t_sra.stereo_roi_align_bwd_kernel(g, rl_t, rr_t, shapes,
                                                 STRIDES)
    torch.cuda.synchronize()
    assert t_sra.stereo_roi_align_bwd_kernel.launches == before + 1
    r_l, r_r = t_sra.stereo_roi_align_packed_bwd_ref(g, rl_t, rr_t, shapes,
                                                     STRIDES)
    assert all(ref.abs().max().item() > 0 for ref in r_l + r_r)
    kc.close_per_level(d_l + d_r, r_l + r_r)

    for t in tl + tr:
        t.requires_grad_(True)
    out = t_sra.stereo_roi_align_packed(tl, tr, rl_t, rr_t, STRIDES)
    out.backward(g)
    torch.cuda.synchronize()
    assert t_sra.stereo_roi_align_bwd_kernel.launches == before + 2
    # In bfloat16 two float32 sums a rounding apart can round one bfloat16
    # step apart: up to 2^-7 of the level's largest |gradient|.
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for t, ref in zip(tl + tr, r_l + r_r):
        assert t.grad.dtype == dtype
        torch.testing.assert_close(t.grad.float(), ref.to(dtype).float(),
                                   atol=tol * ref.abs().max().item(), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 36, 35])
@pytest.mark.parametrize("hat", ["kron_bf16", "kron_hilo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_kron_modes_match_plain(hat, dtype, c):
    """K1 in a kron mode against its plain version (the literal dense kron
    matrix), with 8- and 2-channel lanes.  1e-5: both compute the same
    rounded weights, positions rounded once; only the float32 sums' order
    differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tl, tr, rl_t, rr_t = _inputs(c, dtype)
    before = t_sra.stereo_roi_align_kernel.launches
    out = t_sra.stereo_roi_align_packed(tl, tr, rl_t, rr_t, STRIDES, hat)
    torch.cuda.synchronize()
    assert t_sra.stereo_roi_align_kernel.launches == before + 1
    ref = t_sra.stereo_roi_align_packed_ref(tl, tr, rl_t, rr_t, STRIDES, hat)
    kc.close_k1(out, ref, hat)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 36, 35])
@pytest.mark.parametrize("hat", ["bf16", "hilo"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_two_matmul_modes_match_plain(hat, dtype, c):
    """K1 in a tool-only two-matmul mode, through the kernel-level entry,
    against its plain version, with 8- and 2-channel lanes; the public
    entry refuses the mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tl, tr, rl_t, rr_t = _inputs(c, dtype)
    k1 = t_sra.stereo_roi_align_kernel
    before = k1.launches_by_hat[hat]
    out = k1(tl, tr, rl_t, rr_t, STRIDES, hat)
    torch.cuda.synchronize()
    assert k1.launches_by_hat[hat] == before + 1
    ref = t_sra.stereo_roi_align_packed_ref(tl, tr, rl_t, rr_t, STRIDES, hat)
    kc.close_two_matmul(out, ref, tl + tr)
    assert out[0, 2].abs().max().item() == 0.0          # zero-area roi
    with pytest.raises(KeyError):
        t_sra.stereo_roi_align_packed(tl, tr, rl_t, rr_t, STRIDES, hat)


@pytest.mark.cuda
def test_k1_matches_plain_on_backbone_features():
    """K1 (f32) through ``roi_features`` on a tiny model's own backbone
    features and proposals at batch 2, against the plain version: within
    1e-4 of the largest value (the features are not unit scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from stereo_rcnn_tpu_torch.config import tiny_test_config
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
    from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
    from stereo_rcnn_tpu_torch.models.detector import (init_params,
                                                       roi_features)
    from stereo_rcnn_tpu_torch.models.stereo_rpn import select_proposals
    base = tiny_test_config()
    cfg = dataclasses.replace(base, rcnn=dataclasses.replace(
        base.rcnn, roi_align_impl="pallas", roi_align_hat="f32"))
    model = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    il, ir, _ = synthetic_images(cfg, 2, seed=5, n_objects=2)
    left, right = torch.from_numpy(il).cuda(), torch.from_numpy(ir).cuda()
    h, w = left.shape[1:3]
    k1 = t_sra.stereo_roi_align_kernel
    with torch.no_grad():
        feats = model.backbone(torch.cat([left, right]))
        fl, fr = [f[:2] for f in feats], [f[2:] for f in feats]
        props = select_proposals(
            *model.rpn(fl, fr),
            generate_anchors(cfg.anchors, h, w, cfg.box_off, "cuda"), h, w,
            cfg.rpn, False, cfg.box_off)
        before = k1.launches
        ours = roi_features(model, fl, fr, props.left, props.right)
        torch.cuda.synchronize()
        assert k1.launches == before + 1
        plain = t_sra.stereo_roi_align_packed_ref(
            fl[:4], fr[:4], props.left, props.right, cfg.anchors.strides[:4])
    assert int(props.valid.sum()) > 0
    scale = max(plain.abs().max().item(), 1.0)
    torch.testing.assert_close(ours["left_kpt_rows"].reshape(plain.shape),
                               plain, atol=1e-4 * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 34, 33])
def test_k2_is_deterministic_and_owns_each_cell(c):
    """Two K2 launches give the same bits, also when all 128 rois of an
    image are one box (every sample of every roi adds into the same
    cells), and match the plain backward within 1e-5 of each level's
    largest |gradient|; with 8- and 2-channel lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, rl, _ = _inputs(1)
    dev = torch.device("cuda")
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    rl_t = torch.cat([rl[:, :128], torch.tensor(
        [300.0, 100.0, 420.0, 190.0], device=dev).expand(2, 128, 4)])
    rr_t = rl_t - torch.tensor([17.0, 0.0, 14.0, 0.0], device=dev)
    g = torch.randn(4, 128, t_sra.ROWS, c, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    k2 = t_sra.stereo_roi_align_bwd_kernel
    first = k2(g, rl_t, rr_t, shapes, STRIDES)
    second = k2(g, rl_t, rr_t, shapes, STRIDES)
    torch.cuda.synchronize()
    ref = t_sra.stereo_roi_align_packed_bwd_ref(g, rl_t, rr_t, shapes,
                                                STRIDES)
    for a, b_ in zip(first[0] + first[1], second[0] + second[1]):
        assert torch.equal(a, b_)
    kc.close_per_level(first, ref)
    # Only the zero-area rois' rows of the cotangent: an exactly zero
    # gradient (the kernel writes every cell, zeros included).
    g0 = torch.zeros_like(g)
    g0[0, 2] = g[0, 2]
    d0_l, d0_r = k2(g0, rl_t, rr_t, shapes, STRIDES)
    assert not any(d.any() for d in d0_l + d0_r)


# The main paths' shapes (batch, rois, C): inference at batch 16 with 300
# rois, training at batch 8 with 128; and an odd C (1-channel lanes) at
# the width of the other kernels' narrow-lane checks.
PATH_SHAPES = [(16, 300, 256, torch.bfloat16), (8, 128, 256, torch.bfloat16),
               (2, 300, 255, torch.bfloat16), (2, 300, 255, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("b, r, c, dtype", PATH_SHAPES)
@pytest.mark.parametrize("hat", sorted(t_sra.TOOL_HAT_MODES))
def test_k1_every_mode_at_the_paths_shapes(hat, b, r, c, dtype):
    """K1 in every mode against its plain version at the main paths'
    shapes and at C = 255, with the mode's tolerance (1e-4 f32, 1e-5 the
    kron modes, ``kernel_checks.close_two_matmul`` the two-matmul ones);
    one launch,
    counted under its mode; the zero-area roi gives exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tl, tr, rl_t, rr_t = _inputs(c, dtype, b=b, r=r, seed=b + c)
    k1 = t_sra.stereo_roi_align_kernel
    before = k1.launches_by_hat[hat]
    out = k1(tl, tr, rl_t, rr_t, STRIDES, hat)
    torch.cuda.synchronize()
    assert k1.launches_by_hat[hat] == before + 1
    ref = t_sra.stereo_roi_align_packed_ref(tl, tr, rl_t, rr_t, STRIDES, hat)
    kc.close_k1(out, ref, hat, tl + tr)
    assert out[:, 2].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 255])
def test_k2_at_the_training_shapes(c):
    """K2 at the training step's batch 8 with 128 rois, C = 256 and 255:
    two launches, both counted, give the same bits, within 1e-5 of each
    level's largest |gradient| of the plain backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, rl_t, rr_t = _inputs(1, b=8, r=128, seed=c)
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    g = torch.randn(8, 128, t_sra.ROWS, c, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(c))
    k2 = t_sra.stereo_roi_align_bwd_kernel
    before = k2.launches
    first = k2(g, rl_t, rr_t, shapes, STRIDES)
    second = k2(g, rl_t, rr_t, shapes, STRIDES)
    torch.cuda.synchronize()
    assert k2.launches == before + 2
    ref = t_sra.stereo_roi_align_packed_bwd_ref(g, rl_t, rr_t, shapes,
                                                STRIDES)
    for a, b_ in zip(first[0] + first[1], second[0] + second[1]):
        assert torch.equal(a, b_)
    kc.close_per_level(first, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 36, 35, 255])
@pytest.mark.parametrize("p, s", [(7, 2), (14, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_cuda_kernel_matches_plain(p, s, dtype, c):
    """K3 against its plain version, batched and unbatched, with 8-, 2-
    and 1-channel lanes (C = 256; 36; 35 and 255).  1e-4, as K1: the two
    differ only in fused multiply-adds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    feats, _, rois, _ = _inputs(c, dtype)
    _check_k3(feats, rois, p, s)


@pytest.mark.cuda
@pytest.mark.parametrize("p, s", [(7, 2), (14, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_at_the_inference_shape(p, s, dtype):
    """K3 as :func:`test_k3_cuda_kernel_matches_plain` checks it, at
    batch 16 with 300 rois, C = 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    feats, _, rois, _ = _inputs(256, dtype, b=16, seed=16)
    _check_k3(feats, rois, p, s)


def _check_k3(feats, rois, p, s):
    """K3 through its entry point, batched and (image 1) unbatched: one
    launch each, within 1e-4 of its plain version; the zero-area roi is
    not zeroed (the TPU kernel samples it as a 1-cell roi)."""
    from stereo_rcnn_tpu_torch.ops import roi_align_window as t_win
    for f_, r_ in ((feats, rois), ([f[1] for f in feats], rois[1])):
        before = t_win.roi_align_window_kernel.launches
        out = t_win.multilevel_roi_align_window(f_, r_, STRIDES, p, s)
        torch.cuda.synchronize()
        assert t_win.roi_align_window_kernel.launches == before + 1
        ref = t_win.multilevel_roi_align_window_ref(f_, r_, STRIDES, p, s)
        kc.close_sampled(out, ref)
        assert out[..., 2, :, :, :].abs().max().item() > 0


def _shifted(t):
    """A copy of ``t`` whose data starts two elements past its buffer's
    start, so not on a 16-byte boundary."""
    buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=t.device)
    out = buf[2:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_width_keeps_the_bits(dtype):
    """Levels that are not 16-byte aligned take K1's and K3's 2-channel
    lanes; they give the same bits as the aligned levels' 8-channel lanes,
    in every K1 mode: a lane's width changes how many channels a thread
    handles, not what a channel computes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereo_rcnn_tpu_torch.ops import roi_align_window as t_win
    tl, tr, rl_t, rr_t = _inputs(256, dtype)
    sl, sr = [_shifted(f) for f in tl], [_shifted(f) for f in tr]
    assert all(f.data_ptr() % 16 for f in sl + sr)
    k1 = t_sra.stereo_roi_align_kernel
    for hat in t_sra.TOOL_HAT_MODES:
        assert torch.equal(k1(tl, tr, rl_t, rr_t, STRIDES, hat),
                           k1(sl, sr, rl_t, rr_t, STRIDES, hat)), hat
    for p, s in ((7, 2), (14, 1)):
        assert torch.equal(
            t_win.multilevel_roi_align_window(tl, rl_t, STRIDES, p, s),
            t_win.multilevel_roi_align_window(sl, rl_t, STRIDES, p, s))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_odd_c_lanes_keep_the_bits(dtype):
    """K1 (every mode), K3 and K4 at C = 35 (1-channel lanes) give the
    bits of the first 35 channels at C = 36 (2-channel lanes): a lane's
    width never changes what a channel computes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereo_rcnn_tpu_torch.ops import roi_align_window as t_win
    tl, tr, rl_t, rr_t = _inputs(36, dtype)
    nl = [f[..., :35].contiguous() for f in tl]
    nr = [f[..., :35].contiguous() for f in tr]
    k1 = t_sra.stereo_roi_align_kernel
    for hat in t_sra.TOOL_HAT_MODES:
        assert torch.equal(k1(tl, tr, rl_t, rr_t, STRIDES, hat)[..., :35],
                           k1(nl, nr, rl_t, rr_t, STRIDES, hat)), hat
    for p, s in ((7, 2), (14, 1)):
        assert torch.equal(
            t_win.multilevel_roi_align_window(tl, rl_t, STRIDES, p,
                                              s)[..., :35],
            t_win.multilevel_roi_align_window(nl, rl_t, STRIDES, p, s))
    wide = t_sra.stereo_roi_align_atlas(tl, tr, rl_t, rr_t, STRIDES)
    narrow = t_sra.stereo_roi_align_atlas(nl, nr, rl_t, rr_t, STRIDES)
    for a, b_ in zip(wide, narrow):
        assert torch.equal(a[..., :35], b_)


@pytest.mark.cuda
def test_k2_lane_width_keeps_the_bits():
    """K2 at C = 34 (2-channel lanes) and C = 33 (1-channel lanes) gives
    the bits of the first 34 (33) channels of K2 at C = 36 (8-channel
    lanes) on the same cotangent: a channel's terms are summed in the same
    order at every width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, rl_t, rr_t = _inputs(1)
    dev = torch.device("cuda")
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    g = torch.randn(2, 300, t_sra.ROWS, 36, device=dev,
                    generator=torch.Generator(dev).manual_seed(2))
    k2 = t_sra.stereo_roi_align_bwd_kernel
    wide = k2(g, rl_t, rr_t, shapes, STRIDES)
    for c in (34, 33):
        narrow = k2(g[..., :c].contiguous(), rl_t, rr_t, shapes, STRIDES)
        for a, b_ in zip(wide[0] + wide[1], narrow[0] + narrow[1]):
            assert torch.equal(a[..., :c], b_)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 35, 2056, 255])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_cuda_kernel_matches_plain(dtype, c):
    """K4 against its plain version, one launch for both images, and
    against K1 f32 on the same inputs, with 8-channel lanes (C = 256),
    1-channel lanes (C = 35, 255) and two passes of its lanes (C = 2056).
    1e-4, as K1: the right pool sums its taps per distinct cell, in
    another float32 order than the mean of four samples; the left side is
    K1's arithmetic.  A zero-area roi writes zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _check_k4(*_inputs(c, dtype))


@pytest.mark.cuda
def test_k4_at_the_offline_shape():
    """K4 as :func:`test_k4_cuda_kernel_matches_plain` checks it, at batch
    16 with 300 rois, C = 256, bfloat16 levels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _check_k4(*_inputs(256, torch.bfloat16, b=16, seed=16))


def _check_k4(tl, tr, rl_t, rr_t):
    c = tl[0].shape[-1]
    before = t_sra.stereo_roi_align_atlas_kernel.launches
    out = t_sra.stereo_roi_align_atlas(tl, tr, rl_t, rr_t, STRIDES)
    torch.cuda.synchronize()
    assert t_sra.stereo_roi_align_atlas_kernel.launches == before + 1
    ref = t_sra.stereo_roi_align_atlas_ref(tl, tr, rl_t, rr_t, STRIDES)
    kc.close_sampled(out, ref)
    packed = t_sra.stereo_roi_align_kernel(tl, tr, rl_t, rr_t, STRIDES)
    shapes = [(f.shape[1], f.shape[2]) for f in tl]
    atlas_l = t_sra.pack_atlas(tl)[0]
    atlas_r = t_sra.pack_atlas(tr)[0]
    out = t_sra.stereo_roi_align_atlas_kernel(atlas_l, atlas_r, shapes, rl_t,
                                              rr_t, STRIDES)
    b, r = rl_t.shape[:2]
    for o, rows in zip(out, (slice(196, 245), slice(245, 294),
                             slice(0, 196))):
        kc.close_sampled(o.reshape(b, r, -1, c), packed[:, :, rows])
    assert all(o[0, 2].abs().max().item() == 0.0 for o in out)


def _solve_inputs(n, seed):
    """:func:`synthetic_solve_inputs` with its edge rows (a yaw-0 row
    whose corners tie, a row below the z floor), on the card:
    ``(args, kwargs, well_posed)``."""
    d = {k: torch.from_numpy(v).cuda()
         for k, v in synthetic_solve_inputs(n, seed, edge_rows=True).items()}
    calib = StereoCalib(*d["calib"].T.contiguous(), None, None)
    args = (d["obs"], d["dims_hwl"], d["alpha"], d["kpt_idx"], calib)
    return args, dict(obs_weights=d["obs_weights"]), d["well_posed"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 32])
@pytest.mark.parametrize("iters", [30, 20])
@pytest.mark.parametrize("fixed", [False, True])
def test_k5_matches_the_plain_loop(n, iters, fixed):
    """K5 (one launch) against the plain loop on the card, at the
    pipeline's N = 512 (batch 16) and N = 32 (batch 1), with z free and
    fixed, at ``Config()``'s 30 iterations and the synthetic
    configurations' 20: position, yaw and residual within 1e-3 m / rad /
    px on the well-posed rows (the kernel repeats the loop's float32
    operations in its order, so the two differ at most by rounding that
    the solve damps), the same finiteness on every row.  With z fixed, row
    1's is fixed at 0.2 m, so both floor it at 0.5 m after the first step
    and keep it there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw, well = _solve_inputs(n, seed=n + iters)
    if fixed:
        z = np.random.RandomState(n).uniform(5.0, 40.0, n)
        z[1] = 0.2
        kw["fixed_z"] = torch.from_numpy(z.astype(np.float32)).cuda()
    k5 = t_box.gauss_newton_solve_kernel
    before = k5.launches
    got = t_box.solve_batch(*args, iters=iters, **kw)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    ref = t_box.solve_batch_ref(*args, iters=iters, **kw)
    kc.close_solve(got, ref, well)
    if fixed:
        assert got.position[1, 2].item() == ref.position[1, 2].item() == 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 32])
@pytest.mark.parametrize("fixed", [False, True])
def test_k5_at_the_cars_depth(n, fixed):
    """K5 against the plain loop on :func:`synthetic_solve_inputs` without
    edge rows, the re-solve's z fixed at the cars' depth + 0.3 m, at
    ``Config()``'s 30 iterations: within 1e-3 on the well-posed rows, the
    same finiteness on every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = {k: torch.from_numpy(v).cuda()
         for k, v in synthetic_solve_inputs(n, seed=n).items()}
    args = (d["obs"], d["dims_hwl"], d["alpha"], d["kpt_idx"],
            StereoCalib(*d["calib"].T.contiguous(), None, None))
    kw = dict(obs_weights=d["obs_weights"],
              fixed_z=d["depth"] + 0.3 if fixed else None)
    k5 = t_box.gauss_newton_solve_kernel
    before = k5.launches
    got = t_box.solve_batch(*args, **kw)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    ref = t_box.solve_batch_ref(*args, **kw)
    kc.close_solve(got, ref, d["well_posed"])


@pytest.mark.cuda
def test_k5_launches_twice_per_pipeline_call():
    """``make_full_pipeline`` (the tiny config on the card) launches K5
    exactly twice a call: the solve and the z-fixed re-solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereo_rcnn_tpu_torch.config import tiny_test_config
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
    from stereo_rcnn_tpu_torch.inference import (broadcast_calib,
                                                 make_full_pipeline)
    from stereo_rcnn_tpu_torch.models.detector import init_params
    cfg = tiny_test_config()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    il, ir, calib = synthetic_images(cfg, 2, seed=5, n_objects=2)
    pipe = make_full_pipeline(cfg)
    inputs = (torch.from_numpy(il).cuda(), torch.from_numpy(ir).cuda(),
              broadcast_calib(calib, 2, "cuda"))
    k5 = t_box.gauss_newton_solve_kernel
    for _ in range(2):
        before = k5.launches
        out = pipe(model, *inputs)
        torch.cuda.synchronize()
        assert k5.launches == before + 2
    assert out.position.isfinite().all()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128, 256, 512, 1024, 2048, 255])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_matches_plain_bit_for_bit(dtype, relu, residual, c):
    """K6 over a channels_last convolution output, in place, and through
    the registered op (out of place), against the plain version on the
    card: the same additions in the same order, each rounded once, so the
    same bits.  The ResNet-101 sites' C take 16-byte lanes; C = 255
    takes 1-channel lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(c)

    def draw():
        return (4 * torch.randn(3, c, 13, 21, generator=gen, device="cuda")
                ).to(dtype).contiguous(memory_format=torch.channels_last)

    y = draw()
    r = draw() if residual else None
    bias = torch.randn(c, generator=gen, device="cuda")
    ref = t_epi.conv_epilogue_ref(y, bias, r, relu)
    k6 = t_epi.conv_epilogue_kernel
    before = k6.launches
    op = torch.ops.stereo_rcnn_tpu_torch.conv_epilogue(y, bias, r, relu)
    got = t_epi.conv_epilogue(y, bias, r, relu)
    torch.cuda.synchronize()
    assert k6.launches == before + 2
    assert got.data_ptr() == y.data_ptr()
    for out in (op, got):
        assert out.dtype == dtype
        assert out.is_contiguous(memory_format=torch.channels_last)
        kc.same_bits(out, ref)


# The offline call's K6 sites (16 stereo pairs at 1280x384): the stem's
# epilogue takes no residual; each stage's last convolution does, its
# first two do not; the FPN's laterals take one and no ReLU.
K6_SITES = [((32, 64, 192, 640), False, True)] + [
    ((32, c, h, w), residual, True)
    for c, h, w in ((256, 96, 320), (512, 48, 160), (1024, 24, 80),
                    (2048, 12, 40)) for residual in (False, True)] + [
    ((32, 256, 96, 320), True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,residual,relu", K6_SITES)
def test_k6_matches_plain_at_the_offline_sites(shape, residual, relu):
    """K6 at the offline call's site shapes (the stem, C2 to C5, an FPN
    lateral), where the grid is capped at a full card and each thread
    walks many grid strides with its bias in registers: the plain
    version's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(shape[1])

    def draw():
        return (4 * torch.randn(shape, generator=gen, device="cuda")).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    y = draw()
    r = draw() if residual else None
    bias = torch.randn(shape[1], generator=gen, device="cuda")
    ref = t_epi.conv_epilogue_ref(y, bias, r, relu)
    got = t_epi.conv_epilogue(y, bias, r, relu)
    kc.same_bits(got, ref)


@pytest.mark.cuda
def test_k6_launches_107_per_pipeline_call():
    """One ``make_full_pipeline`` call of the ``res101_kron``
    configuration (ResNet-101 + FPN, frozen BN, bf16) at batch 1 launches
    K6 107 times: the stem, 33 bottlenecks x 3 and the FPN's 7
    convolutions; the folded weights are built once over two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
    from stereo_rcnn_tpu_torch.inference import (broadcast_calib,
                                                 make_full_pipeline)
    from stereo_rcnn_tpu_torch.models.detector import init_params
    cfg = _res101_kron()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    model.eval()
    il, ir, calib = synthetic_images(cfg, 1, seed=5, n_objects=2)
    pipe = make_full_pipeline(cfg)
    inputs = (torch.from_numpy(il).cuda(), torch.from_numpy(ir).cuda(),
              broadcast_calib(calib, 1, "cuda"))
    k6 = t_epi.conv_epilogue_kernel
    for _ in range(2):
        before = k6.launches
        pipe(model, *inputs)
        torch.cuda.synchronize()
        assert k6.launches == before + 107
    assert model.backbone_net.fold_builds == 1


def _res101_kron():
    """The benchmark's ``res101_kron`` configuration."""
    import json
    import os

    from stereo_rcnn_tpu_torch.config import load_config
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "h100_bench", "configs", "res101_kron.json")
    with open(path) as f:
        return load_config(None, overrides=json.load(f)["config"])


def _without_waits(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any wait
    for the card (a copy from pageable host memory, a read of a value)
    raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _builds(counts):
    return {k: c.builds for k, c in counts.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16, 1])
def test_warm_pipeline_call_does_not_wait_for_the_card(b):
    """``make_full_pipeline(cfg, calib)`` of ``res101_kron`` at the
    offline and the stream batch: a first call with an empty constant
    cache builds the anchors, ``mean_dims``, ``stds``, the content extent,
    the calibration batch and the level tables; the next call copies
    nothing from the host, waits for nothing, builds nothing, and gives
    the first call's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
    from stereo_rcnn_tpu_torch.inference import make_full_pipeline
    from stereo_rcnn_tpu_torch.models.detector import init_params
    cfg = _res101_kron()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    il, ir, calib = synthetic_images(cfg, b, seed=5, n_objects=2)
    left, right = torch.from_numpy(il).cuda(), torch.from_numpy(ir).cuda()
    pipe = make_full_pipeline(cfg, calib)
    dc.clear()
    fresh = pipe(model, left, right)
    built = dc.counts()
    warm = _without_waits(lambda: pipe(model, left, right))
    after = dc.counts()
    assert _builds(after) == _builds(built)
    hits = {k: after[k].hits - built[k].hits for k in after}
    assert {k: hits[k] for k in ("anchors", "mean_dims", "stds",
                                 "content_wh", "calib")} == {
        "anchors": 1, "mean_dims": 1, "stds": 1, "content_wh": 1,
        "calib": 7}
    assert hits["level_table"] > 0
    kc.same_bits(warm, fresh)


@pytest.mark.cuda
def test_warm_training_losses_do_not_wait_for_the_card():
    """One training step of ``res101_gn``'s recipe
    (``synthetic_fullres_config()``) at batch 2, then the loss forward of
    the next (the backbone, ``train/targets`` with its anchors, ``stds``
    and ``mean_dims``, the RPN, K1 and the heads): it waits for nothing,
    builds nothing, and gives the bits of the same forward with a fresh
    constant cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereo_rcnn_tpu_torch.config import synthetic_fullres_config
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
    from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                             make_train_step)
    from stereo_rcnn_tpu_torch.train.step import compute_losses
    from stereo_rcnn_tpu_torch.train.targets import ground_truth_to_torch
    cfg = synthetic_fullres_config()
    il, ir, gt, _ = synthetic_batch(cfg, 2, seed=7, n_objects=5)
    batch = Batch(torch.from_numpy(il).cuda(), torch.from_numpy(ir).cuda(),
                  ground_truth_to_torch(gt, "cuda"))
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    make_train_step(cfg, device="cuda")(
        state, batch, torch.Generator(device="cuda").manual_seed(0))

    def losses():
        return compute_losses(state.model, batch, cfg, torch.Generator(
            device="cuda").manual_seed(1))

    built = dc.counts()
    warm = _without_waits(losses)
    after = dc.counts()
    assert _builds(after) == _builds(built)
    for kind in ("anchors", "mean_dims", "stds"):
        assert after[kind].hits == built[kind].hits + 1, kind
    dc.clear()
    fresh = losses()
    assert warm.keys() == fresh.keys()
    kc.same_bits([warm[k] for k in sorted(warm)],
                 [fresh[k] for k in sorted(fresh)])
