"""The port's CUDA kernels against their plain PyTorch versions, on a card.

K1 in every sampling-weight mode (the tool-only two-matmul modes too), its
backward K2 (deterministic: two launches give the same bits), the windowed
RoIAlign K3 and the atlas variant K4.  K1 and K3 are also checked at C = 36,
which is not a multiple of 8 and so takes their 2-channel lanes (C = 256
takes the 8-channel ones), and the two lane widths must give the same bits.
K2 takes 8-channel lanes where C % 4 == 0 and 2-channel lanes at any other
even C: it is checked at C = 34 too.  Every kernel takes an odd C through
1-channel lanes (checked at C = 35, K2 at C = 33), which give the bits of
the wider lanes; K4 also takes a C beyond one pass of its 256 lanes x 8
channels (C = 2056).
Every test here carries the ``cuda`` marker and skips without a CUDA
device.  The file imports no JAX, so it runs on
a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from stereo_rcnn_tpu_torch.ops import stereo_roi_align as t_sra

STRIDES = (4, 8, 16, 32)


def _k1_inputs(c, b=2, seed=0):
    """1280x384 level shapes; rois on every level (a P5 roi beyond the
    image on every side), a zero-area and an out-of-image roi, and two
    rois wider than their 64-cell window."""
    rng = np.random.RandomState(seed)
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    fl = [rng.randn(b, h, w, c).astype(np.float32) for h, w in shapes]
    fr = [rng.randn(b, h, w, c).astype(np.float32) for h, w in shapes]
    xy = rng.uniform(-20, [1280, 384], size=(300, 2))
    wh = rng.uniform(1, [400, 200], size=(300, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:5] = [[100, 100, 400, 140], [50, 100, 1250, 200],
                [10, 10, 10, 10], [1400, 500, 1500, 600],
                [-100, -80, 1400, 500]]
    rl = np.stack([rois, rois[::-1]])
    rr = rl - np.float32([17, 0, 14, 0])
    return fl, fr, rl, rr


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
    fl, fr, rl, rr = _k1_inputs(c)
    dev = torch.device("cuda")
    tl = [torch.from_numpy(f).to(dev, dtype) for f in fl]
    tr = [torch.from_numpy(f).to(dev, dtype) for f in fr]
    rl_t, rr_t = torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev)
    before = t_sra.stereo_roi_align_kernel.launches
    out = t_sra.stereo_roi_align_packed(tl, tr, rl_t, rr_t, STRIDES)
    torch.cuda.synchronize()
    assert t_sra.stereo_roi_align_kernel.launches == before + 1
    ref = t_sra.stereo_roi_align_packed_ref(tl, tr, rl_t, rr_t, STRIDES)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hat", ["f32", "kron_bf16"])
def test_registered_op_launches_k1(hat):
    """``torch.ops.stereo_rcnn_tpu_torch.stereo_roi_align_fwd`` (the node
    an exported program holds) on CUDA tensors launches K1 once and gives
    the wrapper's bits; its result agrees with the plain version within
    the mode's tolerance (1e-4 f32, 1e-5 kron)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fl, fr, rl, rr = _k1_inputs(256)
    dev = torch.device("cuda")
    tl = [torch.from_numpy(f).to(dev, torch.bfloat16) for f in fl]
    tr = [torch.from_numpy(f).to(dev, torch.bfloat16) for f in fr]
    rl_t, rr_t = torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev)
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
    torch.testing.assert_close(out, ref, atol=1e-4 if hat == "f32" else 1e-5,
                               rtol=0)


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
    fl, fr, rl, rr = _k1_inputs(c)
    dev = torch.device("cuda")
    shapes = [f.shape[1:3] for f in fl]
    rl_t, rr_t = torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev)
    g = torch.randn(rl.shape[0], rl.shape[1], t_sra.ROWS, c, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    before = t_sra.stereo_roi_align_bwd_kernel.launches
    d_l, d_r = t_sra.stereo_roi_align_bwd_kernel(g, rl_t, rr_t, shapes,
                                                 STRIDES)
    torch.cuda.synchronize()
    assert t_sra.stereo_roi_align_bwd_kernel.launches == before + 1
    r_l, r_r = t_sra.stereo_roi_align_packed_bwd_ref(g, rl_t, rr_t, shapes,
                                                     STRIDES)
    for ours, ref in zip(d_l + d_r, r_l + r_r):
        scale = ref.abs().max().item()
        assert scale > 0
        torch.testing.assert_close(ours, ref, atol=1e-5 * scale, rtol=0)

    tl = [torch.from_numpy(f).to(dev, dtype).requires_grad_(True)
          for f in fl]
    tr = [torch.from_numpy(f).to(dev, dtype).requires_grad_(True)
          for f in fr]
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
    fl, fr, rl, rr = _k1_inputs(c)
    dev = torch.device("cuda")
    tl = [torch.from_numpy(f).to(dev, dtype) for f in fl]
    tr = [torch.from_numpy(f).to(dev, dtype) for f in fr]
    rl_t, rr_t = torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev)
    before = t_sra.stereo_roi_align_kernel.launches
    out = t_sra.stereo_roi_align_packed(tl, tr, rl_t, rr_t, STRIDES, hat)
    torch.cuda.synchronize()
    assert t_sra.stereo_roi_align_kernel.launches == before + 1
    ref = t_sra.stereo_roi_align_packed_ref(tl, tr, rl_t, rr_t, STRIDES, hat)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def close_two_matmul(out, ref, feats):
    """K1's two-matmul modes against their plain version: the same rounded
    hats, but the plain version's y-pass is a cuBLAS product whose float32
    sums may run in another order; a bf16 intermediate one rounding from a
    bf16 boundary then moves by a bf16 step, at most 2^-7 of the largest
    |feature| (the x-hats sum to 1).  So every value within 2^-6 of it, and
    all but 0.1 % of the 294-row blocks' rows within 1e-5 (0.011 % measured
    on an H100)."""
    scale = max(f.abs().max().item() for f in feats)
    diff = (out - ref).abs()
    assert diff.max().item() <= 2.0 ** -6 * scale, diff.max().item()
    off = (diff.amax(-1) > 1e-5).float().mean().item()
    assert off <= 0.001, f"{off:.3%} of the rows beyond 1e-5"


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
    fl, fr, rl, rr = _k1_inputs(c)
    dev = torch.device("cuda")
    tl = [torch.from_numpy(f).to(dev, dtype) for f in fl]
    tr = [torch.from_numpy(f).to(dev, dtype) for f in fr]
    rl_t, rr_t = torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev)
    k1 = t_sra.stereo_roi_align_kernel
    before = k1.launches_by_hat[hat]
    out = k1(tl, tr, rl_t, rr_t, STRIDES, hat)
    torch.cuda.synchronize()
    assert k1.launches_by_hat[hat] == before + 1
    ref = t_sra.stereo_roi_align_packed_ref(tl, tr, rl_t, rr_t, STRIDES, hat)
    close_two_matmul(out, ref, tl + tr)
    assert out[0, 2].abs().max().item() == 0.0          # zero-area roi
    with pytest.raises(KeyError):
        t_sra.stereo_roi_align_packed(tl, tr, rl_t, rr_t, STRIDES, hat)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 34, 33])
def test_k2_is_deterministic_and_owns_each_cell(c):
    """Two K2 launches give the same bits, also when all 128 rois of an
    image are one box (every sample of every roi adds into the same
    cells), and match the plain backward within 1e-5 of each level's
    largest |gradient|; with 8- and 2-channel lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, rl, rr = _k1_inputs(256)
    dev = torch.device("cuda")
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    rl = np.concatenate([rl[:, :128], np.tile(
        np.float32([[[300, 100, 420, 190]]]), (2, 128, 1))])
    rr = rl - np.float32([17, 0, 14, 0])
    rl_t, rr_t = torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev)
    g = torch.randn(4, 128, t_sra.ROWS, c, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    k2 = t_sra.stereo_roi_align_bwd_kernel
    first = k2(g, rl_t, rr_t, shapes, STRIDES)
    second = k2(g, rl_t, rr_t, shapes, STRIDES)
    torch.cuda.synchronize()
    ref = t_sra.stereo_roi_align_packed_bwd_ref(g, rl_t, rr_t, shapes,
                                                STRIDES)
    for a, b_, r in zip(first[0] + first[1], second[0] + second[1],
                        ref[0] + ref[1]):
        assert torch.equal(a, b_)
        torch.testing.assert_close(a, r, atol=1e-5 * r.abs().max().item(),
                                   rtol=0)
    # Only the zero-area rois' rows of the cotangent: an exactly zero
    # gradient (the kernel writes every cell, zeros included).
    g0 = torch.zeros_like(g)
    g0[0, 2] = g[0, 2]
    d0_l, d0_r = k2(g0, rl_t, rr_t, shapes, STRIDES)
    assert not any(d.any() for d in d0_l + d0_r)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 36, 35])
@pytest.mark.parametrize("p, s", [(7, 2), (14, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_cuda_kernel_matches_plain(p, s, dtype, c):
    """K3 against its plain version, batched and unbatched, with 8- and
    2-channel lanes.  1e-4, as K1: the two differ only in fused
    multiply-adds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereo_rcnn_tpu_torch.ops import roi_align_window as t_win
    fl, _, rl, _ = _k1_inputs(c)
    dev = torch.device("cuda")
    feats = [torch.from_numpy(f).to(dev, dtype) for f in fl]
    rois = torch.from_numpy(rl).to(dev)
    for f_, r_ in ((feats, rois), ([f[1] for f in feats], rois[1])):
        before = t_win.roi_align_window_kernel.launches
        out = t_win.multilevel_roi_align_window(f_, r_, STRIDES, p, s)
        torch.cuda.synchronize()
        assert t_win.roi_align_window_kernel.launches == before + 1
        ref = t_win.multilevel_roi_align_window_ref(f_, r_, STRIDES, p, s)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


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
    fl, fr, rl, rr = _k1_inputs(256)
    dev = torch.device("cuda")
    tl = [torch.from_numpy(f).to(dev, dtype) for f in fl]
    tr = [torch.from_numpy(f).to(dev, dtype) for f in fr]
    sl, sr = [_shifted(f) for f in tl], [_shifted(f) for f in tr]
    assert all(f.data_ptr() % 16 for f in sl + sr)
    rl_t, rr_t = torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev)
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
    fl, fr, rl, rr = _k1_inputs(36)
    dev = torch.device("cuda")
    tl = [torch.from_numpy(f).to(dev, dtype) for f in fl]
    tr = [torch.from_numpy(f).to(dev, dtype) for f in fr]
    nl = [f[..., :35].contiguous() for f in tl]
    nr = [f[..., :35].contiguous() for f in tr]
    rl_t, rr_t = torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev)
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
    _, _, rl, rr = _k1_inputs(256)
    dev = torch.device("cuda")
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    rl_t, rr_t = torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev)
    g = torch.randn(2, rl.shape[1], t_sra.ROWS, 36, device=dev,
                    generator=torch.Generator(dev).manual_seed(2))
    k2 = t_sra.stereo_roi_align_bwd_kernel
    wide = k2(g, rl_t, rr_t, shapes, STRIDES)
    for c in (34, 33):
        narrow = k2(g[..., :c].contiguous(), rl_t, rr_t, shapes, STRIDES)
        for a, b_ in zip(wide[0] + wide[1], narrow[0] + narrow[1]):
            assert torch.equal(a[..., :c], b_)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 35, 2056])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_cuda_kernel_matches_plain(dtype, c):
    """K4 against its plain version, one launch for both images, and
    against K1 f32 on the same inputs, with 8-channel lanes (C = 256),
    1-channel lanes (C = 35) and two passes of its lanes (C = 2056).
    1e-4, as K1: the right pool sums its taps per distinct cell, in
    another float32 order than the mean of four samples; the left side is
    K1's arithmetic.  A zero-area roi writes zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fl, fr, rl, rr = _k1_inputs(c)
    dev = torch.device("cuda")
    tl = [torch.from_numpy(f).to(dev, dtype) for f in fl]
    tr = [torch.from_numpy(f).to(dev, dtype) for f in fr]
    rl_t, rr_t = torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev)
    before = t_sra.stereo_roi_align_atlas_kernel.launches
    out = t_sra.stereo_roi_align_atlas(tl, tr, rl_t, rr_t, STRIDES)
    torch.cuda.synchronize()
    assert t_sra.stereo_roi_align_atlas_kernel.launches == before + 1
    ref = t_sra.stereo_roi_align_atlas_ref(tl, tr, rl_t, rr_t, STRIDES)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, atol=1e-4, rtol=0)
    packed = t_sra.stereo_roi_align_kernel(tl, tr, rl_t, rr_t, STRIDES)
    shapes = [(f.shape[1], f.shape[2]) for f in tl]
    atlas_l = t_sra.pack_atlas(tl)[0]
    atlas_r = t_sra.pack_atlas(tr)[0]
    out = t_sra.stereo_roi_align_atlas_kernel(atlas_l, atlas_r, shapes, rl_t,
                                              rr_t, STRIDES)
    b, r = rl.shape[:2]
    for o, rows in zip(out, (slice(196, 245), slice(245, 294),
                             slice(0, 196))):
        torch.testing.assert_close(o.reshape(b, r, -1, c),
                                   packed[:, :, rows], atol=1e-4, rtol=0)
    assert all(o[0, 2].abs().max().item() == 0.0 for o in out)
