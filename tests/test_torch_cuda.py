"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device.  The file imports no JAX, so it runs on a machine without it:
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_cuda_kernel_matches_plain(dtype):
    """The CUDA kernel against its plain version on the card, at the main
    path's channel width.  1e-4: both read the same features; the two
    differ only in fused multiply-adds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fl, fr, rl, rr = _k1_inputs(256)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_cuda_kernel_matches_plain_backward(dtype):
    """K2 against the plain backward on the card, and the autograd
    Function's backward launching it.  1e-5 of each level's largest
    |gradient|: both sum the same float32 terms, K2 with atomics in an
    order that changes from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fl, fr, rl, rr = _k1_inputs(256)
    dev = torch.device("cuda")
    shapes = [f.shape[1:3] for f in fl]
    rl_t, rr_t = torch.from_numpy(rl).to(dev), torch.from_numpy(rr).to(dev)
    g = torch.randn(rl.shape[0], rl.shape[1], t_sra.ROWS, 256, device=dev,
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
