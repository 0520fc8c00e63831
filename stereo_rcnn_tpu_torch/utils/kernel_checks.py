"""The limits within which each hand-written CUDA kernel (K1-K6) must match
its plain PyTorch version, kept in one place: the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py``'s kernel table hold
the kernels to them.  Each check raises ``AssertionError`` when a kernel's
output misses its limit.  An output is a tensor or nested sequences of
tensors (:func:`tensors`), compared in order with the plain version's."""

from __future__ import annotations

import torch

# K1 with float32 weights, K3 and K4: both read the same features and differ
# only in fused multiply-adds and the float32 order of a few sums.
TOL_SAMPLED = 1e-4
# K1's kron modes: both compute the same rounded weights, positions rounded
# once; only the float32 sums' order differs.
TOL_KRON = 1e-5
# K2, relative to each level's largest |gradient|: both sum the same float32
# terms, K2 per gradient cell with each multiply fused into its add.
TOL_GRAD = 1e-5
# K5 on the well-posed rows (m, rad, px): the kernel repeats the loop's
# float32 operations in its order, so the two differ at most by rounding
# that the solve damps.
TOL_SOLVE = 1e-3
# K1's two-matmul modes: every value within this share of the largest
# |feature|, and at most OFF_ROWS of the rows beyond TOL_KRON.
TOL_TWO_MATMUL = 2.0 ** -6
OFF_ROWS = 0.001


def tensors(out):
    """The tensors of a kernel's output (a tensor, or nested sequences)."""
    if isinstance(out, torch.Tensor):
        yield out
    else:
        for x in out:
            yield from tensors(x)


def close(out, ref, atol: float):
    """Every tensor of ``out`` within ``atol`` of ``ref``'s."""
    for a, b in zip(tensors(out), tensors(ref), strict=True):
        torch.testing.assert_close(a, b, atol=atol, rtol=0)


def close_sampled(out, ref):
    """K1 (float32 weights), K3 or K4: within :data:`TOL_SAMPLED`."""
    close(out, ref, TOL_SAMPLED)


def close_k1(out, ref, hat: str, feats=None):
    """K1 in mode ``hat``: :data:`TOL_SAMPLED` with float32 weights,
    :data:`TOL_KRON` in the kron modes, :func:`close_two_matmul` in the
    two-matmul modes (which need the levels ``feats``)."""
    if hat in ("bf16", "hilo"):
        close_two_matmul(out, ref, feats)
    else:
        close(out, ref, TOL_SAMPLED if hat == "f32" else TOL_KRON)


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
    assert diff.max().item() <= TOL_TWO_MATMUL * scale, diff.max().item()
    off = (diff.amax(-1) > TOL_KRON).float().mean().item()
    assert off <= OFF_ROWS, f"{off:.3%} of the rows beyond {TOL_KRON}"


def close_per_level(outs, refs, rel: float = TOL_GRAD):
    """K2: each level's gradient within ``rel`` of its plain version's
    largest |value|."""
    for a, b in zip(tensors(outs), tensors(refs), strict=True):
        torch.testing.assert_close(a, b, atol=rel * b.abs().max().item(),
                                   rtol=0)


def close_solve(got, ref, well):
    """K5's ``(position, theta, residual)``: the same finiteness on every
    row, within :data:`TOL_SOLVE` on the well-posed rows ``well``."""
    for name, a, b in zip(("position", "theta", "residual"), got, ref,
                          strict=True):
        assert torch.equal(a.isfinite(), b.isfinite()), name
        torch.testing.assert_close(a[well], b[well], atol=TOL_SOLVE, rtol=0)


def same_bits(out, ref):
    """K6: the plain version's bits, tensor for tensor."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    for a, b in zip(tensors(out), tensors(ref), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape,
                                                           b.dtype, b.shape)
        bits = ints[a.element_size()]
        assert torch.equal(a.view(bits), b.view(bits)), "bits differ"
