"""The numeric precision the reference computes in.

Every convolution and matrix product of the reference runs in float32
with TF32 off (:func:`float32`).  :func:`lowered` runs it one precision
step below what the measured configuration states, as the control of the
correctness check: the operands of every convolution and linear layer
(bf16 in the configuration) rounded to float8 e4m3 (one scale per
tensor, its largest magnitude mapped to the format's largest value); the
other float32 matrix products in TF32; and the float32 stages that are
no matrix products (the 3D solve and the dense alignment) fed their
inputs rounded to bfloat16 (:func:`stage_input`).

Both are context managers that put back the process's TF32 settings on
exit, so the program never runs under a setting the reference chose.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0          # float8 e4m3
_STATE = {"fp8": False}


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    scale = (x.abs().amax().float() / largest).clamp(min=1e-30)
    return (x / scale).to(dtype).to(x.dtype) * scale


@contextlib.contextmanager
def _tf32(allow: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def float32():
    """The reference's own precision: float32 products, TF32 off."""
    return _tf32(False)


def operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a convolution or linear layer takes it: unchanged, or
    rounded to float8 e4m3 under :func:`lowered`."""
    if not _STATE["fp8"]:
        return x
    q = _round(x.detach(), torch.float8_e4m3fn, FP8_MAX)
    return x + (q - x).detach()


def stage_input(x: torch.Tensor) -> torch.Tensor:
    """A float32 input of the 3D stages: unchanged, or rounded to
    bfloat16 under :func:`lowered`."""
    if not _STATE["fp8"] or not x.is_floating_point():
        return x
    return x.to(torch.bfloat16).to(x.dtype)


@contextlib.contextmanager
def lowered():
    """The control's precision, one step below the configuration's."""
    _STATE["fp8"] = True
    try:
        with _tf32(True):
            yield
    finally:
        _STATE["fp8"] = False
