"""The epilogue of a backbone convolution: bias, residual and ReLU in one
pass (K6, ``csrc/conv_epilogue.cu``).

``conv_epilogue(y, bias, residual, relu)`` is ``y``'s dtype of
``relu(float(y) + bias[c] + float(residual))``, the additions in that order,
over a convolution's output ``y`` ``[N, C, H, W]`` in ``torch.channels_last``
(contiguous NHWC), a float32 ``bias`` ``[C]`` and an optional ``residual``
of ``y``'s shape and layout.  The backbone calls it after each convolution
whose frozen-BN scale it folded into the weights (``models/resnet_fpn.py``),
when no gradient is taken.

It dispatches by ``ops/cuda_build.py``'s rule: eagerly on CUDA tensors
K6 writes over ``y`` through :data:`conv_epilogue_kernel` (one launch,
counted); on CPU tensors :func:`conv_epilogue_ref`, the plain version,
computes it; under ``torch.export`` or ``torch.compile``, or under a
``TorchDispatchMode``, it is the registered op
``stereo_rcnn_tpu_torch::conv_epilogue``, one graph node per call that
dispatches the same way at run time (out of place).
"""

from __future__ import annotations

import ctypes

import torch

from stereo_rcnn_tpu_torch.ops.cuda_build import CudaKernel, kernel_op

_P = ctypes.c_void_p
_I = ctypes.c_int


def conv_epilogue_ref(y: torch.Tensor, bias: torch.Tensor,
                      residual: torch.Tensor | None = None,
                      relu: bool = False) -> torch.Tensor:
    """The plain version: ``y.dtype`` of ``relu(float(y) + bias[c] +
    float(residual))``, each addition in float32, a new tensor in ``y``'s
    layout."""
    s = y.float() + bias.view(1, -1, 1, 1)
    if residual is not None:
        s = s + residual.float()
    if relu:
        s = torch.relu(s)
    return s.to(y.dtype)


class ConvEpilogueKernel(CudaKernel):
    """K6: :func:`conv_epilogue_ref` in one launch on the card."""

    source = "conv_epilogue.cu"
    symbol = "conv_epilogue"
    argtypes = [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P]

    def __init__(self):
        super().__init__()
        self._sms = {}

    def __call__(self, y, bias, residual=None, relu=False, out=None):
        """``out`` (``y`` when None: in place) for bfloat16 or float32 ``y``
        ``[N, C, H, W]`` in contiguous channels_last on a card, float32
        ``bias`` ``[C]`` and ``residual`` (or None) of ``y``'s dtype, shape
        and layout, all on ``y``'s card."""
        dev = y.device
        cl = torch.channels_last
        c = y.shape[1]
        if (y.dim() != 4 or y.dtype not in (torch.bfloat16, torch.float32)
                or not y.is_contiguous(memory_format=cl)):
            raise ValueError("y must be a bfloat16 or float32 [N, C, H, W] "
                             "tensor in contiguous channels_last, got "
                             f"{y.dtype} {list(y.shape)} strides "
                             f"{y.stride()}")
        if (bias.shape != (c,) or bias.dtype != torch.float32
                or bias.device != dev or not bias.is_contiguous()):
            raise ValueError(f"bias must be contiguous float32 [{c}] on "
                             f"{dev}, got {bias.dtype} {list(bias.shape)} "
                             f"on {bias.device}")
        for name, t in (("residual", residual), ("out", out)):
            if t is not None and (
                    t.shape != y.shape or t.dtype != y.dtype
                    or t.device != dev
                    or not t.is_contiguous(memory_format=cl)):
                raise ValueError(f"{name} must be y's dtype, shape and "
                                 f"layout on {dev}")
        out = y if out is None else out
        if y.numel() == 0:
            return out
        idx = dev.index
        sms = self._sms.get(idx)
        if sms is None:
            sms = self._sms[idx] = torch.cuda.get_device_properties(
                idx).multi_processor_count
        self.launch(dev, y.data_ptr(), bias.data_ptr(),
                    None if residual is None else residual.data_ptr(),
                    out.data_ptr(), y.numel() // c, c, int(relu),
                    int(y.dtype == torch.bfloat16), sms)
        return out


conv_epilogue_kernel = ConvEpilogueKernel()


def _plain(y, bias, residual, relu):
    # Looked up by name at each call, so that a wrapper put in its place
    # (a count of plain calls) sees every call.
    return conv_epilogue_ref(y, bias, residual, relu)


def _out_of_place(y, bias, residual, relu):
    # The registered op's CUDA kernel: an op's output may not alias its
    # inputs.
    return conv_epilogue_kernel(y, bias, residual, relu,
                                out=torch.empty_like(y))


def _fake(y, bias, residual, relu):
    return torch.empty_like(y)


_conv_epilogue = kernel_op(
    "conv_epilogue",
    "(Tensor y, Tensor bias, Tensor? residual, bool relu) -> Tensor",
    _out_of_place, _plain, _fake, eager_card=conv_epilogue_kernel)


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  residual: torch.Tensor | None = None,
                  relu: bool = False) -> torch.Tensor:
    """``y.dtype`` of ``relu(float(y) + bias[c] + float(residual))``: K6
    over ``y`` (in place) on a card, the plain version on the CPU; the
    registered op while traced or under a dispatch mode (a FLOP or byte
    counter, ``tools/roofline.py``), which then sees the call."""
    return _conv_epilogue(y, bias, residual, relu)
