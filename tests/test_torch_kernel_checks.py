"""The limits of ``utils.kernel_checks``, on the CPU: each check accepts a
plain version's output against itself and refuses it moved just beyond
the check's limit.  The plain versions run at a small C on the card
builders' inputs (``data.synthetic``); the card tests and
``chip_smoke.py`` hold the CUDA kernels to the same checks."""

import pytest
import torch

from stereo_rcnn_tpu_torch.data.synthetic import (synthetic_roi_inputs,
                                                  synthetic_solve_inputs)
from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
from stereo_rcnn_tpu_torch.ops import conv_epilogue as ce
from stereo_rcnn_tpu_torch.ops import roi_align_window as win
from stereo_rcnn_tpu_torch.ops import stereo_roi_align as sra
from stereo_rcnn_tpu_torch.solve import box_estimator as be
from stereo_rcnn_tpu_torch.utils import kernel_checks as kc
from tests.torch_threads import one_torch_thread  # noqa: F401

STRIDES = (4, 8, 16, 32)


def _roi_inputs():
    return synthetic_roi_inputs(1, 4, r=8, seed=3)


def _k1(hat):
    fl, fr, rl, rr = _roi_inputs()
    ref = sra.stereo_roi_align_packed_ref(fl, fr, rl, rr, STRIDES, hat)
    scale = max(f.abs().max().item() for f in fl + fr)
    limit = {"f32": kc.TOL_SAMPLED, "kron_bf16": kc.TOL_KRON,
             "kron_hilo": kc.TOL_KRON}.get(hat, kc.TOL_TWO_MATMUL * scale)
    return (lambda out, r: kc.close_k1(out, r, hat, fl + fr)), ref, limit


def _k2():
    _, _, rl, rr = _roi_inputs()
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    g = torch.randn(1, 8, sra.ROWS, 4,
                    generator=torch.Generator().manual_seed(0))
    ref = sra.stereo_roi_align_packed_bwd_ref(g, rl, rr, shapes, STRIDES)
    first = next(kc.tensors(ref))
    return kc.close_per_level, ref, kc.TOL_GRAD * first.abs().max().item()


def _k3():
    fl, _, rl, _ = _roi_inputs()
    return (kc.close_sampled,
            win.multilevel_roi_align_window_ref(fl, rl, STRIDES, 7, 2),
            kc.TOL_SAMPLED)


def _k4():
    return (kc.close_sampled,
            sra.stereo_roi_align_atlas_ref(*_roi_inputs(), STRIDES),
            kc.TOL_SAMPLED)


def _k5():
    d = {k: torch.from_numpy(v)
         for k, v in synthetic_solve_inputs(32, seed=1).items()}
    ref = be.solve_batch_ref(d["obs"], d["dims_hwl"], d["alpha"],
                             d["kpt_idx"],
                             StereoCalib(*d["calib"].T, None, None),
                             d["obs_weights"])
    assert d["well_posed"][0]
    return ((lambda out, r: kc.close_solve(out, r, d["well_posed"])),
            ref, kc.TOL_SOLVE)


def _k6():
    gen = torch.Generator().manual_seed(6)
    y, r = [torch.randn(2, 8, 3, 5, generator=gen).to(torch.bfloat16)
            for _ in range(2)]
    ref = ce.conv_epilogue_ref(y, torch.randn(8, generator=gen), r, True)
    return kc.same_bits, ref, 0.0


CASES = {**{f"K1 {hat}": (lambda hat=hat: _k1(hat))
            for hat in sorted(sra.TOOL_HAT_MODES)},
         "K2": _k2, "K3": _k3, "K4": _k4, "K5": _k5, "K6": _k6}


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_each_check_holds_its_limit(kernel):
    check, ref, limit = CASES[kernel]()
    twin = (ref.clone() if isinstance(ref, torch.Tensor)
            else [t.clone() for t in kc.tensors(ref)])
    check(twin, ref)
    # The first value of the first tensor moved beyond the limit (K6, a
    # bf16 output: by one step of its last bit).
    first = next(kc.tensors(twin))
    at = (0,) * first.dim()
    if limit:
        first[at] += 2 * limit
    else:
        first.view(torch.int16)[at] ^= 1
    with pytest.raises(AssertionError):
        check(twin, ref)
