"""The work counts of the yardstick: K1's and K2's bytes from shapes, and
the reference's FLOPs against the program's roofline tool."""

import dataclasses

import pytest
import torch

from h100_bench.work.roi_align_bytes import k1_bytes, k2_bytes


def test_k1_bytes_at_batch_16():
    # 1.445 GB out (the packed float32 rows) + 0.67 GB in (both sides'
    # bf16 P2..P5), 300 rois, C = 256, 1280x384: a 0.631 ms bound.
    n = k1_bytes(16, 300, 256, (384, 1280), feature_bytes=2)
    out = 16 * 300 * 294 * 256 * 4
    assert out == 1_445_068_800
    assert round((n - out) / 1e9, 2) == 0.67
    assert round(1e3 * n / 3.35e12, 3) == 0.631
    # The pipeline's bound: the output and the rois.
    assert k1_bytes(16, 300, 256, (384, 1280), levels=False) == \
        out + 2 * 16 * 300 * 16


def test_k2_bytes_at_batch_8():
    # 974 MB with one zero-area roi per image (127 valid rois a side), as
    # the kernel-alone timing had them; 977 MB with every roi valid.
    assert round(k2_bytes(8, 128, 256, (384, 1280), 8 * 127, 8 * 127)
                 / 1e6) == 974
    assert round(k2_bytes(8, 128, 256, (384, 1280)) / 1e6) == 977


def test_reference_flops_equal_the_roofline_tools():
    """The program's roofline tool and the harness count the same FLOPs
    for the whole pipeline of the tiny config."""
    pytest.importorskip("stereo_rcnn_tpu_torch")
    from stereo_rcnn_tpu_torch.tools import perf_breakdown, roofline
    from h100_bench.compare.pipeline import reference_config
    from h100_bench.reference.config import load_config
    from h100_bench.reference.inference import (broadcast_calib,
                                                make_full_pipeline)
    from h100_bench.reference.models.detector import build_model
    from h100_bench.work.flops import count_flops
    cfg_p, model_p, left, right, calib_b = perf_breakdown.setup(
        2, "pallas", True, torch.device("cpu"))
    name, fn = perf_breakdown.prefixes(cfg_p, model_p, calib_b)[-1]
    theirs, _ = roofline.count(fn, left, right)

    cfg = reference_config(load_config(
        None, overrides=dataclasses.asdict(cfg_p)))
    assert cfg.compute_dtype == "float32"
    model = build_model(cfg).eval()
    model.load_state_dict(model_p.state_dict())
    calib = broadcast_calib(tuple(v[0].numpy() for v in calib_b), 2, "cpu")
    ours, _ = count_flops(make_full_pipeline(cfg), model, left, right,
                          calib)
    assert ours == theirs > 0
