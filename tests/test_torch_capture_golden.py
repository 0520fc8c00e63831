"""The port's golden capture (``tools/capture_golden.py``) against the JAX
package, on the CPU, in float32.

A random tiny frozen-BN model of the port, with
``tests/test_torch_pipeline.py``'s output scalings (saturated scores,
O(0.5) box deltas), is written as a ``.pth`` in the released upstream
names (``convert.stereo_import.upstream_state_dict``).  ``capture()`` takes it
through the port's JAX-free import; the JAX side takes the same state
dict through its ``import_detector`` + ``merge_params`` and runs its
``make_full_pipeline`` on the same letterboxed pair, in both
``kpt_softmax`` modes.  The arrays must be the JAX tool's keys (read from
its ``np.savez`` call) and agree: validity exactly, boxes, dims, angles
and keypoints 1e-3, scores and keypoint peaks 1e-4, and positions 1e-2 m
wherever the JAX solve is stable (``tests/test_torch_pipeline.py``'s
rule).  ``main()`` writes the same arrays to its ``.npz``.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu import inference as j_inf
from stereo_rcnn_tpu.config import tiny_test_config as j_tiny
from stereo_rcnn_tpu.convert.stereo_import import (import_detector,
                                                   merge_params)
from stereo_rcnn_tpu.models import detector as j_det
from stereo_rcnn_tpu.utils.host_preproc import resize_subtract_pad
from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.convert.stereo_import import upstream_state_dict
from stereo_rcnn_tpu_torch.data.synthetic import (random_scene, render_pair,
                                                  write_kitti_frame)
from stereo_rcnn_tpu_torch.geometry.calib import default_kitti_calib
from stereo_rcnn_tpu_torch.models.detector import init_params
from stereo_rcnn_tpu_torch.tools import capture_golden
from tests.test_torch_pipeline import (BOX_SCALE, CLS_SCALE, RPN_BOX_SCALE,
                                       RPN_SCALE)
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(base):
    return dataclasses.replace(
        base, compute_dtype="float32",
        backbone=dataclasses.replace(base.backbone, norm="frozen"))


def _jax_tool_keys():
    """The keyword names of the JAX tool's ``np.savez`` call."""
    with open(os.path.join(REPO, "tools", "capture_golden.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and
                isinstance(node.func, ast.Attribute) and
                node.func.attr == "savez"):
            return tuple(k.arg for k in node.keywords)
    raise AssertionError("no np.savez call in tools/capture_golden.py")


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("golden"))
    cfg = _cfg(tiny_test_config())
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        model.rcnn_head.RCNN_cls_score.weight *= CLS_SCALE
        model.RCNN_rpn.RPN_cls_score.weight *= RPN_SCALE
        model.RCNN_rpn.RPN_bbox_pred.weight *= RPN_BOX_SCALE
        model.rcnn_head.RCNN_bbox_pred.weight *= BOX_SCALE
    pth = os.path.join(work, "upstream.pth")
    torch.save({"model": upstream_state_dict(model), "epoch": 12,
                "pooling_mode": "align"}, pth)
    calib = default_kitti_calib()
    rng = np.random.RandomState(3)
    objs = random_scene(rng, 3, calib, 375, 1242)
    left, right = render_pair(objs, calib, 375, 1242, rng)
    write_kitti_frame(work, "000000", objs, calib, left, right)
    imgs = [np.clip(x, 0, 255).astype(np.uint8) for x in (left, right)]
    sd, extras = capture_golden.load_state_dict(pth)
    assert sorted(extras) == ["epoch", "pooling_mode"]
    arrays = capture_golden.capture(cfg, sd, *imgs, calib, "cpu")
    return dict(cfg=cfg, sd=sd, imgs=imgs, calib=calib, arrays=arrays,
                work=work, pth=pth)


def _jax_golden(golden):
    """The JAX tool's arrays for the same state dict and pair."""
    cfg_j = _cfg(j_tiny())
    converted, _ = import_detector(golden["sd"], depth=cfg_j.backbone.depth,
                                   pool=cfg_j.rcnn.pooling_size,
                                   fpn_dim=cfg_j.backbone.fpn_dim)
    params = j_det.init_params(cfg_j, jax.random.PRNGKey(0))
    params = {"params": merge_params(params, converted)["params"]}
    th, tw = cfg_j.data.image_h, cfg_j.data.image_w
    sh, sw = golden["imgs"][0].shape[:2]
    scale = min(th / sh, tw / sw)
    il, ir = (jnp.asarray(resize_subtract_pad(
        img, th, tw, scale, cfg_j.backbone.pixel_means_bgr)[None])
        for img in golden["imgs"])
    calib = golden["calib"].scale(scale)
    outs = {}
    for mode in ("joint", "per_channel"):
        mcfg = cfg_j.replace(rcnn=dataclasses.replace(cfg_j.rcnn,
                                                      kpt_softmax=mode))
        outs[mode] = jax.jit(j_inf.make_full_pipeline(mcfg, calib))(
            params, il, ir)
    out = outs[cfg_j.rcnn.kpt_softmax]
    solve = jax.jit(lambda d_: j_inf.solve_and_align(
        d_, il, ir, j_inf.broadcast_calib(calib, 1), cfg_j))
    move = 0.0
    for eps in (1e-5, -1e-5):
        shifted = solve(out.det._replace(box_left=out.det.box_left + eps,
                                         box_right=out.det.box_right - eps))
        move = np.maximum(move, np.abs(np.asarray(shifted.position) -
                                       np.asarray(out.position)).max(-1))
    stable = (np.asarray(out.det.valid) & (move < 1e-2))[0]
    return outs, out, stable, scale


def test_capture_matches_jax_pipeline_in_both_kpt_modes(golden):
    ours = golden["arrays"]
    assert tuple(ours) == _jax_tool_keys() == capture_golden.GOLDEN_KEYS
    outs, out, stable, scale = _jax_golden(golden)
    assert float(ours["scale"]) == scale
    det = out.det
    valid = np.asarray(det.valid[0])
    np.testing.assert_array_equal(ours["valid"], valid)
    assert valid.sum() > 0
    for name, tol in (("box_left", 1e-3), ("box_right", 1e-3),
                      ("score", 1e-4), ("dims", 1e-3), ("alpha", 1e-3),
                      ("kpt_u", 1e-3), ("border_u", 1e-3)):
        np.testing.assert_allclose(ours[name], np.asarray(
            getattr(det, name)[0]), atol=tol, err_msg=name)
    for mode in ("joint", "per_channel"):
        np.testing.assert_allclose(
            ours[f"kpt_u_{mode}"], np.asarray(outs[mode].det.kpt_u[0]),
            atol=1e-3, err_msg=mode)
        np.testing.assert_allclose(
            ours[f"kpt_prob_{mode}"], np.asarray(outs[mode].det.kpt_prob[0]),
            atol=1e-4, err_msg=mode)
    assert stable.sum() * 2 >= valid.sum()
    assert np.isfinite(ours["position"][valid]).all()
    for name in ("position", "ry", "z_refined"):
        np.testing.assert_allclose(ours[name][stable],
                                   np.asarray(getattr(out, name)[0])[stable],
                                   atol=1e-2, err_msg=name)


def test_main_writes_the_golden(golden, tmp_path, monkeypatch, capsys):
    """``main()`` with ``Config()`` replaced by the tiny config: the report,
    the extras, and the ``.npz`` equal to ``capture()``'s arrays."""
    monkeypatch.setattr("stereo_rcnn_tpu_torch.config.Config",
                        lambda: golden["cfg"])
    tr = os.path.join(golden["work"], "training")
    out = str(tmp_path / "goldens" / "demo.npz")
    capture_golden.main([
        "--pth", golden["pth"], "--left",
        os.path.join(tr, "image_2", "000000.npy"), "--right",
        os.path.join(tr, "image_3", "000000.npy"), "--calib",
        os.path.join(tr, "calib", "000000.txt"), "--out", out,
        "--platform", "cpu"])
    stdout = capsys.readouterr().out
    assert "matched: ['<backbone stages>'" in stdout
    assert "UNCLAIMED" not in stdout
    assert "checkpoint extras: ['epoch', 'pooling_mode']" in stdout
    assert "kpt semantics A/B" in stdout and "golden written to" in stdout
    with np.load(out) as f:
        assert tuple(f.files) == capture_golden.GOLDEN_KEYS
        for k, v in golden["arrays"].items():
            np.testing.assert_array_equal(f[k], v, err_msg=k)
