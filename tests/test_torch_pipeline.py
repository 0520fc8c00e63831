"""Stage-wise and end-to-end parity of the port's inference path with the
JAX package, on the CPU, in float32, at the tiny frozen-BN config (depth
26, 128x256, batch 2) with the fused RoIAlign (Pallas interpret mode on
the JAX side).

One JAX initialisation drives both packages through ``convert.from_jax``.
Its ``cls_score`` and ``rpn_cls`` kernels are scaled up first, so class
and objectness scores are well separated (they saturate to exactly 0 or
1, ties broken by index in both packages): near-equal scores would let
last-bit rounding reorder top-k and NMS, which is not what this checks.
The ``rpn_box`` and ``bbox_pred`` kernels are scaled down so box deltas
are O(0.5), as a trained head's are; the random O(40) deltas would turn
a float32 difference of 2e-6 relative into 0.01 px of box.

Stage-wise, each port stage gets the JAX output of the stage before it,
so discrete choices (top-k, NMS, argmax) see identical inputs.
Tolerances: float features, logits and RoIAlign rows 1e-4 relative to
their largest magnitude; boxes 1e-3 px; discrete outputs exactly;
positions 1e-2 m (``tests/test_sharding.py``'s tolerances).

Positions are held to 1e-2 m where the JAX solve itself determines them
to that precision.  Random weights give boxes no 3D car fits: the damped
Gauss-Newton drifts along nearly flat directions and the dense-alignment
argmin meets near-ties, so the JAX solve alone moves some positions by
tenths of a metre when every box edge moves by 1e-5 px (about one
float32 ulp at 100 px).  ``stable`` marks the detections whose JAX
position moves less than 1e-2 m under that shift; those must agree, they
must be the majority, and every valid position must be finite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu.config import tiny_test_config as j_tiny
from stereo_rcnn_tpu.data.synthetic import synthetic_batch
from stereo_rcnn_tpu import inference as j_inf
from stereo_rcnn_tpu.models import detector as j_det
from stereo_rcnn_tpu_torch import inference as t_inf
from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.convert.from_jax import state_dict_from_jax
from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
from stereo_rcnn_tpu_torch.models import detector as t_det
from stereo_rcnn_tpu_torch.models.heads import RCNNOutputs
from stereo_rcnn_tpu_torch.models.stereo_rpn import (Proposals,
                                                     select_proposals)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Output-layer scalings (see module docstring).
CLS_SCALE = 300.0
RPN_SCALE = 300.0
RPN_BOX_SCALE = 0.01
BOX_SCALE = 0.1


def _parity_cfg(base):
    return dataclasses.replace(
        base, compute_dtype="float32",
        backbone=dataclasses.replace(base.backbone, norm="frozen"),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(ours, theirs, name, rel=1e-4):
    theirs = np.asarray(theirs)
    ours = ours.detach().numpy()
    assert ours.shape == theirs.shape, name
    scale = max(float(np.abs(theirs).max()), 1e-6)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=rel * scale,
                               err_msg=name)


def _det_to_torch(det):
    return t_det.Detections(*[_t(x) for x in det])


@pytest.fixture(scope="module")
def run():
    cfg_j = _parity_cfg(j_tiny())
    cfg = _parity_cfg(tiny_test_config())
    h, w = cfg.data.image_h, cfg.data.image_w
    params = jax.tree.map(np.array, j_det.init_params(cfg_j,
                                                      jax.random.PRNGKey(0)))
    p = params["params"]
    p["rcnn_head"]["cls_score"]["kernel"] *= CLS_SCALE
    p["rpn_head"]["rpn_cls"]["kernel"] *= RPN_SCALE
    p["rpn_head"]["rpn_box"]["kernel"] *= RPN_BOX_SCALE
    p["rcnn_head"]["bbox_pred"]["kernel"] *= BOX_SCALE
    jparams = jax.tree.map(jnp.asarray, params)
    model = t_det.build_model(cfg).eval()
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)

    il, ir, _, calib = synthetic_batch(cfg_j, batch=2, seed=7, n_objects=3)
    jm = j_det.build_model(cfg_j)
    feats = jax.jit(lambda q, x: jm.apply(q, x, method=lambda m, y:
                                          m.backbone(y)))(
        jparams, jnp.concatenate([il, ir], 0))
    raw = jax.jit(lambda q, l, r: jm.apply(
        q, l, r, method=lambda m, a, b: j_det.forward_raw(m, a, b, False)))(
        jparams, il, ir)
    det, idx, rois = jax.jit(lambda r_: j_det.postprocess_boxes(
        r_, cfg_j, h, w))(raw)
    det_k = jax.jit(lambda q, r_, d_, i_, b_: j_det.run_keypoints(
        jm, q, r_, d_, i_, b_))(jparams, raw, det, idx, rois)
    calib_b = j_inf.broadcast_calib(calib, 2)
    full = jax.jit(j_inf.make_full_pipeline(cfg_j, calib))(jparams, il, ir)

    solve = jax.jit(lambda d_, l, r, c: j_inf.solve_and_align(
        d_, l, r, c, cfg_j))

    def stable(det3d):
        """[B, D] mask: valid detections whose JAX position moves < 1e-2 m
        when every box edge moves by +-1e-5 px."""
        det_ = det3d.det
        move = 0.0
        for eps in (1e-5, -1e-5):
            shifted = solve(det_._replace(box_left=det_.box_left + eps,
                                          box_right=det_.box_right - eps),
                            il, ir, calib_b)
            move = np.maximum(move, np.abs(np.asarray(shifted.position) -
                                           np.asarray(det3d.position)
                                           ).max(-1))
        return np.asarray(det_.valid) & (move < 1e-2)

    d3 = solve(det_k, il, ir, calib_b)
    return dict(cfg=cfg, model=model, il=il, ir=ir, calib=calib,
                feats=feats, raw=raw, det=det, idx=idx, rois=rois,
                det_k=det_k, d3=d3, full=full, stable=stable)


def _check_positions(ours, jd3, stable):
    """Finite wherever valid; within 1e-2 m wherever the JAX solve is
    stable, which must be most valid detections."""
    valid = np.asarray(jd3.det.valid)
    assert stable.sum() * 2 >= valid.sum() > 0
    assert np.isfinite(ours.position.numpy()[valid]).all()
    for name in ("position", "z_refined", "ry"):
        np.testing.assert_allclose(getattr(ours, name).numpy()[stable],
                                   np.asarray(getattr(jd3, name))[stable],
                                   atol=1e-2, err_msg=name)


def test_stage_backbone(run):
    with torch.no_grad():
        ours = run["model"].backbone(_t(np.concatenate([run["il"],
                                                        run["ir"]])))
    for o, t, name in zip(ours, run["feats"], ("p2", "p3", "p4", "p5", "p6")):
        _close(o, t, name)


def test_stage_rpn_and_proposals(run):
    """Equal proposals and validity (hence equal survivor indices)."""
    cfg, raw, feats = run["cfg"], run["raw"], run["feats"]
    with torch.no_grad():
        logits, deltas = run["model"].rpn([_t(f[:2]) for f in feats],
                                          [_t(f[2:]) for f in feats])
    _close(logits, raw["rpn_logits"], "rpn_logits")
    _close(deltas, raw["rpn_deltas"], "rpn_deltas")
    h, w = cfg.data.image_h, cfg.data.image_w
    props = select_proposals(_t(raw["rpn_logits"]), _t(raw["rpn_deltas"]),
                             generate_anchors(cfg.anchors, h, w,
                                              cfg.box_off, "cpu"),
                             h, w, cfg.rpn, train=False, off=cfg.box_off)
    jp = raw["proposals"]
    np.testing.assert_array_equal(props.valid.numpy(), np.asarray(jp.valid))
    assert props.valid.sum() > 10
    for name in ("left", "right", "scores"):
        np.testing.assert_allclose(getattr(props, name).numpy(),
                                   np.asarray(getattr(jp, name)), atol=1e-3,
                                   err_msg=name)


def test_stage_roi_align_and_heads(run):
    cfg, raw, feats, model = run["cfg"], run["raw"], run["feats"], run["model"]
    jp = raw["proposals"]
    pooled = t_det.roi_features(model, [_t(f[:2]) for f in feats],
                                [_t(f[2:]) for f in feats], _t(jp.left),
                                _t(jp.right))
    rows = np.asarray(raw["kpt_feats"])
    _close(pooled["left_kpt_rows"], rows.reshape(-1, *rows.shape[2:]),
           "packed rows")
    # Heads on the JAX rows.
    c = rows.shape[-1]
    flat = _t(rows.reshape(-1, *rows.shape[2:]))
    concat = torch.cat([flat[:, 196:245].reshape(-1, 7, 7, c),
                        flat[:, 245:].reshape(-1, 7, 7, c)], dim=-1)
    with torch.no_grad():
        out = model.heads(concat)
    for name in RCNNOutputs._fields:
        theirs = np.asarray(getattr(raw["rcnn"], name))
        _close(getattr(out, name), theirs.reshape(-1, *theirs.shape[2:]),
               name)


def _raw_to_torch(raw):
    return {"proposals": Proposals(*[_t(x) for x in raw["proposals"]]),
            "rcnn": RCNNOutputs(*[_t(x) for x in raw["rcnn"]]),
            "kpt_feats": _t(raw["kpt_feats"])}


def test_stage_postprocess_and_keypoints(run):
    cfg, model = run["cfg"], run["model"]
    raw_t = _raw_to_torch(run["raw"])
    det, idx, rois = t_det.postprocess_boxes(raw_t, cfg, cfg.data.image_h,
                                             cfg.data.image_w)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(run["idx"]))
    np.testing.assert_array_equal(det.valid.numpy(),
                                  np.asarray(run["det"].valid))
    assert det.valid.sum() > 0
    for name in ("box_left", "box_right", "score", "dims", "alpha"):
        np.testing.assert_allclose(getattr(det, name).numpy(),
                                   np.asarray(getattr(run["det"], name)),
                                   atol=1e-3, err_msg=name)
    np.testing.assert_allclose(rois.numpy(), np.asarray(run["rois"]),
                               atol=1e-3)
    with torch.no_grad():
        det_k = t_det.run_keypoints(model, raw_t, _det_to_torch(run["det"]),
                                    _t(run["idx"]), _t(run["rois"]))
    jk = run["det_k"]
    np.testing.assert_array_equal(det_k.kpt_type.numpy(),
                                  np.asarray(jk.kpt_type))
    for name in ("kpt_u", "kpt_prob", "border_u"):
        np.testing.assert_allclose(getattr(det_k, name).numpy(),
                                   np.asarray(getattr(jk, name)), atol=1e-3,
                                   err_msg=name)


def test_stage_solve_and_align(run):
    cfg = run["cfg"]
    calib_b = t_inf.broadcast_calib(run["calib"], 2, "cpu")
    d3 = t_inf.solve_and_align(_det_to_torch(run["det_k"]), _t(run["il"]),
                               _t(run["ir"]), calib_b, cfg)
    _check_positions(d3, run["d3"], run["stable"](run["d3"]))


def test_full_pipeline_end_to_end(run):
    """make_full_pipeline on both sides, each from its own renderer."""
    cfg = run["cfg"]
    il, ir, calib = synthetic_images(cfg, 2, seed=7, n_objects=3)
    out = t_inf.make_full_pipeline(cfg, calib)(run["model"], _t(il), _t(ir))
    full = run["full"]
    valid = np.asarray(full.det.valid)
    np.testing.assert_array_equal(out.det.valid.numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(out.det.box_left.numpy(),
                               np.asarray(full.det.box_left), atol=1e-3)
    _check_positions(out, full, run["stable"](full))


def test_deferred_keypoints_match_full_pass(run):
    """The twin of ``tests/test_kpt_deferred.py``: the keypoint convs on
    the NMS survivors only (``run_keypoints``) equal the branch run on
    every proposal and then gathered at the survivors, on the port's own
    forward pass; and both equal the JAX package's deferred pass (the
    same survivors: 1e-3 px, types exactly)."""
    cfg, model = run["cfg"], run["model"]
    h, w = cfg.data.image_h, cfg.data.image_w
    with torch.no_grad():
        raw = t_det.forward_raw(model, _t(run["il"]), _t(run["ir"]))
        det, idx, rois = t_det.postprocess_boxes(raw, cfg, h, w)
        deferred = t_det.run_keypoints(model, raw, det, idx, rois)
        b, n, rows, c = raw["kpt_feats"].shape
        pk = cfg.rcnn.kpt_pool_size
        kl = model.keypoints(raw["kpt_feats"][:, :, :pk * pk].reshape(
            b * n, pk, pk, c))
        kl = kl.reshape(b, n, *kl.shape[1:])
        kl_sel = torch.stack([kl[i, idx[i]] for i in range(b)])
        ku, kt, kp, bu = t_det.decode_keypoints(kl_sel, rois,
                                                cfg.rcnn.kpt_softmax)
    torch.testing.assert_close(deferred.kpt_u, ku, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(deferred.kpt_type.numpy(), kt.numpy())
    torch.testing.assert_close(deferred.kpt_prob, kp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(deferred.border_u, bu, rtol=1e-5, atol=1e-5)
    assert deferred.valid.any()
    jk = run["det_k"]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(run["idx"]))
    np.testing.assert_array_equal(deferred.kpt_type.numpy(),
                                  np.asarray(jk.kpt_type))
    for name in ("kpt_u", "border_u"):
        np.testing.assert_allclose(getattr(deferred, name).numpy(),
                                   np.asarray(getattr(jk, name)), atol=1e-3,
                                   err_msg=name)
