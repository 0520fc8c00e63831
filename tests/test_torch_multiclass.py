"""The multi-class (K = 3: background / Car / Van) configuration through
the port, held to the JAX package on the same inputs, on the CPU: the
twins of ``tests/test_multiclass.py``.

- ``synthetic_multiclass_config()`` is ``configs/synthetic_multiclass.yml``
  over ``Config()``;
- the renderer draws both classes (byte-identical to the JAX renderer)
  and the Car-only stream is unchanged;
- target assignment offsets each class's dims from its own mean (the
  JAX uniforms replayed, ``tests/test_torch_targets.py``'s convention);
- ``postprocess_boxes`` (per-class decode, NMS and the merged top-k) and
  the full pipeline at the tiny config with the fused RoIAlign, under
  ``tests/test_torch_pipeline.py``'s conventions and tolerances;
- one training step against JAX ``make_train_step``, under
  ``tests/test_torch_train.py``'s conventions and tolerances;
- ``tools.train`` then ``tools.test_net`` on an 8-frame two-class tree:
  both per-class AP lines, both class names in the result files, and
  each class decoded against its own mean length.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu import inference as j_inf
from stereo_rcnn_tpu import train as j_train
from stereo_rcnn_tpu.config import RCNNConfig as JRCNNConfig
from stereo_rcnn_tpu.config import load_config as j_load_config
from stereo_rcnn_tpu.config import tiny_test_config as j_tiny
from stereo_rcnn_tpu.data.synthetic import random_scene as j_random_scene
from stereo_rcnn_tpu.data.synthetic import synthetic_batch as j_synthetic
from stereo_rcnn_tpu.models import detector as j_det
from stereo_rcnn_tpu.train import targets as j_targets
from stereo_rcnn_tpu_torch import inference as t_inf
from stereo_rcnn_tpu_torch.config import (RCNNConfig, load_config,
                                          save_config,
                                          synthetic_multiclass_config,
                                          tiny_test_config)
from stereo_rcnn_tpu_torch.convert.from_jax import state_dict_from_jax
from stereo_rcnn_tpu_torch.data.synthetic import (_CLASS_SPECS, random_scene,
                                                  render_pair,
                                                  synthetic_batch,
                                                  synthetic_images,
                                                  write_kitti_frame)
from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
from stereo_rcnn_tpu_torch.geometry.calib import default_kitti_calib
from stereo_rcnn_tpu_torch.models import detector as t_det
from stereo_rcnn_tpu_torch.tools import test_net, train
from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                         make_train_step)
from stereo_rcnn_tpu_torch.train import targets as t_targets
from stereo_rcnn_tpu_torch.train.step import trainable_params
from tests.test_torch_pipeline import (BOX_SCALE, CLS_SCALE, RPN_BOX_SCALE,
                                       RPN_SCALE, _check_positions,
                                       _parity_cfg, _raw_to_torch)
from tests.test_torch_targets import key_uniforms
from tests.test_torch_train import (STEPS_PER_EPOCH, _cfg, _check_metrics,
                                    _check_update, _jax_state, jax_uniforms)
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MULTICLASS_OVERLAY = {
    "data": {"classes": ["__background__", "Car", "Van"],
             "ignore_types": ["Truck", "DontCare"]},
    "rcnn": {"num_classes": 3,
             "mean_dims_hwl": [[1.53, 1.63, 3.88], [2.15, 1.85, 5.05]]},
}


def tiny3():
    return load_config(overrides=MULTICLASS_OVERLAY, base=tiny_test_config())


def j_tiny3():
    return j_load_config(overrides=MULTICLASS_OVERLAY, base=j_tiny())


def _tupled(tree):
    """Nested lists as tuples: the JAX YAML loader keeps a list-valued
    row of a tuple field (``mean_dims_hwl``) a list, the port a tuple."""
    if isinstance(tree, dict):
        return {k: _tupled(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_tupled(v) for v in tree)
    return tree


def _t(x):
    return torch.from_numpy(np.array(x))


def test_multiclass_config_matches_yaml(tmp_path):
    ours = synthetic_multiclass_config()
    theirs = j_load_config("configs/synthetic_multiclass.yml")
    assert (_tupled(dataclasses.asdict(ours)) ==
            _tupled(dataclasses.asdict(theirs)))
    # The port's own JSON round trip gives the config back exactly.
    save_config(ours, str(tmp_path / "mc.json"))
    assert load_config(str(tmp_path / "mc.json")) == ours
    assert tiny3().rcnn.mean_dims_hwl == ours.rcnn.mean_dims_hwl


def test_renderer_draws_both_classes_with_class_consistent_dims():
    cfg = tiny3()
    il, ir, gt, _ = synthetic_batch(cfg, batch=6, seed=3, n_objects=4)
    il_j, ir_j, gt_j, _ = j_synthetic(j_tiny3(), batch=6, seed=3,
                                      n_objects=4)
    np.testing.assert_array_equal(il, np.asarray(il_j))
    np.testing.assert_array_equal(ir, np.asarray(ir_j))
    for name in gt._fields:
        np.testing.assert_array_equal(getattr(gt, name),
                                      np.asarray(getattr(gt_j, name)),
                                      err_msg=name)
    cls = np.asarray(gt.cls)[np.asarray(gt.valid)]
    dims = np.asarray(gt.dims)[np.asarray(gt.valid)]
    assert {1, 2} <= set(cls.tolist())
    car, van = _CLASS_SPECS["Car"], _CLASS_SPECS["Van"]
    for d in dims[cls == 1]:
        assert car["h"][0] <= d[0] <= car["h"][1] and \
               car["l"][0] <= d[2] <= car["l"][1]
    for d in dims[cls == 2]:
        assert van["h"][0] <= d[0] <= van["h"][1] and \
               van["l"][0] <= d[2] <= van["l"][1]
    assert car["l"][1] < van["l"][0]
    assert np.isfinite(il).all() and np.isfinite(ir).all()


def test_car_only_rendering_unchanged_by_multiclass_support():
    calib = default_kitti_calib()
    rng1 = np.random.RandomState(11)
    objs1 = random_scene(rng1, 3, calib, 375, 1242)
    rng2 = np.random.RandomState(11)
    objs2 = random_scene(rng2, 3, calib, 375, 1242, class_names=("Car",))
    rng3 = np.random.RandomState(11)
    objs3 = j_random_scene(rng3, 3, calib, 375, 1242, class_names=("Car",))
    assert len(objs1) == len(objs2) == len(objs3)
    for a, b, c in zip(objs1, objs2, objs3):
        assert a.type == b.type == c.type == "Car"
        for x in (b, c):
            np.testing.assert_array_equal(a.box, x.box)
            np.testing.assert_array_equal(a.dims, x.dims)
    draws = {rng.randint(1 << 30) for rng in (rng1, rng2, rng3)}
    assert len(draws) == 1


def _gt_two_classes(g=8):
    boxes_l = np.float32([[20.0, 20.0, 60.0, 52.0],
                          [140.0, 30.0, 200.0, 80.0]])
    z = np.zeros((g,), np.float32)

    def pad(rows, shape=(), dtype=np.float32):
        out = np.zeros((g,) + shape, dtype)
        out[:2] = rows
        return out

    return t_targets.GroundTruth(
        left=pad(boxes_l, (4,)), right=pad(boxes_l - [6, 0, 6, 0], (4,)),
        cls=pad([1, 2], dtype=np.int32),
        dims=pad([[1.5, 1.6, 3.9], [2.2, 1.9, 5.2]], (3,)),
        alpha=pad([0.3, 0.3]), kpt_u=pad([40.0, 170.0]),
        kpt_type=np.zeros((g,), np.int32), kpt_visible=pad([True, True],
                                                           dtype=bool),
        border_u=pad([[21.0, 59.0], [141.0, 199.0]], (2,)),
        valid=pad([True, True], dtype=bool), location=np.zeros((g, 3),
                                                               np.float32),
        ry=z, ignore=np.zeros((g,), bool))


def _targets_both(mean, num_classes, right_shift):
    """Proposal targets of both packages for the two GT boxes as
    proposals (plus 14 invalid slots), the JAX key's uniforms replayed."""
    gt = _gt_two_classes()
    pl = np.concatenate([gt.left[:2], np.zeros((14, 4), np.float32)])
    pr = np.concatenate([gt.right[:2] if right_shift else gt.left[:2],
                         np.zeros((14, 4), np.float32)])
    pv = np.array([True, True] + [False] * 14)
    kw = dict(rois_per_image=16)
    if mean is not None:
        kw.update(num_classes=num_classes,
                  mean_dims_hwl=tuple(map(tuple, mean)))
    key = jax.random.PRNGKey(0)
    theirs = j_targets.proposal_targets(
        jnp.asarray(pl), jnp.asarray(pr), jnp.asarray(pv),
        jax.tree.map(jnp.asarray, gt), JRCNNConfig(**kw), key)
    u = key_uniforms(key, 16 + 8)
    ours = t_targets.proposal_targets(
        _t(pl)[None], _t(pr)[None], _t(pv)[None],
        t_targets.GroundTruth(*[_t(x)[None] for x in gt]), RCNNConfig(**kw),
        *[_t(x)[None] for x in u])
    np.testing.assert_array_equal(ours.cls[0].numpy(), np.asarray(theirs.cls))
    np.testing.assert_allclose(ours.dim_targets[0].numpy(),
                               np.asarray(theirs.dim_targets), rtol=1e-5,
                               atol=1e-5)
    return ours.cls[0].numpy(), ours.dim_targets[0].numpy(), gt.dims


def test_proposal_targets_use_per_class_mean_dims():
    mean = np.float32(MULTICLASS_OVERLAY["rcnn"]["mean_dims_hwl"])
    cls, dimt, gdims = _targets_both(mean, 3, right_shift=True)
    assert {1, 2} <= set(cls.tolist())
    for row in np.nonzero(cls > 0)[0]:
        c = cls[row]
        np.testing.assert_allclose(dimt[row], gdims[c - 1] - mean[c - 1],
                                   atol=1e-5)


def test_flat_mean_dims_still_broadcast():
    cls, dimt, gdims = _targets_both(None, 2, right_shift=False)
    mean = np.asarray(RCNNConfig().mean_dims_hwl, np.float32)
    assert (cls > 0).any()
    for row in np.nonzero(cls > 0)[0]:
        np.testing.assert_allclose(dimt[row], gdims[cls[row] - 1] - mean,
                                   atol=1e-5)


# -- K = 3 inference: postprocess and the full pipeline ---------------------

@pytest.fixture(scope="module")
def run3():
    cfg_j, cfg = _parity_cfg(j_tiny3()), _parity_cfg(tiny3())
    h, w = cfg.data.image_h, cfg.data.image_w
    params = jax.tree.map(np.array, j_det.init_params(cfg_j,
                                                      jax.random.PRNGKey(0)))
    p = params["params"]
    p["rcnn_head"]["cls_score"]["kernel"] *= CLS_SCALE
    # Van's column mirrors Car's, so a roi's sign on it picks its class:
    # both classes win some rois, and the merge has two lists to merge.
    kernel = p["rcnn_head"]["cls_score"]["kernel"]
    kernel[:, 2] = -kernel[:, 1]
    p["rpn_head"]["rpn_cls"]["kernel"] *= RPN_SCALE
    p["rpn_head"]["rpn_box"]["kernel"] *= RPN_BOX_SCALE
    p["rcnn_head"]["bbox_pred"]["kernel"] *= BOX_SCALE
    jparams = jax.tree.map(jnp.asarray, params)
    model = t_det.build_model(cfg).eval()
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    il, ir, _, calib = j_synthetic(cfg_j, batch=2, seed=7, n_objects=3)
    jm = j_det.build_model(cfg_j)
    raw = jax.jit(lambda q, l, r: jm.apply(
        q, l, r, method=lambda m, a, b: j_det.forward_raw(m, a, b, False)))(
        jparams, il, ir)
    det, idx, rois = jax.jit(lambda r_: j_det.postprocess_boxes(
        r_, cfg_j, h, w))(raw)
    full = jax.jit(j_inf.make_full_pipeline(cfg_j, calib))(jparams, il, ir)
    solve = jax.jit(lambda d_, l, r, c: j_inf.solve_and_align(
        d_, l, r, c, cfg_j))
    calib_b = j_inf.broadcast_calib(calib, 2)

    def stable(det3d):
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

    return dict(cfg=cfg, model=model, raw=raw, det=det, idx=idx, rois=rois,
                full=full, stable=stable)


def test_k3_postprocess_matches_jax(run3):
    """Per-class decode, NMS and the merged top-k on the JAX head
    outputs: equal survivors, classes and validity, boxes to 1e-3 px;
    both foreground classes among the detections."""
    cfg = run3["cfg"]
    assert run3["raw"]["rcnn"].cls_logits.shape[-1] == 3
    det, idx, rois = t_det.postprocess_boxes(
        _raw_to_torch(run3["raw"]), cfg, cfg.data.image_h, cfg.data.image_w)
    jd = run3["det"]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(run3["idx"]))
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(det.cls.numpy(), np.asarray(jd.cls))
    valid = det.valid.numpy()
    assert valid.sum() > 0
    assert {1, 2} <= set(det.cls.numpy()[valid].tolist())
    for name in ("box_left", "box_right", "score", "dims", "alpha"):
        np.testing.assert_allclose(getattr(det, name).numpy(),
                                   np.asarray(getattr(jd, name)), atol=1e-3,
                                   err_msg=name)
    np.testing.assert_allclose(rois.numpy(), np.asarray(run3["rois"]),
                               atol=1e-3)


def test_k3_full_pipeline_matches_jax(run3):
    cfg = run3["cfg"]
    il, ir, calib = synthetic_images(cfg, 2, seed=7, n_objects=3)
    out = t_inf.make_full_pipeline(cfg, calib)(run3["model"], _t(il), _t(ir))
    full = run3["full"]
    valid = np.asarray(full.det.valid)
    np.testing.assert_array_equal(out.det.valid.numpy(), valid)
    np.testing.assert_array_equal(out.det.cls.numpy(),
                                  np.asarray(full.det.cls))
    assert valid.sum() > 0
    np.testing.assert_allclose(out.det.box_left.numpy(),
                               np.asarray(full.det.box_left), atol=1e-3)
    _check_positions(out, full, run3["stable"](full))


# -- K = 3 training: one step against JAX make_train_step -------------------

def test_k3_train_step_matches_jax():
    """One GroupNorm step of both packages from one JAX state on a
    rendered two-class batch: the metrics, and the updates of every
    ``cls_score`` column (background, Car, Van), fc6 and a layer4 kernel,
    to ``tests/test_torch_train.py``'s tolerances."""
    cfg_j, cfg = _cfg(j_tiny3(), "group"), _cfg(tiny3(), "group")
    params, state_j = _jax_state(cfg_j)
    il, ir, gt, _ = j_synthetic(cfg_j, batch=2, seed=0, n_objects=3)
    assert {1, 2} <= set(np.asarray(gt.cls)[np.asarray(gt.valid)].tolist())
    key = jax.random.PRNGKey(3)
    new_j, metrics_j = jax.jit(j_train.make_train_step(
        cfg_j, STEPS_PER_EPOCH))(
        state_j, j_train.Batch(jnp.asarray(il), jnp.asarray(ir),
                               jax.tree.map(jnp.asarray, gt)), key)
    state = init_train_state(cfg, state_dict=state_dict_from_jax(params, cfg),
                             device="cpu")
    before = {k: v.detach().clone()
              for k, v in trainable_params(state).items()}
    h, w = cfg.data.image_h, cfg.data.image_w
    a = generate_anchors(cfg.anchors, h, w, cfg.box_off, "cpu").shape[0]
    n = cfg.rpn.train_post_nms_top_n + cfg.train.max_gt_boxes
    metrics = make_train_step(cfg, STEPS_PER_EPOCH, device="cpu")(
        state, Batch(_t(il), _t(ir), t_targets.ground_truth_to_torch(
            gt, "cpu")), uniforms=jax_uniforms(key, 2, a, n))
    one_step = dict(cfg=cfg, metrics=metrics, metrics_j=metrics_j,
                    state=state, before=before,
                    before_j=state_dict_from_jax(params, cfg),
                    after_j=state_dict_from_jax(
                        jax.tree.map(np.asarray, new_j.params), cfg))
    _check_metrics(one_step)
    for name in ("rcnn_head.RCNN_cls_score.weight",
                 "rcnn_head.RCNN_fc6.weight",
                 "backbone_net.RCNN_layer4.0.conv2.weight"):
        _check_update(one_step, name)
    w_cls = "rcnn_head.RCNN_cls_score.weight"
    upd = (trainable_params(state)[w_cls].detach() - before[w_cls]).numpy()
    assert upd.shape[0] == 3 and (np.abs(upd).max(axis=1) > 0).all()


# -- the CLIs over a two-class KITTI tree ----------------------------------

N_FRAMES = 8


@pytest.fixture(scope="module")
def multiclass_kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_mc"))
    calib = default_kitti_calib()
    rng = np.random.RandomState(5)
    n_van = 0
    for i in range(N_FRAMES):
        objs = random_scene(rng, 3, calib, 375, 1242,
                            class_names=("Car", "Van"))
        n_van += sum(o.type == "Van" for o in objs)
        left, right = render_pair(objs, calib, 375, 1242, rng)
        write_kitti_frame(root, f"{i:06d}", objs, calib, left, right)
    assert n_van > 0
    return root


def test_multiclass_train_then_eval_cli(multiclass_kitti_root, tmp_path,
                                        monkeypatch, capsys):
    import json
    monkeypatch.chdir(tmp_path)
    overlay = str(tmp_path / "tiny3.json")
    with open(overlay, "w") as f:
        json.dump(MULTICLASS_OVERLAY, f)
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "results")
    assert train.main([
        "--tiny", "--config", overlay, "--kitti-root", multiclass_kitti_root,
        "--epochs", "1", "--batch-per-device", "4", "--ckpt-dir", ckpt,
        "--image-ext", ".npy", "--platform", "cpu",
        "--disp-interval", "1"]) == 0
    assert "checkpoint saved" in capsys.readouterr().out
    assert load_config(os.path.join(ckpt, "config.json")) == \
        dataclasses.replace(tiny3(), data=dataclasses.replace(
            tiny3().data, kitti_root=multiclass_kitti_root),
            train=dataclasses.replace(tiny3().train, epochs=1,
                                      batch_per_device=4))

    assert test_net.main([
        "--tiny", "--config", overlay, "--kitti-root", multiclass_kitti_root,
        "--ckpt-dir", ckpt, "--out", out, "--batch", "4", "--image-ext",
        ".npy", "--platform", "cpu"]) == 0
    stdout = capsys.readouterr().out
    assert "[Car] AP_3d@0.5 (R40)" in stdout
    assert "[Van] AP_3d@0.5 (R40)" in stdout
    # After one tiny epoch the dim head's outputs are still near their
    # small init, so decoded lengths sit near each class's own mean.
    seen = {"Car": [], "Van": []}
    for fn in sorted(os.listdir(out)):
        with open(os.path.join(out, fn)) as f:
            for line in f:
                p = line.split()
                assert len(p) == 16, line
                assert p[0] in seen, line
                seen[p[0]].append(float(p[10]))
    assert seen["Car"] and seen["Van"]
    assert np.median(seen["Car"]) < 4.4
    assert np.median(seen["Van"]) > 4.4
