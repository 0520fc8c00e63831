"""The port's copies and bridges pinned to the JAX package, on the CPU:
the config copy, the renderer and ground-truth copy, and the weight
converter.

Exact comparisons throughout: these are copies, not re-implementations.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu import config as j_config
from stereo_rcnn_tpu.convert.resnet_import import _fold_bn
from stereo_rcnn_tpu.convert.stereo_import import import_detector
from stereo_rcnn_tpu.data.synthetic import synthetic_batch
from stereo_rcnn_tpu.train import init_train_state
from stereo_rcnn_tpu_torch import config as t_config
from stereo_rcnn_tpu_torch.convert.from_jax import state_dict_from_jax
from stereo_rcnn_tpu_torch.data.synthetic import (
    synthetic_batch as t_synthetic_batch, synthetic_images)
from stereo_rcnn_tpu_torch.models.detector import StereoRCNN

from tests.test_convert_full import DEPTH, FPN_DIM, TorchStereoRCNN


@pytest.mark.parametrize("make", ["Config", "tiny_test_config"])
def test_config_copy_matches(make):
    ours = getattr(t_config, make)()
    theirs = getattr(j_config, make)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.box_off == theirs.box_off


def test_synthetic_fullres_config_matches_yaml():
    """``synthetic_fullres_config()`` is configs/synthetic_fullres.yml."""
    theirs = j_config.load_config("configs/synthetic_fullres.yml")
    assert (dataclasses.asdict(t_config.synthetic_fullres_config()) ==
            dataclasses.asdict(theirs))


def test_renderer_copy_is_byte_identical():
    cfg_t = t_config.tiny_test_config()
    cfg_j = j_config.tiny_test_config()
    il_t, ir_t, calib_t = synthetic_images(cfg_t, 3, seed=7, n_objects=5)
    il_j, ir_j, _, calib_j = synthetic_batch(cfg_j, batch=3, seed=7,
                                             n_objects=5)
    assert il_t.dtype == il_j.dtype == np.float32
    np.testing.assert_array_equal(il_t, il_j)
    np.testing.assert_array_equal(ir_t, ir_j)
    for a, b in zip(calib_t, calib_j):
        np.testing.assert_array_equal(a, b)


def test_ground_truth_copy_is_byte_identical():
    """``synthetic_batch``'s images and packed ground truth, field by
    field, dtypes included (several objects per frame, padded slots)."""
    cfg_t = t_config.tiny_test_config()
    cfg_j = j_config.tiny_test_config()
    ours = t_synthetic_batch(cfg_t, 3, seed=7, n_objects=5)
    theirs = synthetic_batch(cfg_j, batch=3, seed=7, n_objects=5)
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_array_equal(a, b)
    gt_t, gt_j = ours[2], theirs[2]
    assert gt_t._fields == gt_j._fields
    assert gt_j.valid.any() and not gt_j.valid.all()
    for name in gt_j._fields:
        a, b = getattr(gt_t, name), getattr(gt_j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _strip(key):
    """Port key -> upstream key (the port nests three containers)."""
    for pref in ("backbone_net.", "rcnn_head.", "kpt_head."):
        if key.startswith(pref):
            return key[len(pref):]
    return key


@pytest.fixture(scope="module")
def twin_round_trip():
    torch.manual_seed(0)
    twin = TorchStereoRCNN()
    for mod in twin.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.running_mean.normal_(0, 0.5)
            mod.running_var.uniform_(0.5, 2.0)
            mod.weight.data.uniform_(0.5, 1.5)
            mod.bias.data.normal_(0, 0.5)
    sd = {k: v.detach().numpy() for k, v in twin.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, report = import_detector(sd, depth=DEPTH, pool=7,
                                     fpn_dim=FPN_DIM)
    assert report["unclaimed"] == []
    base = t_config.tiny_test_config()
    cfg = dataclasses.replace(
        base, backbone=dataclasses.replace(base.backbone, depth=DEPTH,
                                           fpn_dim=FPN_DIM, norm="frozen"),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))
    return sd, state_dict_from_jax(params, cfg), cfg


def test_from_jax_round_trip_returns_the_twin_tensors(twin_round_trip):
    """twin state_dict -> import_detector -> from_jax gives back the twin's
    tensors bit for bit; BatchNorm comes back as its folded constants."""
    sd, ours, _ = twin_round_trip
    bn_prefixes = {k[:-len(".running_mean")] for k in sd
                   if k.endswith(".running_mean")}
    seen = set()
    for key, value in ours.items():
        up = _strip(key)
        prefix, leaf = up.rsplit(".", 1)
        if prefix in bn_prefixes:
            np.testing.assert_array_equal(value.numpy(),
                                          _fold_bn(sd, prefix)[leaf], key)
            seen.update(f"{prefix}.{n}" for n in
                        ("weight", "bias", "running_mean", "running_var"))
        else:
            np.testing.assert_array_equal(value.numpy(), sd[up], key)
            seen.add(up)
    assert seen == set(sd)


def test_from_jax_names_match_the_port_model(twin_round_trip):
    _, ours, cfg = twin_round_trip
    assert set(ours) == set(StereoRCNN(cfg).state_dict())


def test_from_jax_raises_on_unmapped_leaf(twin_round_trip):
    sd, _, cfg = twin_round_trip
    params, _ = import_detector(sd, depth=DEPTH, pool=7, fpn_dim=FPN_DIM)
    params["rcnn_head"]["extra_head"] = {"kernel": np.zeros((2, 2),
                                                            np.float32)}
    with pytest.raises(KeyError, match="extra_head"):
        state_dict_from_jax(jax.tree.map(np.asarray, params), cfg)


@pytest.mark.parametrize("norm", ["group", "affine"])
def test_from_jax_maps_training_state(norm):
    """A JAX training state's tree (GroupNorm ``gn`` leaves or affine
    norms, and ``uncert``) maps onto the port's model names bit for bit."""
    base = j_config.tiny_test_config()
    cfg_j = dataclasses.replace(
        base, backbone=dataclasses.replace(base.backbone, norm=norm),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))
    params = jax.tree.map(np.asarray,
                          init_train_state(cfg_j, jax.random.PRNGKey(0)
                                           ).params)
    params["uncert"] = np.arange(6, dtype=np.float32)
    cfg = t_config.Config(**{f.name: getattr(cfg_j, f.name)
                             for f in dataclasses.fields(cfg_j)})
    ours = state_dict_from_jax(params, cfg)
    np.testing.assert_array_equal(ours.pop("uncert"), params["uncert"])
    model = StereoRCNN(cfg)
    assert set(ours) == set(model.state_dict())
    model.load_state_dict(ours, strict=True)
    bb = params["model"]["backbone_net"]
    if norm == "group":
        np.testing.assert_array_equal(
            ours["backbone_net.RCNN_layer0.1.gn.weight"],
            bb["bn1"]["gn"]["scale"])
        np.testing.assert_array_equal(
            ours["backbone_net.RCNN_layer2.0.downsample.1.gn.bias"],
            bb["layer2_0"]["downsample_bn"]["gn"]["bias"])
    else:
        # Affine zero-gamma init on bn3 only, in both packages.
        assert not ours["backbone_net.RCNN_layer1.0.bn3.scale"].any()
        np.testing.assert_array_equal(
            ours["backbone_net.RCNN_layer1.0.bn1.scale"],
            bb["layer1_0"]["bn1"]["scale"])
        assert set(dict(model.named_parameters())) >= {
            "backbone_net.RCNN_layer1.0.bn3.scale"}


def _frozen_pallas_cfg(section, field, value):
    base = t_config.tiny_test_config()
    cfg = dataclasses.replace(
        base, backbone=dataclasses.replace(base.backbone, norm="frozen"),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))
    return dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **{field: value})})


@pytest.mark.parametrize("section, field, value", [
    ("backbone", "fpn_upsample", "nearest"),
])
def test_unported_options_raise(section, field, value):
    """The options the port once refused now build and run as the JAX
    package runs them.  ``fpn_upsample="nearest"``: the port's backbone
    against the flax one (repeat 2x, crop to the lateral) on the same
    weights through ``convert.from_jax``, float32, every level within
    1e-5 of its largest magnitude (the convolutions sum in another
    order).  Odd image sides make the crop cut a repeated row and
    column."""
    from stereo_rcnn_tpu.models.resnet_fpn import ResNetFPN
    cfg = _frozen_pallas_cfg(section, field, value)
    cfg = dataclasses.replace(cfg, compute_dtype="float32", backbone=(
        dataclasses.replace(cfg.backbone, depth=10, fpn_dim=32)))
    rng = np.random.RandomState(3)
    img = (rng.randn(2, 80, 112, 3) * 50).astype(np.float32)
    mod = ResNetFPN(depth=10, fpn_dim=32, dtype=jax.numpy.float32,
                    norm="frozen", upsample=value)
    p = jax.tree.map(np.asarray,
                     mod.init(jax.random.PRNGKey(0), img)["params"])
    theirs = jax.jit(mod.apply)({"params": p}, img)
    sd = state_dict_from_jax({"params": {"backbone_net": p}}, cfg)
    model = StereoRCNN(cfg)
    assert model.backbone_net.upsample == value
    model.backbone_net.load_state_dict(
        {k[len("backbone_net."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ours = model.backbone(torch.from_numpy(img))
    for o, t in zip(ours, theirs):
        t = np.asarray(t)
        assert o.shape == t.shape
        np.testing.assert_allclose(o.numpy(), t, rtol=0,
                                   atol=1e-5 * np.abs(t).max())


def test_odd_fpn_dim_refused_with_the_fused_roi_align():
    """An odd ``fpn_dim`` with the fused RoIAlign is no longer refused: the
    card's kernels take every channel count, as the Pallas kernels do.  At
    ``fpn_dim=33`` the port's whole CPU forward (K1's plain version) agrees
    with the JAX one (its Pallas K1 in interpret mode) on the same weights,
    to ``tests/test_torch_pipeline.py``'s tolerances: equal proposal
    validity, boxes within 1e-3 px, RoIAlign rows and head outputs within
    1e-4 of their largest magnitude.  The output layers are scaled as
    there, so that near-equal random scores do not reorder top-k and
    NMS."""
    from stereo_rcnn_tpu.models import detector as j_det
    from stereo_rcnn_tpu_torch.models import detector as t_det
    from stereo_rcnn_tpu_torch.models.heads import RCNNOutputs
    cfg = dataclasses.replace(_frozen_pallas_cfg("backbone", "fpn_dim", 33),
                              compute_dtype="float32")
    cfg_j = j_config.Config(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)})
    params = jax.tree.map(np.array, j_det.init_params(cfg_j,
                                                      jax.random.PRNGKey(0)))
    p = params["params"]
    p["rcnn_head"]["cls_score"]["kernel"] *= 300.0
    p["rpn_head"]["rpn_cls"]["kernel"] *= 300.0
    p["rpn_head"]["rpn_box"]["kernel"] *= 0.01
    p["rcnn_head"]["bbox_pred"]["kernel"] *= 0.1
    il, ir, _, _ = synthetic_batch(cfg_j, batch=2, seed=7, n_objects=3)
    jm = j_det.build_model(cfg_j)
    raw = jax.jit(lambda q, l, r: jm.apply(
        q, l, r, method=lambda m, a, b: j_det.forward_raw(m, a, b, False)))(
        jax.tree.map(jax.numpy.asarray, params), il, ir)
    model = StereoRCNN(cfg).eval()
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    with torch.no_grad():
        ours = t_det.forward_raw(model, torch.from_numpy(il),
                                 torch.from_numpy(ir))

    def close(a, b, name):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)
    assert ours["kpt_feats"].shape[-1] == 33
    assert ours["proposals"].valid.sum() > 10
    np.testing.assert_array_equal(ours["proposals"].valid.numpy(),
                                  np.asarray(raw["proposals"].valid))
    np.testing.assert_allclose(ours["proposals"].left.numpy(),
                               np.asarray(raw["proposals"].left), atol=1e-3)
    close(ours["kpt_feats"], raw["kpt_feats"], "kpt_feats")
    for name in RCNNOutputs._fields:
        close(getattr(ours["rcnn"], name), getattr(raw["rcnn"], name), name)


@pytest.mark.parametrize("field, value, expect", [
    ("roi_align_impl", "xla", ("multilevel_roi_align", None)),
    ("roi_align_hat", "kron_bf16", ("stereo_roi_align_packed_ref",
                                    "kron_bf16")),
    ("roi_align_hat", "kron_hilo", ("stereo_roi_align_packed_ref",
                                    "kron_hilo")),
])
def test_roi_align_options_build_and_dispatch(monkeypatch, field, value,
                                              expect):
    """The RoIAlign options build, and ``roi_features`` on CPU tensors
    calls the implementation they name: the atlas gather three times, or
    K1's plain version with that hat; nothing else."""
    from stereo_rcnn_tpu_torch.models import detector as t_det
    from stereo_rcnn_tpu_torch.ops import stereo_roi_align as t_sra
    cfg = _frozen_pallas_cfg("rcnn", field, value)
    model = StereoRCNN(cfg)
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            hat = args[5] if len(args) > 5 else kwargs.get("hat")
            calls.append((name, hat))
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    spy(t_det, "multilevel_roi_align")
    spy(t_sra, "stereo_roi_align_packed_ref")
    rng = np.random.RandomState(0)
    h, w, c = cfg.data.image_h, cfg.data.image_w, cfg.backbone.fpn_dim
    feats = [torch.from_numpy(rng.randn(1, h // s, w // s, c)
                              .astype(np.float32)) for s in (4, 8, 16, 32)]
    rois = torch.tensor([[[10.0, 12.0, 90.0, 60.0], [40.0, 8.0, 200.0,
                                                     100.0]]])
    out = t_det.roi_features(model, feats, feats, rois, rois - 5.0)
    p, pk = cfg.rcnn.pooling_size, cfg.rcnn.kpt_pool_size
    assert out["concat"].shape == (2, p, p, 2 * c)
    assert out["left_kpt"].shape == (2, pk, pk, c)
    assert calls == [expect] * (3 if value == "xla" else 1)
    rows = pk * pk if value == "xla" else pk * pk + 2 * p * p
    assert out["left_kpt_rows"].shape == (2, rows, c)
