"""Parity of the port's backbone, RPN head, RCNN head and keypoint head
with their flax counterparts, on the CPU, in float32.

Each flax module is initialised by the JAX package, its frozen-BN
constants are randomised, and ``convert.from_jax`` carries the tree into
the port's ``StereoRCNN``, which must accept it with ``strict=True``.
Inputs come from numpy with fixed seeds.  Tolerance: 1e-4 relative to the
largest magnitude of each output (float32 sums over up to 25k terms in a
different order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu.config import tiny_test_config as j_tiny
from stereo_rcnn_tpu.models.heads import KeypointHead, RCNNHead
from stereo_rcnn_tpu.models.resnet_fpn import ResNetFPN
from stereo_rcnn_tpu.models.stereo_rpn import StereoRPNHead
from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.convert.from_jax import state_dict_from_jax
from stereo_rcnn_tpu_torch.models.detector import build_model

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W = 128, 256


def _parity_cfg(base):
    return dataclasses.replace(
        base, compute_dtype="float32",
        backbone=dataclasses.replace(base.backbone, norm="frozen"),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))


def _randomise_bn(tree, rng):
    """Frozen-BN scale in [0.5, 1], bias ~ N(0, 0.1): exercises the
    scale/bias mapping, which identity init would not."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            return {"scale": rng.uniform(0.5, 1.0, tree["scale"].shape)
                    .astype(np.float32),
                    "bias": (rng.randn(*tree["bias"].shape) * 0.1)
                    .astype(np.float32)}
        return {k: _randomise_bn(v, rng) for k, v in tree.items()}
    return tree


def _close(ours, theirs, name):
    theirs = np.asarray(theirs)
    ours = ours.detach().numpy()
    assert ours.shape == theirs.shape, name
    scale = max(float(np.abs(theirs).max()), 1e-6)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4 * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def setup():
    cfg_j = _parity_cfg(j_tiny())
    cfg = _parity_cfg(tiny_test_config())
    rng = np.random.RandomState(0)
    key = jax.random.PRNGKey(0)
    d = cfg_j.backbone.fpn_dim
    img = rng.randn(2, H, W, 3).astype(np.float32) * 50
    feats = [rng.randn(1, h, w, d).astype(np.float32)
             for h, w in ((32, 64), (16, 32), (8, 16), (4, 8), (2, 4))]
    pooled = rng.randn(3, 7, 7, 2 * d).astype(np.float32)
    pooled_kpt = rng.randn(3, 14, 14, d).astype(np.float32)

    mods = {
        "backbone_net": (ResNetFPN(depth=cfg_j.backbone.depth, fpn_dim=d,
                                   dtype=jnp.float32, norm="frozen"),
                         (img,)),
        "rpn_head": (StereoRPNHead(num_anchors=3, conv_dim=cfg_j.rpn.conv_dim,
                                   dtype=jnp.float32),
                     (feats, [f * 0.5 + 0.1 for f in feats])),
        "rcnn_head": (RCNNHead(num_classes=cfg_j.rcnn.num_classes,
                               fc_dim=cfg_j.rcnn.fc_dim, dtype=jnp.float32),
                      (pooled,)),
        "kpt_head": (KeypointHead(grid=28, dtype=jnp.float32),
                     (pooled_kpt,)),
    }
    tree, outs = {}, {}
    for name, (mod, args) in mods.items():
        p = mod.init(key, *args)["params"]
        p = _randomise_bn(jax.tree.map(np.asarray, p), rng)
        tree[name] = p
        outs[name] = jax.jit(mod.apply)({"params": p}, *args)
    model = build_model(cfg).eval()
    model.load_state_dict(state_dict_from_jax({"params": tree}, cfg),
                          strict=True)
    return model, mods, outs


def test_backbone_fpn_parity(setup):
    model, mods, outs = setup
    (img,) = mods["backbone_net"][1]
    with torch.no_grad():
        ours = model.backbone(torch.from_numpy(img))
    for o, t, name in zip(ours, outs["backbone_net"],
                          ("p2", "p3", "p4", "p5", "p6")):
        assert o.is_contiguous(), name          # NHWC views the kernel reads
        _close(o, t, name)


def test_rpn_head_parity(setup):
    model, mods, outs = setup
    fl, fr = mods["rpn_head"][1]
    with torch.no_grad():
        logits, deltas = model.rpn([torch.from_numpy(f) for f in fl],
                                   [torch.from_numpy(f) for f in fr])
    _close(logits, outs["rpn_head"][0], "logits")
    _close(deltas, outs["rpn_head"][1], "deltas")


def test_rcnn_head_parity(setup):
    """Covers the fc6 flatten permutation and all linear heads."""
    model, mods, outs = setup
    (pooled,) = mods["rcnn_head"][1]
    with torch.no_grad():
        ours = model.heads(torch.from_numpy(pooled))
    for name in ("cls_logits", "box_deltas", "dims", "orien"):
        _close(getattr(ours, name), getattr(outs["rcnn_head"], name), name)


def test_keypoint_head_parity(setup):
    """Covers the ConvTranspose2d(k4, s2, p1) layout and the row sum."""
    model, mods, outs = setup
    (pooled,) = mods["kpt_head"][1]
    with torch.no_grad():
        ours = model.keypoints(torch.from_numpy(pooled))
    _close(ours, outs["kpt_head"], "kpt_logits")
