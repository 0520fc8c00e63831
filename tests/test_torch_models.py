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
from stereo_rcnn_tpu_torch.models.resnet_fpn import GroupNorm32

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


@pytest.mark.parametrize("norm", ["group", "affine"])
def test_backbone_norm_parity(norm):
    """The GroupNorm and affine backbones, their norm parameters
    randomised, through ``convert.from_jax``."""
    base = _parity_cfg(tiny_test_config())
    cfg = dataclasses.replace(base, backbone=dataclasses.replace(
        base.backbone, norm=norm))
    rng = np.random.RandomState(1)
    img = rng.randn(2, H, W, 3).astype(np.float32) * 50
    mod = ResNetFPN(depth=cfg.backbone.depth, fpn_dim=cfg.backbone.fpn_dim,
                    dtype=jnp.float32, norm=norm)
    p = mod.init(jax.random.PRNGKey(0), img)["params"]
    p = _randomise_bn(jax.tree.map(np.asarray, p), rng)
    theirs = jax.jit(mod.apply)({"params": p}, img)
    sd = state_dict_from_jax({"params": {"backbone_net": p}}, cfg)
    model = build_model(cfg)
    model.backbone_net.load_state_dict(
        {k[len("backbone_net."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ours = model.backbone(torch.from_numpy(img))
    for o, t, name in zip(ours, theirs, ("p2", "p3", "p4", "p5", "p6")):
        _close(o, t, name)


def test_group_norm_matches_flax_with_gradients():
    """One GroupNorm on a channels-last input with a large mean (where
    the one-pass variance loses digits): output and gradients w.r.t. the
    input, scale and bias within 1e-5 of flax's."""
    import flax.linen as fnn
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 16, 24, 64) * 3 + 5).astype(np.float32)    # NHWC
    w = rng.randn(2, 16, 24, 64).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=32, dtype=jnp.float32)
    params = gn.init(jax.random.PRNGKey(0), x)["params"]
    params = {k: (np.asarray(v) + rng.randn(*v.shape) * 0.1)
              .astype(np.float32) for k, v in params.items()}

    def loss(p, x_):
        return (gn.apply({"params": p}, x_) * w).sum()
    y_j = gn.apply({"params": params}, x)
    g_p, g_x = jax.grad(loss, argnums=(0, 1))(params, x)

    m = GroupNorm32(64)
    with torch.no_grad():
        m.gn.weight.copy_(torch.from_numpy(params["scale"]))
        m.gn.bias.copy_(torch.from_numpy(params["bias"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = m(xt).permute(0, 2, 3, 1)
    (y * torch.from_numpy(w)).sum().backward()
    for ours, theirs, name in ((y, y_j, "y"),
                               (xt.grad.permute(0, 2, 3, 1), g_x, "dx"),
                               (m.gn.weight.grad, g_p["scale"], "dscale"),
                               (m.gn.bias.grad, g_p["bias"], "dbias")):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=0,
                                   atol=1e-5 * np.abs(theirs).max(),
                                   err_msg=name)


@pytest.mark.parametrize("size_in, size_out", [((12, 40), (24, 80)),
                                               ((5, 7), (10, 13)),
                                               ((6, 9), (11, 17))])
def test_bilinear_upsample_backward_is_the_adjoint(size_in, size_out):
    """The FPN's bilinear upsampling (``_UpsampleBilinear``): the forward
    is ``F.interpolate``'s, bit for bit; the deterministic backward (two
    matrix products in place of ATen's atomics on the card) is its
    gradient, to float64 rounding, at exact 2x and at cropped sizes."""
    import torch.nn.functional as F
    from stereo_rcnn_tpu_torch.models.resnet_fpn import _UpsampleBilinear
    gen = torch.Generator().manual_seed(sum(size_in))
    x = torch.randn(2, 3, *size_in, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    g = torch.randn(2, 3, *size_out, dtype=torch.float64, generator=gen)
    ref = F.interpolate(x, size=size_out, mode="bilinear",
                        align_corners=False)
    (d_ref,) = torch.autograd.grad(ref, x, g)
    out = _UpsampleBilinear.apply(x, size_out)
    (d_out,) = torch.autograd.grad(out, x, g)
    assert torch.equal(out, ref)
    torch.testing.assert_close(d_out, d_ref, rtol=0, atol=1e-12)
