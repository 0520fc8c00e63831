"""The port's target assignment and losses against ``stereo_rcnn_tpu.train``,
on the CPU.

Targets: the same anchors, proposals and ground truth go through the JAX
functions (vmapped over the batch, one key per image) and the port's
batched functions, which replay the uniforms those keys draw (the anchor
background key is drawn twice, the roi gather from ``fold_in(key, 7)``).
The ground truth has real objects, an ignore region and padding slots;
few valid proposals leave room for unsampled zero-area padded GT rows
among the S sampled rois.  Integer fields must be equal bit for bit, box
and dimension targets to 1e-5.

Losses: every loss of random network outputs against those targets, both
``kpt_softmax`` modes, to 1e-6 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu.config import tiny_test_config as j_tiny
from stereo_rcnn_tpu.data.synthetic import synthetic_batch as j_synthetic
from stereo_rcnn_tpu.geometry.anchors import generate_anchors as j_anchors
from stereo_rcnn_tpu.models.heads import RCNNOutputs as JOutputs
from stereo_rcnn_tpu.train import losses as j_losses
from stereo_rcnn_tpu.train import targets as j_targets
from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
from stereo_rcnn_tpu_torch.models.heads import RCNNOutputs
from stereo_rcnn_tpu_torch.train import losses as t_losses
from stereo_rcnn_tpu_torch.train import targets as t_targets

B, N_PROP = 2, 64


def _t(x):
    return torch.from_numpy(np.array(x))


def _ground_truth(cfg_j):
    """Rendered GT (3 cars in 8 slots) with an ignore region added in a
    padding slot of image 0."""
    _, _, gt, _ = j_synthetic(cfg_j, batch=B, seed=0, n_objects=3)
    gt = gt._replace(**{f: np.array(getattr(gt, f)) for f in gt._fields})
    slot = int(gt.valid[0].sum())
    gt.left[0, slot] = gt.right[0, slot] = [20.0, 40.0, 90.0, 100.0]
    gt.ignore[0, slot] = True
    assert gt.ignore.any() and (~gt.valid & ~gt.ignore).any()
    return gt


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg = j_tiny(), tiny_test_config()
    h, w = cfg.data.image_h, cfg.data.image_w
    gt = _ground_truth(cfg_j)
    anchors = generate_anchors(cfg.anchors, h, w, cfg.box_off, "cpu")
    np.testing.assert_array_equal(
        anchors.numpy(), np.asarray(j_anchors(cfg_j.anchors, h, w,
                                              off=cfg_j.box_off)))
    # Proposals: jittered GT pairs, random boxes, and invalid slots.
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, [w - 40, h - 40], size=(B, N_PROP, 2))
    wh = rng.uniform(8, [120, 90], size=(B, N_PROP, 2))
    pl = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    n_gt = gt.left.shape[1]
    jitter = gt.left + rng.randn(B, n_gt, 4).astype(np.float32) * 3
    pl[:, :n_gt] = np.where(gt.valid[..., None], jitter, pl[:, :n_gt])
    pr = (pl - np.float32([6, 0, 5, 0])).astype(np.float32)
    pv = np.zeros((B, N_PROP), bool)
    pv[:, :4] = True
    return cfg_j, cfg, gt, anchors, pl, pr, pv


def key_uniforms(key, n):
    """The uniforms one image's key draws in ``anchor_targets`` (the
    first two) and ``proposal_targets`` (all three)."""
    k_fg, k_bg = jax.random.split(key)
    return (jax.random.uniform(k_fg, (n,)), jax.random.uniform(k_bg, (n,)),
            jax.random.uniform(jax.random.fold_in(key, 7), (n,)))


def _anchor_targets(setup):
    cfg_j, cfg, gt, anchors, *_ = setup
    h, w = cfg.data.image_h, cfg.data.image_w
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    theirs = jax.vmap(lambda g, k: j_targets.anchor_targets(
        jnp.asarray(anchors.numpy()), g, cfg_j.rpn, h, w, k,
        off=cfg_j.box_off))(jax.tree.map(jnp.asarray, gt), keys)
    a = anchors.shape[0]
    u = [key_uniforms(k, a) for k in keys]
    ours = t_targets.anchor_targets(
        anchors, t_targets.ground_truth_to_torch(gt, "cpu"), cfg.rpn, h, w,
        _t([x[0] for x in u]), _t([x[1] for x in u]), cfg.box_off)
    return ours, theirs


def _proposal_targets(setup):
    cfg_j, cfg, gt, _, pl, pr, pv = setup
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    theirs = jax.vmap(lambda a, b, c, g, k: j_targets.proposal_targets(
        a, b, c, g, cfg_j.rcnn, k, off=cfg_j.box_off))(
        pl, pr, pv, jax.tree.map(jnp.asarray, gt), keys)
    n = N_PROP + gt.left.shape[1]
    u = [key_uniforms(k, n) for k in keys]
    ours = t_targets.proposal_targets(
        _t(pl), _t(pr), _t(pv), t_targets.ground_truth_to_torch(gt, "cpu"),
        cfg.rcnn, *[_t([x[i] for x in u]) for i in range(3)], cfg.box_off)
    return ours, theirs


def test_anchor_targets_match_jax(setup):
    ours, theirs = _anchor_targets(setup)
    for name in ("labels", "weights", "num_fg", "num_sampled"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    labels = ours.labels.numpy()
    assert (labels == 1).any() and (labels == 0).any() and (labels == -1).any()
    fg = labels == 1
    np.testing.assert_allclose(ours.box_targets.numpy()[fg],
                               np.asarray(theirs.box_targets)[fg],
                               rtol=1e-5, atol=1e-5)


def test_proposal_targets_match_jax(setup):
    ours, theirs = _proposal_targets(setup)
    for name in ("rois_left", "rois_right", "cls", "weights", "kpt_bin",
                 "kpt_weight", "border_bins", "border_weight", "num_fg"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    for name in ("box_targets", "dim_targets", "orien_targets"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(theirs, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert (ours.cls.numpy() > 0).any()
    # Unsampled slots hold zero-area padded GT rows.
    rois = ours.rois_left.numpy()
    empty = (rois[..., 2] <= rois[..., 0]) | (rois[..., 3] <= rois[..., 1])
    assert empty.any() and not ours.weights.numpy()[empty].any()


def _random_outputs(s, k, g, seed):
    rng = np.random.RandomState(seed)
    shapes = {"cls_logits": (B, s, k), "box_deltas": (B, s, k, 6),
              "dims": (B, s, k, 3), "orien": (B, s, k, 2)}
    outs = {n: rng.randn(*sh).astype(np.float32) for n, sh in shapes.items()}
    kpt = rng.randn(B, s, 6, g).astype(np.float32) * 3
    return outs, kpt


def _close(ours, theirs):
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=0, err_msg=k)


def test_rpn_losses_match_jax(setup):
    at, at_j = _anchor_targets(setup)
    a = at.labels.shape[1]
    rng = np.random.RandomState(3)
    logits = rng.randn(B, a, 2).astype(np.float32)
    deltas = rng.randn(B, a, 6).astype(np.float32) * 0.3
    theirs = jax.vmap(j_losses.rpn_losses)(logits, deltas, at_j)
    ours = t_losses.rpn_losses(_t(logits), _t(deltas), at)
    _close(ours, theirs)


@pytest.mark.parametrize("kpt_softmax", ["joint", "per_channel"])
def test_rcnn_losses_match_jax(setup, kpt_softmax):
    cfg = setup[1]
    rt, rt_j = _proposal_targets(setup)
    s = cfg.rcnn.rois_per_image
    outs, kpt = _random_outputs(s, cfg.rcnn.num_classes, cfg.rcnn.kpt_grid,
                                4)
    theirs = jax.vmap(functools.partial(
        j_losses.rcnn_losses, kpt_softmax=kpt_softmax))(
        JOutputs(**outs), kpt, rt_j)
    ours = t_losses.rcnn_losses(
        RCNNOutputs(**{n: _t(v) for n, v in outs.items()}), _t(kpt), rt,
        kpt_softmax)
    _close(ours, theirs)
    uncert = np.random.RandomState(5).randn(6).astype(np.float32)
    means = {k: np.asarray(v).mean() for k, v in theirs.items()}
    means.update({"rpn_cls": np.float32(0.7), "rpn_box": np.float32(0.2)})
    np.testing.assert_allclose(
        float(t_losses.combine_with_uncertainty(
            {k: torch.tensor(v) for k, v in means.items()}, _t(uncert))),
        float(j_losses.combine_with_uncertainty(
            {k: jnp.asarray(v) for k, v in means.items()},
            jnp.asarray(uncert))), rtol=1e-6)
