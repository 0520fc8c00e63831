"""The port's training step against ``stereo_rcnn_tpu.train``, on the CPU.

One JAX training state (tiny config, float32, the fused RoIAlign: Pallas
interpret mode for K1 and its backward K2) drives both packages through
``convert.from_jax``; both take one step on the same rendered batch, and
the port replays the uniforms ``jax.random`` draws for target sampling
(``compute_losses`` splits its key into 2B keys; each splits into
``(rng_fg, rng_bg)``, and the roi gather also draws from
``fold_in(key, 7)``).

As in ``tests/test_torch_pipeline.py``, the ``rpn_cls`` kernel is scaled
up so objectness saturates (ties broken by index in both packages) and
``rpn_box`` scaled down so deltas are O(0.5): near-equal random scores
would let last-bit rounding reorder the proposal top-k and NMS, which is
not what this checks.

Tolerances: losses, total and grad_norm 1e-4 relative (float32 through a
26-layer trunk in two frameworks); parameter updates (new - old) 2e-3 of
their largest magnitude, since one step's update is a clipped gradient
times the learning rate and carries the gradients' rounding, plus one
unit in the last place of the parameter: ``new = old + update`` rounds
the update to the parameter's float32 grid, and two updates a rounding
apart can land one grid step apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu import train as j_train
from stereo_rcnn_tpu.config import tiny_test_config as j_tiny
from stereo_rcnn_tpu.data.synthetic import synthetic_batch as j_synthetic
from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.convert.from_jax import state_dict_from_jax
from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                         make_optimizer, make_train_step,
                                         param_label)
from stereo_rcnn_tpu_torch.train.losses import LOSS_NAMES
from stereo_rcnn_tpu_torch.train.step import TrainState, trainable_params
from stereo_rcnn_tpu_torch.train.targets import (Uniforms,
                                                 ground_truth_to_torch)
from tests.test_torch_targets import key_uniforms

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RPN_SCALE = 300.0
RPN_BOX_SCALE = 0.01
STEPS_PER_EPOCH = 10


def _cfg(base, norm, remat=False):
    return dataclasses.replace(
        base, compute_dtype="float32",
        backbone=dataclasses.replace(base.backbone, norm=norm, remat=remat),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))


def jax_uniforms(key, b, a, n) -> Uniforms:
    """The draws of ``stereo_rcnn_tpu.train.step.compute_losses``: keys
    0..B-1 for the anchors, B..2B-1 for the rois."""
    keys = jax.random.split(key, 2 * b)
    anchor = [key_uniforms(keys[i], a)[:2] for i in range(b)]
    roi = [key_uniforms(keys[b + i], n) for i in range(b)]
    return Uniforms(*[torch.from_numpy(np.stack([u[j] for u in draws]))
                      for draws, j in ((anchor, 0), (anchor, 1), (roi, 0),
                                       (roi, 1), (roi, 2))])


def _batch_np(cfg_j):
    il, ir, gt, _ = j_synthetic(cfg_j, batch=2, seed=0, n_objects=2)
    return il, ir, gt


def _jax_state(cfg_j):
    state = j_train.init_train_state(cfg_j, jax.random.PRNGKey(0),
                                     steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(np.array, state.params)
    rpn = params["model"]["rpn_head"]
    rpn["rpn_cls"]["kernel"] *= RPN_SCALE
    rpn["rpn_box"]["kernel"] *= RPN_BOX_SCALE
    tx, _ = j_train.make_optimizer(cfg_j, STEPS_PER_EPOCH)
    params_j = jax.tree.map(jnp.asarray, params)
    return params, j_train.TrainState(step=jnp.zeros((), jnp.int32),
                                      params=params_j,
                                      opt_state=tx.init(params_j))


def _one_step(norm):
    """One step of both packages from the same JAX state and batch."""
    cfg_j = _cfg(j_tiny(), norm)
    cfg = _cfg(tiny_test_config(), norm)
    params, state_j = _jax_state(cfg_j)
    il, ir, gt = _batch_np(cfg_j)
    batch_j = j_train.Batch(jnp.asarray(il), jnp.asarray(ir),
                            jax.tree.map(jnp.asarray, gt))
    key = jax.random.PRNGKey(3)
    new_j, metrics_j = jax.jit(j_train.make_train_step(
        cfg_j, STEPS_PER_EPOCH))(state_j, batch_j, key)

    state = init_train_state(cfg, state_dict=state_dict_from_jax(params, cfg),
                             device="cpu")
    before = {k: v.detach().clone()
              for k, v in trainable_params(state).items()}
    h, w = cfg.data.image_h, cfg.data.image_w
    a = generate_anchors(cfg.anchors, h, w, cfg.box_off, "cpu").shape[0]
    n = cfg.rpn.train_post_nms_top_n + cfg.train.max_gt_boxes
    metrics = make_train_step(cfg, STEPS_PER_EPOCH, device="cpu")(
        state, Batch(torch.from_numpy(il), torch.from_numpy(ir),
                     ground_truth_to_torch(gt, "cpu")),
        uniforms=jax_uniforms(key, 2, a, n))
    after_j = state_dict_from_jax(jax.tree.map(np.asarray, new_j.params),
                                  cfg)
    before_j = state_dict_from_jax(params, cfg)
    return dict(cfg=cfg, metrics=metrics, metrics_j=metrics_j,
                state=state, before=before, before_j=before_j,
                after_j=after_j)


@pytest.fixture(scope="module", params=["group", "frozen"])
def one_step(request):
    return _one_step(request.param)


def _check_metrics(one_step):
    m, mj = one_step["metrics"], one_step["metrics_j"]
    assert float(mj["num_fg_rcnn"]) > 0
    for k in (*LOSS_NAMES, "total", "grad_norm", "num_fg_rpn",
              "num_fg_rcnn", "lr"):
        np.testing.assert_allclose(float(m[k]), float(mj[k]), rtol=1e-4,
                                   err_msg=k)
    assert set(m) == set(mj)


def test_train_step_losses_match_jax(one_step):
    _check_metrics(one_step)


def _updates(one_step, name):
    ours = (trainable_params(one_step["state"])[name].detach() -
            one_step["before"][name]).numpy()
    theirs = (one_step["after_j"][name] - one_step["before_j"][name]).numpy()
    return ours, theirs


@pytest.mark.parametrize("name", [
    "rcnn_head.RCNN_fc6.weight",
    "backbone_net.RCNN_layer4.0.conv2.weight",
    "uncert"])
def test_train_step_updates_match_jax(one_step, name):
    """The step's update of the fc6 kernel, a layer4 kernel (reached only
    through the RoIAlign backward) and the uncertainty weights."""
    _check_update(one_step, name)


def _check_update(one_step, name):
    ours, theirs = _updates(one_step, name)
    scale = float(np.abs(theirs).max())
    assert scale > 0.0, name
    ulp = np.spacing(np.abs(one_step["before"][name].numpy()))
    excess = np.abs(ours - theirs) - (2e-3 * scale + ulp)
    assert excess.max() <= 0.0, (name, float(np.abs(ours - theirs).max()),
                                 scale)


def test_train_step_stem_update(one_step):
    """The stem trains under GroupNorm and is frozen under frozen BN, in
    both packages.  Its update agrees to 2e-2 in norm, not 2e-3: float32
    rounding grows on the way down a random-weight trunk (measured: the
    update differs by 4e-4 in norm at layer4, 6e-3 at layer2 and the
    stem), while one GroupNorm alone agrees with flax's to 3e-6."""
    ours, theirs = _updates(one_step, "backbone_net.RCNN_layer0.0.weight")
    if one_step["cfg"].backbone.norm == "frozen":
        assert not ours.any() and not theirs.any()
        return
    assert np.abs(theirs).max() > 0.0
    err = np.linalg.norm(ours - theirs) / np.linalg.norm(theirs)
    assert err < 2e-2, err


def test_affine_step_matches_jax():
    """The "affine" norm (per-channel scale and bias that train, ``bn3``'s
    scale zero at init) takes the same step as in JAX: the metrics, and the
    updates of a zero-initialised ``bn3`` scale, a downsample norm's scale
    (on the identity path, so it has a gradient while the zero ``bn3``
    scales leave every residual branch's inner norms without one) and the
    fc6 kernel, to the tolerances above."""
    step = _one_step("affine")
    _check_metrics(step)
    for name in ("backbone_net.RCNN_layer4.0.bn3.scale",
                 "backbone_net.RCNN_layer2.0.downsample.1.scale",
                 "rcnn_head.RCNN_fc6.weight"):
        _check_update(step, name)
    assert not step["before"]["backbone_net.RCNN_layer4.0.bn3.scale"].any()


def test_param_labels():
    """``test_train_step.py::test_param_labels`` on the port's names."""
    base = tiny_test_config()
    frozen = init_train_state(_cfg(base, "frozen"),
                              torch.Generator().manual_seed(0),
                              device="cpu")
    names = [*frozen.model.state_dict(), "uncert"]
    lab = {n: param_label(n, freeze_stem=True) for n in names}
    assert lab["uncert"] == "uncert"
    bb = "backbone_net"
    assert lab[f"{bb}.RCNN_layer0.0.weight"] == "frozen"             # stem
    assert lab[f"{bb}.RCNN_layer0.1.scale"] == "frozen"
    assert lab[f"{bb}.RCNN_layer1.0.conv1.weight"] == "frozen"
    assert lab[f"{bb}.RCNN_layer2.0.conv1.weight"] == "decay"
    assert lab[f"{bb}.RCNN_layer2.0.bn1.scale"] == "frozen"
    assert lab[f"{bb}.RCNN_layer2.0.downsample.1.bias"] == "frozen"
    assert lab["rcnn_head.RCNN_fc6.weight"] == "decay"
    assert lab["rcnn_head.RCNN_fc6.bias"] == "plain"
    # Frozen norm: exactly the stem and layer1 get no gradient.
    no_grad = {n for n, p in frozen.model.named_parameters()
               if not p.requires_grad}
    assert no_grad == {n for n in dict(frozen.model.named_parameters())
                       if lab[n] == "frozen"}

    group = init_train_state(_cfg(base, "group"),
                             torch.Generator().manual_seed(0), device="cpu")
    gn = {n: param_label(n, freeze_stem=False)
          for n in dict(group.model.named_parameters())}
    gn_keys = [n for n in gn if ".gn." in n]
    assert gn_keys and all(gn[n] == "plain" for n in gn_keys)
    assert gn[f"{bb}.RCNN_layer0.0.weight"] == "decay"
    assert gn[f"{bb}.RCNN_layer1.0.conv1.weight"] == "decay"
    assert all(p.requires_grad for p in group.model.parameters())


def _toy_state(cfg, grads):
    """A state of one 2-parameter linear layer named like fc6, with set
    gradients; the optimizer sees fc6.weight (decay), fc6.bias (plain)
    and uncert."""
    model = torch.nn.Module()
    model.rcnn_head = torch.nn.Module()
    model.rcnn_head.RCNN_fc6 = torch.nn.Linear(2, 1)
    with torch.no_grad():
        model.rcnn_head.RCNN_fc6.weight.copy_(torch.tensor([[1.0, -2.0]]))
        model.rcnn_head.RCNN_fc6.bias.fill_(0.5)
    state = TrainState(step=0, model=model, uncert=torch.zeros(6),
                       trace={})
    params = trainable_params(state)
    for (name, p), g in zip(params.items(), grads):
        p.grad = torch.as_tensor(g, dtype=torch.float32).reshape(p.shape)
    return state, params


@pytest.mark.parametrize("g_scale", [0.5, 1.0, 2.0])
def test_optimizer_clip_at_and_below_max_norm(g_scale):
    """optax clip_by_global_norm: no change below max_norm, scaling by
    max_norm / g_norm at and above it (no epsilon); then decay on the
    kernel only, SGD momentum as optax.trace (the first trace is g)."""
    cfg = _cfg(tiny_test_config(), "group")
    clip = cfg.train.grad_clip
    g = np.array([3.0, 4.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    g = g / np.linalg.norm(g) * clip * g_scale               # norm = s*clip
    state, params = _toy_state(cfg, [g[:2], g[2:3], g[3:]])
    w0 = params["rcnn_head.RCNN_fc6.weight"].detach().clone()
    update, schedule = make_optimizer(cfg, STEPS_PER_EPOCH)
    g_norm = update(params, state.trace, 0)
    np.testing.assert_allclose(float(g_norm), clip * g_scale, rtol=1e-6)
    factor = 1.0 if g_scale < 1.0 else 1.0 / g_scale
    lr = schedule(0)
    g_w = torch.tensor(g[:2], dtype=torch.float32).reshape(1, 2) * factor
    expect = w0 - lr * (g_w + cfg.train.weight_decay * w0)
    np.testing.assert_allclose(params["rcnn_head.RCNN_fc6.weight"].detach(),
                               expect, rtol=1e-6)
    # The bias (plain) has a zero gradient and no decay: unchanged.
    assert float(params["rcnn_head.RCNN_fc6.bias"].detach()) == 0.5
    # Second update with zero gradients: momentum carries 0.9 of the trace.
    w1 = params["rcnn_head.RCNN_fc6.weight"].detach().clone()
    m1 = state.trace["rcnn_head.RCNN_fc6.weight"].clone()
    for p in params.values():
        p.grad = torch.zeros_like(p)
    update(params, state.trace, 1)
    np.testing.assert_allclose(
        state.trace["rcnn_head.RCNN_fc6.weight"],
        cfg.train.momentum * m1 + cfg.train.weight_decay * w1, rtol=1e-6)


def test_optimizer_lr_boundary_step():
    """The step schedule decays once count >= lr_decay_step * steps."""
    cfg = _cfg(tiny_test_config(), "group")
    _, schedule = make_optimizer(cfg, STEPS_PER_EPOCH)
    boundary = cfg.train.lr_decay_step * STEPS_PER_EPOCH
    lr = np.float32(cfg.train.learning_rate)
    assert schedule(0) == schedule(boundary - 1) == lr
    decayed = np.float32(lr * np.float32(cfg.train.lr_decay_gamma))
    assert schedule(boundary) == schedule(boundary + 5) == decayed
    j_sched = j_train.make_optimizer(j_tiny(), STEPS_PER_EPOCH)[1]
    for count in (0, boundary - 1, boundary, boundary + 1):
        assert schedule(count) == float(j_sched(count))


def test_remat_gives_the_same_step():
    """``backbone.remat`` recomputes bottlenecks in the backward pass and
    changes nothing else: the same losses and updates to 1e-6."""
    base = tiny_test_config()
    il, ir, gt = _batch_np(_cfg(j_tiny(), "group"))
    results = []
    for remat in (False, True):
        cfg = _cfg(base, "group", remat)
        state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        batch = Batch(torch.from_numpy(il), torch.from_numpy(ir),
                      ground_truth_to_torch(gt, "cpu"))
        m = make_train_step(cfg, STEPS_PER_EPOCH, device="cpu")(
            state, batch, torch.Generator().manual_seed(1))
        results.append((m, trainable_params(state)))
    (m0, p0), (m1, p1) = results
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6,
                                   err_msg=k)
    for k in ("backbone_net.RCNN_layer4.0.conv2.weight",
              "backbone_net.RCNN_layer0.1.gn.weight"):
        np.testing.assert_allclose(p1[k].detach(), p0[k].detach(),
                                   rtol=0, atol=1e-6, err_msg=k)
